"""Cache-creation actions and built-in test actions.

Parity with the reference actions (reference train.py): cache_noun_dataset /
convert_noun_dataset :781-812, cache_noun_multiset :815-838, cache_captions
:841-866, cache_cls :869-896, cache_images :899-907, merge_caches :910-920,
test_data_loader :343-486, test_embed_cache :493-667.

The port's counterparts of novic_tpu.cli.actions_cache: the same files for
the same inputs and seed. Every action takes `device` (default cuda, which
raises where CUDA is missing); the embedder's towers run there.
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np

from novic_tpu_torch.cli.common import (
    gen_data_config,
    gen_target_config,
    load_embedder,
    load_embedding_dataset,
    load_noun_dataset,
    resolve_cache_path,
    resolve_path,
    save_cache_path,
)
from novic_tpu_torch.cli.actions_eval import align_cls_class_targets
from novic_tpu_torch.data.cache import CacheExpectation, EmbeddingCache
from novic_tpu_torch.data.cache_writers import (
    CaptionsCacheWriter,
    ClassificationCacheWriter,
    ImageCacheWriter,
    IndexCacheWriter,
    MergeCachesWriter,
    NounDatasetCacheWriter,
    NounMultisetCacheWriter,
    PhotoCacheWriter,
    RandomCacheWriter,
    TestMultiCacheWriter,
)
from novic_tpu_torch.data.classification import ClassificationLoader, load_image_dataset
from novic_tpu_torch.data.grad_accum import GradAccum
from novic_tpu_torch.device import resolve
from novic_tpu_torch.utils.logger import log


def _cache_expectation(embedder):
    return CacheExpectation(embed_dim=embedder.embed_dim, embed_dtype=np.float32,
                            embedder_hash=embedder.get_configuration_hash(True, False),
                            target_config=embedder.target_config)


def action_cache_noun_dataset(cfg, device="cuda"):
    """Ensure the noun dataset's OWN cache exists and passes its sanity check
    (ref train.py:781-793: use_cache=True + enter loaded(); no embedding-cache
    file is written — that is convert_noun_dataset's job)."""
    embedder = load_embedder(cfg, load_model=False, device=resolve(device))
    dataset = load_noun_dataset(cfg, embedder, use_cache=True)
    gen_target_config(cfg, embedder, dataset.targets)
    with dataset.loaded():
        # Entering loaded() is the whole job: it builds (or re-reads) the noun
        # cache file and runs its consistency check; nothing to iterate.
        pass
    log.info("Noun dataset cache is now up to date")


def action_convert_noun_dataset(cfg, device="cuda"):
    """Noun dataset → FSID-expanded embedding cache (ref train.py:798-812)."""
    embedder = load_embedder(cfg, load_model=False, device=resolve(device))
    dataset = load_noun_dataset(cfg, embedder, use_cache=False)
    gen_target_config(cfg, embedder, dataset.targets)
    NounDatasetCacheWriter(save_cache_path(cfg), dataset, seed=cfg.seed).generate()


def action_cache_noun_multiset(cfg, device="cuda"):
    """Multiset cache (ref train.py:815-838)."""
    embedder = load_embedder(cfg, load_model=False, device=resolve(device))
    dataset = load_noun_dataset(cfg, embedder, use_cache=False)
    gen_target_config(cfg, embedder, dataset.targets)
    NounMultisetCacheWriter(save_cache_path(cfg), dataset,
                            multi_target_freq=cfg.multi_target_freq, seed=cfg.seed).generate()


def action_cache_captions(cfg, device="cuda"):
    """Captions JSON → cache (ref train.py:841-866)."""
    embedder = load_embedder(cfg, load_model=False, device=resolve(device))
    dataset = load_noun_dataset(cfg, embedder, use_cache=False)
    gen_target_config(cfg, embedder, dataset.targets)
    CaptionsCacheWriter(save_cache_path(cfg), resolve_path(cfg, cfg.captions_path), dataset,
                        template_multiplier=cfg.template_multiplier,
                        sample_multiplier=cfg.sample_multiplier,
                        print_approx=cfg.captions_print, seed=cfg.seed).generate()


def action_cache_cls(cfg, device="cuda"):
    """Image classification dataset → image-embedding cache (ref train.py:869-896)."""
    embedder = load_embedder(cfg, load_model=True, device=resolve(device))
    ds = load_image_dataset(cfg.cls_dataset, resolve_path(cfg, cfg.cls_dataset_root),
                            split=cfg.cls_split, variant=cfg.class_names_variant, clean=True)
    # Align class names to vocab nouns via canonical forms
    dataset = load_noun_dataset(cfg, embedder, use_cache=False)
    gen_target_config(cfg, embedder, dataset.targets)
    class_targets = align_cls_class_targets(ds.classes, dataset.targets)
    loader = ClassificationLoader(ds, batch_size=cfg.batch_size_image,
                                  transform=embedder.get_image_transform(), seed=cfg.seed)
    ClassificationCacheWriter(save_cache_path(cfg), embedder, loader, len(ds),
                              targets=dataset.targets, class_targets=class_targets,
                              seed=cfg.seed).generate()


def action_cache_images(cfg, device="cuda"):
    """Directory of images → targetless cache (ref train.py:899-907)."""
    embedder = load_embedder(cfg, load_model=True, device=resolve(device))
    images = [resolve_path(cfg, p) for p in cfg.images]
    ImageCacheWriter(save_cache_path(cfg), embedder, images, seed=cfg.seed).generate()


def action_merge_caches(cfg, device="cuda"):
    """Shuffle-merge caches (ref train.py:910-920)."""
    embedder = load_embedder(cfg, load_model=False, device=resolve(device))
    paths = [resolve_cache_path(cfg, p) for p in cfg.embedding_datasets]
    if not paths:
        raise ValueError("merge_caches requires embedding_datasets to be specified")
    caches = [EmbeddingCache(p, strict_embedder=False) for p in paths]
    if caches[0].use_targets:
        gen_target_config(cfg, embedder, caches[0].target_nouns[1:])
    freqs = cfg.merge_freqs or None
    MergeCachesWriter(save_cache_path(cfg), embedder, caches, freqs=freqs,
                      use_targets=cfg.save_targets, multi_mode=cfg.multi_mode,
                      seed=cfg.seed).generate()


# ---------------------------------------------------------------------------
# Test actions (ref train.py:343-667)
# ---------------------------------------------------------------------------


def action_test_data_loader(cfg, device="cuda"):
    """Exhaustive assertion test of dataset/loader/GradAccum invariants
    (ref train.py:343-486)."""
    embedder = load_embedder(cfg, load_model=False, device=resolve(device))
    dataset = load_embedding_dataset(cfg, embedder, training=cfg.test_training)
    dc = gen_data_config(cfg, dataset)
    loader, info = dataset.create_loader(batch_size=cfg.batch_size, training=cfg.test_training,
                                         seed=cfg.seed)
    grad_accum = GradAccum(loader, info, accum_size=cfg.accum_factor, drop_last=False)

    assert info.epoch_batches == len(loader)
    assert info.epoch_samples == info.complete_batches * info.batch_size + \
        (info.batch_size_last if info.incomplete_batch else 0)

    total_samples = 0
    total_batches = 0
    accum_total = 0.0
    F = embedder.embed_dim
    with dataset.loaded():
        for batch in grad_accum.loader():
            embed, target, mask, weight = batch
            B = embed.shape[0]
            assert embed.ndim == 2 and embed.shape[1] == F, f"Bad embed shape {embed.shape}"
            norms = np.linalg.norm(np.asarray(embed, np.float32), axis=1)
            assert np.allclose(norms, 1.0, atol=1e-3), "Embeddings must be unit vectors"
            if dataset.use_targets:
                assert target is not None
                if dc.multi_target:
                    expect_ndim = 3
                    batch_axis = 1 if dc.multi_first else 0
                    assert target.ndim == expect_ndim
                    assert target.shape[batch_axis] == B
                else:
                    assert target.ndim == 2 and target.shape[0] == B
                if mask is not None:
                    assert mask.shape == target.shape
                if dc.use_weights:
                    assert weight is not None
                    if dc.unit_weights:
                        axis = 0 if dc.multi_first else (1 if weight.ndim > 1 else None)
                        if weight.ndim > 1:
                            sums = weight.sum(axis=axis)
                            assert np.allclose(sums, 1.0, atol=1e-3)
                else:
                    assert weight is None
            scaled, do_step = grad_accum.accum_loss(1.0, B)
            accum_total += scaled
            total_samples += B
            total_batches += 1
            if cfg.test_print:
                log.info(f"Batch {total_batches}: B={B} target="
                         f"{None if target is None else target.shape}")
    assert total_batches == grad_accum.loader_batches, \
        f"Iterated {total_batches} batches, expected {grad_accum.loader_batches}"
    assert total_samples == grad_accum.loader_samples
    expected_accum = grad_accum.complete_steps + int(grad_accum.incomplete_step)
    assert math.isclose(accum_total, expected_accum, rel_tol=1e-9), \
        f"Accumulated loss {accum_total} != {expected_accum}"
    log.info(f"test_data_loader PASSED: {total_batches} batches, {total_samples} samples, "
             f"accumulated loss scaling exact")


def action_test_embed_cache(cfg, device="cuda"):
    """Round-trip tests of 4 fake cache writer types (ref train.py:493-667)."""
    embedder = load_embedder(cfg, load_model=False, device=resolve(device))
    nouns = ["dog", "cat", "fire truck", "sea lion", "tree", "apple", "car", "hot dog"]
    gen_target_config(cfg, embedder, nouns)
    tmpdir = tempfile.mkdtemp(prefix="novic_test_cache_")
    exp = _cache_expectation(embedder)

    # 1. RandomCacheWriter: targetless round trip
    p = os.path.join(tmpdir, "random.bin")
    RandomCacheWriter(p, embedder, num_embed=100, seed=cfg.seed).generate()
    with EmbeddingCache(p, strict_embedder=False) as cache:
        e, *_ = cache.get_samples(0, 100)
        assert e.shape == (100, embedder.embed_dim)
        assert np.allclose(np.linalg.norm(np.asarray(e), axis=1), 1.0, atol=1e-3)

    # 2. PhotoCacheWriter: exact content equality (sorted, shuffled on disk)
    p = os.path.join(tmpdir, "photo.bin")
    all_embeds, token_ids, mask = PhotoCacheWriter(p, embedder, nouns, debug=True,
                                                   seed=cfg.seed).generate()
    with EmbeddingCache(p, exp) as cache:
        e, tids, *_ = cache.get_samples(0, len(nouns))
        order = np.argsort(np.asarray(tids)[:, 0])
        assert np.allclose(np.asarray(e)[order], all_embeds, atol=1e-5)
        assert np.array_equal(np.asarray(cache.target_token_ids)[1:], token_ids)

    # 3. IndexCacheWriter: eval ordering preserved (unshuffled)
    p = os.path.join(tmpdir, "index.bin")
    IndexCacheWriter(p, embedder, nouns, seed=cfg.seed).generate()
    with EmbeddingCache(p, exp) as cache:
        ds = cache.create_dataset(batch_size=3, training=False)
        ds.configure_data(ds.resolve_data_config(multi_target=False))
        loader, info = ds.create_loader(batch_size=3, training=False)
        seen = []
        for embed, target, m, w in loader:
            seen.extend(embedder.detokenize_target(target))
        assert seen == nouns, f"Eval order not preserved: {seen}"
        # Train-mode epoch offsets cover all samples across epochs
        ds_t = cache.create_dataset(batch_size=4, training=True)
        ds_t.configure_data(ds_t.resolve_data_config(multi_target=False))
        loader_t, _ = ds_t.create_loader(batch_size=4, training=True, seed=cfg.seed)
        starts = set()
        for _ in range(6):
            batch_nouns = []
            for embed, target, m, w in loader_t:
                batch_nouns.extend(embedder.detokenize_target(target))
            starts.add(tuple(batch_nouns[:1]))
        assert len(starts) > 1, "Per-epoch circular offset never changed the batch order"

    # 4. TestMultiCacheWriter: multi-target invariants through the Dataset
    p = os.path.join(tmpdir, "multi.bin")
    TestMultiCacheWriter(p, embedder, num_embed=64, target_nouns=nouns,
                         num_embed_targets=3, seed=cfg.seed).generate()
    with EmbeddingCache(p, exp) as cache:
        ds = cache.create_dataset(batch_size=16, training=False)
        ds.configure_data(ds.resolve_data_config(multi_target=True, use_weights=True,
                                                 unit_weights=True, full_targets=False))
        loader, _ = ds.create_loader(batch_size=16, training=False)
        for embed, target, mask, weight in loader:
            assert target.ndim == 3 and weight is not None
            assert np.allclose(weight.sum(axis=1), 1.0, atol=1e-3)
            if cfg.test_print:
                log.info(f"multi batch: target {target.shape} weight {weight.shape}")
    log.info("test_embed_cache PASSED: random/photo/index/multi round trips OK")
