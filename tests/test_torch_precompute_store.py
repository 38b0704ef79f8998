"""The port's store of the 'all' precompute (novic_tpu_torch.models.precompute_store)
against novic_tpu.models.precompute_store.

The cases of tests/test_precompute_store.py on the port (round trip, key
sensitivity, a miss and a corrupted file, concurrent writers), then the two
packages together: the same key for the same inputs, and a file saved by either
package loads in the other, array for array. Last, NOVICModel(precompute_dir=...)
serves an 'all' gencfg from disk, as tests/test_infer.py's JAX test does.
"""

import os
import threading

import numpy as np
import pytest

import novic_tpu.models.precompute_store as jax_store
from novic_tpu.models.generate import precompute_generate_all as jax_precompute
from novic_tpu_torch import infer
from novic_tpu_torch.models import precompute_store as store
from novic_tpu_torch.models.generate import precompute_generate_all
from novic_tpu_torch.train.checkpoint import load_checkpoint

V = 50
FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")
ARRAYS = ("guide_targets", "guide_paddings", "guide_nodes", "vocab_scores", "alpha_scale")
TABLES = ("child_tok", "child_id", "child_cnt", "node_cnt")


def _targets(rng, w=40, c=5):
    gt = rng.integers(1, V, size=(w, c)).astype(np.int32)
    # Random lengths with trailing zero padding (end token = 0)
    lengths = rng.integers(1, c + 1, size=w)
    for i, n in enumerate(lengths):
        gt[i, n - 1:] = 0
    return gt


def _kwargs(rng, renorm=True, vocab=True, alpha=0.5):
    return dict(length_alpha=alpha, vocab_targets=_targets(rng, w=60) if vocab else None,
                vocab_per_token=False, vocab_scaler=0.4 if vocab else 0.0,
                guide_targets=_targets(rng), guide_renorm=renorm)


def _key(kwargs):
    return store.precompute_cache_key(V, **kwargs)


def _guide_nouns():
    ck = load_checkpoint(FT0)
    return list(ck["target_nouns"][ck["num_invalid_target_nouns"]:][::1000])


def _assert_pre_equal(a, b):
    for name in ARRAYS:
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb)
    assert (a.renorm_trie is None) == (b.renorm_trie is None)
    if a.renorm_trie is not None:
        for table in TABLES:
            for ta, tb in zip(a.renorm_trie[table], b.renorm_trie[table], strict=True):
                np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("renorm,vocab,alpha", [(True, True, 0.5), (False, False, 0.0),
                                                (True, False, 0.0), (False, True, 1.0)])
def test_precompute_store_roundtrip(tmp_path, renorm, vocab, alpha):
    kwargs = _kwargs(np.random.default_rng(0), renorm, vocab, alpha)
    pre = precompute_generate_all(V, **kwargs)
    key = _key(kwargs)
    path = store.save_precompute(str(tmp_path), key, pre)
    assert os.path.isfile(path) and os.path.basename(path) == f"all_precompute_{key}.npz"
    loaded = store.load_precompute(str(tmp_path), key)
    assert loaded is not None
    _assert_pre_equal(pre, loaded)


def test_precompute_key_sensitivity():
    rng = np.random.default_rng(1)
    gt, vt = _targets(rng), _targets(rng, w=30)
    base = dict(length_alpha=0.5, vocab_per_token=False, vocab_scaler=0.4,
                guide_renorm=True, guide_targets=gt, vocab_targets=vt)
    k0 = store.precompute_cache_key(V, **base)
    assert k0 == store.precompute_cache_key(V, **base)  # deterministic
    variants = [dict(base, length_alpha=0.6), dict(base, vocab_per_token=True),
                dict(base, vocab_scaler=0.5), dict(base, guide_renorm=False),
                dict(base, guide_targets=np.ascontiguousarray(gt[::-1])),
                dict(base, vocab_targets=None)]
    keys = [store.precompute_cache_key(V, **v) for v in variants]
    assert len({k0, *keys}) == len(keys) + 1  # all distinct
    assert store.precompute_cache_key(V + 1, **base) != k0


def test_precompute_store_miss_and_corruption(tmp_path):
    kwargs = _kwargs(np.random.default_rng(2), vocab=False, alpha=0.0)
    key = _key(kwargs)
    assert store.load_precompute(str(tmp_path), key) is None  # cold miss
    path = store.save_precompute(str(tmp_path), key, precompute_generate_all(V, **kwargs))
    # A truncated file loads as a miss (with a warning), it does not raise
    with open(path, "r+b") as f:
        f.truncate(100)
    assert store.load_precompute(str(tmp_path), key) is None
    # A file under another key's name is refused as well
    other = "0" * 32
    os.replace(path, os.path.join(tmp_path, f"all_precompute_{other}.npz"))
    store.save_precompute(str(tmp_path), key, precompute_generate_all(V, **kwargs))
    os.replace(os.path.join(tmp_path, f"all_precompute_{key}.npz"),
               os.path.join(tmp_path, f"all_precompute_{other}.npz"))
    assert store.load_precompute(str(tmp_path), other) is None
    assert all(".tmp." not in n for n in os.listdir(tmp_path))


def test_concurrent_writers_last_commit_wins(tmp_path):
    """Writers racing on one key never leave a torn file: each commits through
    its own temporary file, so a reader sees one complete artifact or none."""
    kwargs = _kwargs(np.random.default_rng(5), vocab=False, alpha=0.0)
    pre = precompute_generate_all(V, **kwargs)
    key = _key(kwargs)
    errs = []

    def writer():
        try:
            for _ in range(5):
                store.save_precompute(str(tmp_path), key, pre)
        except Exception as e:  # noqa: BLE001 -- reported below
            errs.append(e)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    for _ in range(10):
        loaded = store.load_precompute(str(tmp_path), key)
        assert loaded is None or loaded.guide_targets.shape == pre.guide_targets.shape
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    final = store.load_precompute(str(tmp_path), key)
    assert final is not None
    _assert_pre_equal(pre, final)
    assert all(".tmp." not in n for n in os.listdir(tmp_path))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("renorm,vocab,alpha", [(True, True, 0.5), (False, False, 0.0)])
def test_store_files_cross_packages(tmp_path, writer, renorm, vocab, alpha):
    """Both packages give the same key for the same inputs, and a file saved by
    either loads in the other as the precompute the reader computes itself."""
    kwargs = _kwargs(np.random.default_rng(7), renorm, vocab, alpha)
    key = _key(kwargs)
    assert key == jax_store.precompute_cache_key(V, **kwargs)
    pre, jpre = precompute_generate_all(V, **kwargs), jax_precompute(V, **kwargs)
    if writer == "jax":
        jax_store.save_precompute(str(tmp_path), key, jpre)
        loaded, want = store.load_precompute(str(tmp_path), key), pre
    else:
        store.save_precompute(str(tmp_path), key, pre)
        loaded, want = jax_store.load_precompute(str(tmp_path), key), jpre
    assert loaded is not None
    _assert_pre_equal(want, loaded)


def test_precompute_dir_serves_from_disk(tmp_path, monkeypatch):
    """With precompute_dir set, the first 'all' decode stores its precompute and
    a fresh model serves it from disk (recomputing is a trap here), with the same
    outputs; a corrupted file is recomputed."""
    prestore = str(tmp_path / "prestore")
    gencfg = "all_k3_vtgt0.5_gr_t1_a0.5"
    emb = np.random.default_rng(4).normal(size=(3, 768)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    common = dict(embedder_spec="test:768", gencfg=gencfg, batch_size=3, device="cpu",
                  guide_targets=_guide_nouns(), precompute_dir=prestore)
    with infer.NOVICModel(FT0, **common) as model:
        out1 = model.classify_embeds(emb)
    files = os.listdir(prestore)
    assert len(files) == 1 and files[0].startswith("all_precompute_")

    def trap(*args, **kwargs):
        raise AssertionError("precompute recomputed despite a store hit")

    monkeypatch.setattr(infer, "precompute_generate_all", trap)
    with infer.NOVICModel(FT0, **common) as model:
        out2 = model.classify_embeds(emb)
    assert out1.preds == out2.preds
    np.testing.assert_allclose(out1.logprobs, out2.logprobs, rtol=1e-6, atol=1e-6)

    monkeypatch.undo()
    with open(os.path.join(prestore, files[0]), "r+b") as f:
        f.truncate(64)
    with infer.NOVICModel(FT0, **common) as model:
        out3 = model.classify_embeds(emb)
    assert out1.preds == out3.preds
