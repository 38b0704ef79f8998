"""Concrete embedding-cache writers (capability parity with reference
embedding_cache_writers.py — all 10 writers).

| Writer                   | Produces                                             | ref     |
|--------------------------|------------------------------------------------------|---------|
| RandomCacheWriter        | N random unit vectors, no targets (tests)            | :23-47  |
| PhotoCacheWriter         | one 'a photo of a {noun}' embedding per target noun  | :50-103 |
| IndexCacheWriter         | random embeds, identity targets, unshuffled          | :106-142|
| TestMultiCacheWriter     | random multi-target data w/ random padding/weights   | :145-196|
| NounDatasetCacheWriter   | full noun dataset, FSID-frequency expanded, shuffled | :199-243|
| NounMultisetCacheWriter  | m-noun 'and'-joined multiset texts, m targets        | :246-356|
| CaptionsCacheWriter      | LLM captions JSON → cache with multiplier cycling    | :359-546|
| ClassificationCacheWriter| image cls dataset → image-embedding cache w/ targets | :549-586|
| ImageCacheWriter         | directory of images → targetless embedding cache     | :589-637|
| MergeCachesWriter        | shuffle-merge k caches with repeat frequencies       | :640-753|

The port's copy of novic_tpu.data.cache_writers: the same seeded shuffles and
draws, hence byte-identical files wherever the embeddings are identical. The
embedder's towers run on its device (the card by default).
"""

from __future__ import annotations

import collections
import fnmatch
import itertools
import json
import os
import random
from typing import Iterable, Optional, Sequence, Union

import numpy as np

from novic_tpu_torch.data.cache import EmbeddingCache, EmbeddingCacheWriter
from novic_tpu_torch.data.noun_dataset import NounDataset
from novic_tpu_torch.utils.logger import log
from novic_tpu_torch.utils.misc import make_indefinite

IMAGE_PATTERNS = ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.gif", "*.webp", "*.tiff")


def _unit_randn(rng: np.random.Generator, shape) -> np.ndarray:
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class RandomCacheWriter(EmbeddingCacheWriter):
    """Random unit vectors, no targets (ref :23-47)."""

    def __init__(self, cache_path: str, embedder, num_embed: int, batch_size: int = 2048,
                 seed: Optional[int] = None):
        self.embedder = embedder
        self.gen_batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        super().__init__(cache_path, num_embed=num_embed, embed_dim=embedder.embed_dim,
                         shuffle=False, use_targets=False, embedder_strict=False, seed=seed)

    def generate(self):
        with self:
            num_left = self.header.embed_num
            while num_left > 0:
                n = min(self.gen_batch_size, num_left)
                self.write(_unit_randn(self.rng, (n, self.header.embed_dim)))
                num_left -= n


class PhotoCacheWriter(EmbeddingCacheWriter):
    """One 'a photo of a {noun}' embedding per target noun; returns debug
    tensors for test round-trips (ref :50-103)."""

    def __init__(self, cache_path: str, embedder, target_nouns: Sequence[str],
                 debug: bool = False, seed: Optional[int] = None):
        self.embedder = embedder
        self.debug = debug
        super().__init__(cache_path, num_embed=len(target_nouns), embed_dim=embedder.embed_dim,
                         target_tokenizer=embedder.target_tokenizer, target_nouns=target_nouns,
                         num_embed_targets=1, shuffle=True, use_targets=True, full_targets=True,
                         default_weights=True, unit_weights=True,
                         embedder_hash=embedder.get_configuration_hash(True, False), seed=seed)

    def generate(self):
        with self.embedder.inference_model(), self:
            all_embeds = (np.full((self.num_embed, self.embedder.embed_dim), np.nan, np.float32)
                          if self.debug else None)
            all_targets = np.arange(1, self.num_target_nouns,
                                    dtype=self.embed_targets_dtype)[:, None]
            count = 0
            it = iter(self.target_nouns[1:])
            bs = self.embedder.inference_batch_size
            while nouns := tuple(itertools.islice(it, bs)):
                texts = tuple(f"a photo of a {n}" for n in nouns)
                embeds = self.embedder.inference_text(texts)
                new_count = count + len(nouns)
                if all_embeds is not None:
                    all_embeds[count:new_count] = embeds
                self.write(embeds, all_targets[count:new_count])
                count = new_count
            if self.debug:
                assert count == self.num_embed and not np.isnan(all_embeds).any()
                mask = self._target_mask[1:] if self.embedder.target_config.use_masks else None
                return all_embeds, self._target_token_ids[1:], mask
        return None


class IndexCacheWriter(EmbeddingCacheWriter):
    """Random embeds + identity targets, UNSHUFFLED (index tests, ref :106-142)."""

    def __init__(self, cache_path: str, embedder, target_nouns: Sequence[str],
                 seed: Optional[int] = None):
        self.embedder = embedder
        self.rng = np.random.default_rng(seed)
        super().__init__(cache_path, num_embed=len(target_nouns), embed_dim=embedder.embed_dim,
                         target_tokenizer=embedder.target_tokenizer, target_nouns=target_nouns,
                         num_embed_targets=1, shuffle=False, use_targets=True, full_targets=True,
                         default_weights=True, unit_weights=True,
                         embedder_hash=embedder.get_configuration_hash(True, False))

    def generate(self):
        with self:
            all_targets = np.arange(1, self.num_target_nouns,
                                    dtype=self.embed_targets_dtype)[:, None]
            count = 0
            while count < self.num_embed:
                n = min(1024, self.num_embed - count)
                self.write(_unit_randn(self.rng, (n, self.header.embed_dim)),
                           all_targets[count:count + n])
                count += n


class TestMultiCacheWriter(EmbeddingCacheWriter):
    """Random multi-target data with random padding/weights (ref :145-196)."""

    __test__ = False  # not a pytest class

    def __init__(self, cache_path: str, embedder, num_embed: int, target_nouns: Sequence[str],
                 num_embed_targets: int, batch_size: int = 2048, seed: Optional[int] = None):
        self.embedder = embedder
        self.gen_batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        super().__init__(cache_path, num_embed=num_embed, embed_dim=embedder.embed_dim,
                         target_tokenizer=embedder.target_tokenizer, target_nouns=target_nouns,
                         num_embed_targets=num_embed_targets, shuffle=False, use_targets=True,
                         full_targets=False, default_weights=False, unit_weights=False,
                         embedder_hash=embedder.get_configuration_hash(True, False))

    def generate(self):
        with self:
            M = self.header.embed_targets_dim
            range_arr = np.arange(M, 0, -1)
            num_left = self.header.embed_num
            while num_left > 0:
                n = min(self.gen_batch_size, num_left)
                embeds = _unit_randn(self.rng, (n, self.header.embed_dim))
                targets = self.rng.integers(1, self.num_target_nouns, size=(n, M)
                                            ).astype(self.embed_targets_dtype)
                num_padded = self.rng.integers(0, M, size=(n, 1))
                targets *= (num_padded < range_arr)
                weights = -np.sort(-self.rng.random((n, M)).astype(np.float32), axis=1)
                extra_zero = (num_padded + (self.rng.integers(0, 4, size=(n, 1)) == 0)
                              ).clip(max=M - 1)
                weights *= (extra_zero < range_arr)
                self.write(embeds, targets, weights)
                num_left -= n


class NounDatasetCacheWriter(EmbeddingCacheWriter):
    """Full noun dataset → cache: each unique sample written freq times
    (FSID expansion), globally shuffled (ref :199-243)."""

    def __init__(self, cache_path: str, dataset: NounDataset, seed: Optional[int] = None):
        self.dataset = dataset
        self.embedder = dataset.embedder
        super().__init__(cache_path, num_embed=dataset.num_fsids,
                         embed_dim=self.embedder.embed_dim,
                         target_tokenizer=self.embedder.target_tokenizer,
                         target_nouns=dataset.targets, num_embed_targets=1, shuffle=True,
                         use_targets=True, full_targets=True, default_weights=True,
                         unit_weights=True,
                         embedder_hash=self.embedder.get_configuration_hash(True, False),
                         seed=seed)

    def generate(self):
        log.info(f"Converting noun dataset ({self.num_embed} embeddings) to a cache file...")
        with self.embedder.inference_model(), self:
            total_usids = total_fsids = 0
            it = iter(self.dataset.unique_sample())
            bs = self.embedder.inference_batch_size
            while samples := tuple(itertools.islice(it, bs)):
                embeds = self.embedder.inference_text([s.text for s in samples])
                targets = self.tensorize_embed_targets([s.target for s in samples])
                for embed, target, s in zip(embeds, targets, samples):
                    self.write(np.broadcast_to(embed, (s.freq, embed.shape[0])),
                               np.broadcast_to(target, (s.freq, 1)))
                total_usids += len(samples)
                total_fsids += sum(s.freq for s in samples)
            assert total_usids == self.dataset.num_usids and total_fsids == self.dataset.num_fsids


class NounMultisetCacheWriter(EmbeddingCacheWriter):
    """Multiset data: for multiplicity m, texts '...{noun1} and {noun2}...'
    with m independent frequency-weighted noun draws, m targets each 1/m
    weight; the m=1 stream is verified to equal the plain dataset
    (ref :246-356)."""

    def __init__(self, cache_path: str, dataset: NounDataset,
                 multi_target_freq: Sequence[int], seed: Optional[int] = None):
        self.dataset = dataset
        self.embedder = dataset.embedder
        self.seed = seed
        self.multi_target_freq = tuple(reversed(tuple(
            itertools.dropwhile(lambda x: x == 0, reversed(tuple(multi_target_freq))))))

        if dataset.hypernym_prompts or dataset.total_freq_hypernyms != 1:
            raise ValueError("Hypernyms are not supported by the noun multiset")
        if dataset.use_cache:
            raise ValueError("Configure the noun dataset without an internal cache here")
        if not dataset.use_targets:
            raise ValueError("Generating a noun multiset requires the noun dataset to use targets")
        if not self.multi_target_freq or any(f < 0 for f in self.multi_target_freq) \
                or sum(self.multi_target_freq) <= 0:
            raise ValueError(f"Invalid multi-target frequencies: {multi_target_freq}")
        freq_sum = sum(self.multi_target_freq)

        self.singular_prompts = tuple(p for p in dataset.singular_prompts for _ in range(p.freq))
        self.plural_prompts = tuple(p for p in dataset.plural_prompts for _ in range(p.freq))
        self.singular_samples = tuple((s, v["target_noun"]) for v in dataset.vocab_json
                                      for s in v["singulars"])
        self.plural_samples = tuple((p, v["target_noun"]) for v in dataset.vocab_json
                                    for p in v["plurals"])
        self.singular_counts = tuple(c for v in dataset.vocab_json for c in v["singulars_freq"])
        self.plural_counts = tuple(c for v in dataset.vocab_json for c in v["plurals_freq"])
        self.singular_counts_total = sum(self.singular_counts)
        self.plural_counts_total = sum(self.plural_counts)
        assert (self.singular_counts_total * len(self.singular_prompts)
                + self.plural_counts_total * len(self.plural_prompts)) == dataset.num_fsids

        super().__init__(cache_path, num_embed=dataset.num_fsids * freq_sum,
                         embed_dim=self.embedder.embed_dim,
                         target_tokenizer=self.embedder.target_tokenizer,
                         target_nouns=dataset.targets,
                         num_embed_targets=len(self.multi_target_freq), shuffle=True,
                         use_targets=True,
                         full_targets=(freq_sum == self.multi_target_freq[-1]),
                         default_weights=True, unit_weights=True,
                         embedder_hash=self.embedder.get_configuration_hash(True, False),
                         seed=seed)

    def generate(self):
        log.info(f"Caching noun multiset with freqs {self.multi_target_freq} "
                 f"({self.num_embed} embeddings)...")
        rng = random.Random(self.seed)
        with self.embedder.inference_model(), self:
            total_embed = 0
            for multi_num, multi_freq in enumerate(self.multi_target_freq, 1):
                if multi_freq <= 0:
                    continue
                texts: list[str] = []
                targets: list[tuple] = []
                verify_counter = collections.Counter() if multi_num == 1 else None

                def flush():
                    nonlocal total_embed
                    if not texts:
                        return
                    embeds = self.embedder.inference_text(texts)
                    etargets = self.tensorize_embed_targets(targets)
                    if verify_counter is not None:
                        verify_counter.update(zip(texts, targets))
                    self.write(embeds, etargets)
                    total_embed += len(texts)
                    texts.clear()
                    targets.clear()

                for _ in range(multi_freq):
                    for prompts, samples, counts, counts_total in (
                            (self.singular_prompts, self.singular_samples,
                             self.singular_counts, self.singular_counts_total),
                            (self.plural_prompts, self.plural_samples,
                             self.plural_counts, self.plural_counts_total)):
                        for prompt in prompts:
                            draws = tuple(rng.sample(samples, counts=counts, k=counts_total)
                                          for _ in range(multi_num))
                            for noun_targets in zip(*draws):
                                if prompt.need_article:
                                    nouns = (make_indefinite(nt[0]) for nt in noun_targets)
                                else:
                                    nouns = (nt[0] for nt in noun_targets)
                                texts.append(prompt.template.format(noun=" and ".join(nouns)))
                                targets.append(tuple(nt[1] for nt in noun_targets))
                                if len(texts) == self.embedder.inference_batch_size:
                                    flush()
                flush()

                if verify_counter is not None:
                    # The m=1 stream must equal the plain dataset stream, counted
                    # (ref :331-352)
                    dataset_counter = collections.Counter(
                        (self.dataset.get_sample_text(fsid=f)[0],
                         (self.dataset.get_sample_text(fsid=f)[1],))
                        for f in range(self.dataset.num_fsids))
                    for key in dataset_counter:
                        dataset_counter[key] *= multi_freq
                    assert verify_counter == dataset_counter, \
                        "m=1 multiset stream does not match the plain noun dataset"
            assert total_embed == self.num_embed
        log.info("Noun multiset cache complete")


class CaptionsCacheWriter(EmbeddingCacheWriter):
    """LLM captions JSON → cache: per noun, sample freq_sum × template_multiplier
    caption templates, emit freq × sample_multiplier samples per noun-variant
    cycling templates (ref :359-546)."""

    def __init__(self, cache_path: str, captions_path: str, dataset: NounDataset,
                 template_multiplier: int, sample_multiplier: int,
                 print_approx: int = 0, seed: Optional[int] = None):
        self.dataset = dataset
        self.embedder = dataset.embedder
        self.sample_multiplier = sample_multiplier
        self.template_multiplier = min(template_multiplier, sample_multiplier)
        if self.template_multiplier < 1:
            raise ValueError("Multipliers must be at least 1")
        rng = random.Random(seed)

        target_map = {v["target_noun"]: v for v in dataset.vocab_json}
        with open(captions_path) as f:
            captions_json = json.load(f)
        if not isinstance(captions_json, list):
            raise TypeError("Captions JSON should contain a list")

        captions_vocab_map: dict[str, dict] = {}
        unused = set()
        for cv in captions_json:
            target = cv["target_noun"]
            if target in captions_vocab_map or target in unused:
                raise ValueError(f"Duplicate target noun in captions JSON: {target}")
            sing = tuple(c if c.endswith(".") else c + "." for c in cv["singular_captions"])
            plur = tuple(c if c.endswith(".") else c + "." for c in cv["plural_captions"])
            if not all("{singular}" in c for c in sing):
                raise ValueError(f"Singular caption template missing {{singular}} placeholder: {target}")
            if not all("{plural}" in c for c in plur):
                raise ValueError(f"Plural caption template missing {{plural}} placeholder: {target}")
            if len(set(sing)) != len(sing) or len(set(plur)) != len(plur):
                raise ValueError(f"Duplicate captions for target noun: {target}")
            cv = dict(cv, singular_captions=sing, plural_captions=plur)
            if target in target_map:
                captions_vocab_map[target] = cv
            else:
                unused.add(target)
        missing = set(target_map) - set(captions_vocab_map)
        if missing:
            log.warning(f"{len(missing)} noun dataset targets missing in captions JSON")

        self.entries = []
        for target, cv in captions_vocab_map.items():
            nv = target_map[target]
            n_sing = nv["singulars_freq_sum"] * self.template_multiplier
            n_plur = nv["plurals_freq_sum"] * self.template_multiplier
            sing_prompts = rng.sample(cv["singular_captions"],
                                      k=min(len(cv["singular_captions"]), n_sing))
            plur_prompts = rng.sample(cv["plural_captions"],
                                      k=min(len(cv["plural_captions"]), n_plur))
            if sing_prompts or plur_prompts:
                self.entries.append((nv, sing_prompts, plur_prompts))

        num_embed = self.sample_multiplier * sum(
            (nv["singulars_freq_sum"] if sp else 0) + (nv["plurals_freq_sum"] if pp else 0)
            for nv, sp, pp in self.entries)

        super().__init__(cache_path, num_embed=num_embed, embed_dim=self.embedder.embed_dim,
                         target_tokenizer=self.embedder.target_tokenizer,
                         target_nouns=dataset.targets, num_embed_targets=1, shuffle=True,
                         use_targets=True, full_targets=True, default_weights=True,
                         unit_weights=True,
                         embedder_hash=self.embedder.get_configuration_hash(True, False),
                         seed=seed)

    def generate(self):
        log.info(f"Converting captions JSON to a cache with {self.num_embed} embeddings...")
        with self.embedder.inference_model(), self:
            pending: list[tuple[str, str]] = []
            total = 0

            def flush(final=False):
                nonlocal pending, total
                bs = self.embedder.inference_batch_size
                while pending and (len(pending) >= bs or final):
                    chunk = pending[:bs]
                    pending = pending[len(chunk):]
                    texts, targets = zip(*chunk)
                    embeds = self.embedder.inference_text(list(texts))
                    self.write(embeds, self.tensorize_embed_targets(targets))
                    total += len(chunk)

            for nv, sing_prompts, plur_prompts in self.entries:
                for prompts, nouns, freqs, field in (
                        (sing_prompts, nv["singulars"], nv["singulars_freq"], "singular"),
                        (plur_prompts, nv["plurals"], nv["plurals_freq"], "plural")):
                    if not prompts:
                        continue
                    pi = 0
                    for noun, freq in zip(nouns, freqs):
                        for _ in range(freq * self.sample_multiplier):
                            pending.append((prompts[pi].format(**{field: noun}),
                                            nv["target_noun"]))
                            pi = (pi + 1) % len(prompts)
                flush()
            flush(final=True)
            assert total == self.num_embed
        log.info("Captions JSON conversion to embedding cache complete")


class ClassificationCacheWriter(EmbeddingCacheWriter):
    """Image classification dataset → image-embedding cache with (multi-)targets
    aligned to the noun vocab (ref :549-586)."""

    def __init__(self, cache_path: str, embedder, loader, num_images: int,
                 targets: Sequence[str], class_targets: Sequence[Sequence[str]],
                 seed: Optional[int] = None):
        self.embedder = embedder
        self.loader = loader
        self.class_targets = class_targets
        if not class_targets or any(not t for t in class_targets):
            raise ValueError("class_targets must be non-empty sequences of target nouns")
        M = max(len(t) for t in class_targets)
        super().__init__(cache_path, num_embed=num_images, embed_dim=embedder.embed_dim,
                         target_tokenizer=embedder.target_tokenizer, target_nouns=targets,
                         num_embed_targets=M, shuffle=True, use_targets=True,
                         full_targets=all(len(t) == M for t in class_targets),
                         default_weights=True, unit_weights=True,
                         embedder_hash=embedder.get_configuration_hash(True, False), seed=seed)

    def generate(self):
        with self.embedder.inference_model(), self:
            class_embed_targets = self.tensorize_embed_targets(self.class_targets)
            for images, cls_indices in self.loader:
                embeds = self.embedder.inference_image(images)
                self.write(embeds, class_embed_targets[np.asarray(cls_indices)])


class ImageCacheWriter(EmbeddingCacheWriter):
    """Directory of images → targetless embedding cache (ref :589-637)."""

    def __init__(self, cache_path: str, embedder, images: Iterable[str],
                 seed: Optional[int] = None):
        self.embedder = embedder
        self.image_paths: list[str] = []
        for image in images:
            image = os.path.abspath(image)
            if os.path.isdir(image):
                filenames = os.listdir(image)
                for pattern in IMAGE_PATTERNS:
                    self.image_paths.extend(
                        os.path.join(image, fn) for fn in filenames
                        if fnmatch.fnmatch(fn.lower(), pattern))
            else:
                self.image_paths.append(image)
        log.info(f"Discovered {len(self.image_paths)} images")
        super().__init__(cache_path, num_embed=len(self.image_paths),
                         embed_dim=embedder.embed_dim, shuffle=True, use_targets=False,
                         embedder_hash=embedder.get_configuration_hash(True, False), seed=seed)

    def generate(self):
        from novic_tpu_torch.embedders.preprocess import load_images

        with self.embedder.inference_model(), self:
            transform = self.embedder.get_image_transform()
            bs = self.embedder.image_batch_size
            for i in range(0, len(self.image_paths), bs):
                paths = self.image_paths[i:i + bs]
                pixel = transform(load_images(paths))
                self.write(self.embedder.inference_image(pixel))


class MergeCachesWriter(EmbeddingCacheWriter):
    """Shuffle-merge k caches with integer repeat frequencies (ref :640-753)."""

    def __init__(self, cache_path: str, embedder, caches: Sequence[EmbeddingCache],
                 freqs: Optional[Sequence[int]] = None, use_targets: Optional[bool] = None,
                 multi_mode: Union[str, int] = "max", batch_size: int = 2048,
                 seed: Optional[int] = None):
        self.embedder = embedder
        self.caches = list(caches)
        if not self.caches:
            raise ValueError("Merging requires one or more input caches")
        first = self.caches[0]
        self.merge_batch_size = batch_size
        self.freqs = tuple(freqs) if freqs is not None else tuple(1 for _ in self.caches)
        if len(self.freqs) != len(self.caches) or any(f < 1 for f in self.freqs):
            raise ValueError("Mismatch between caches and frequencies")

        if use_targets is None:
            use_targets = first.use_targets
        if any(c.use_targets != use_targets for c in self.caches):
            raise ValueError("Mismatch between caches in terms of whether to use targets")

        if use_targets:
            if any(c.target_nouns != first.target_nouns for c in self.caches):
                raise ValueError("Caches to merge disagree on target nouns")
            target_nouns = first.target_nouns[1:]
            try:
                multi_mode = int(multi_mode)
            except (TypeError, ValueError):
                pass
            if multi_mode == "min":
                M = min(c.header.embed_targets_dim for c in self.caches)
            elif multi_mode == "max":
                M = max(c.header.embed_targets_dim for c in self.caches)
            elif isinstance(multi_mode, int):
                M = multi_mode
            else:
                raise ValueError(f"Merge multi-mode not recognised: {multi_mode}")
            full_targets = all(c.header.full_targets and M <= c.header.embed_targets_dim
                               for c in self.caches)
            unit_weights = all(c.header.unit_weights and M >= c.header.embed_targets_dim
                               for c in self.caches)
            default_weights = False
        else:
            full_targets = unit_weights = True
            default_weights = True
            target_nouns = None
            M = 0

        super().__init__(cache_path,
                         num_embed=sum(c.header.embed_num * f
                                       for c, f in zip(self.caches, self.freqs)),
                         embed_dim=first.header.embed_dim,
                         embed_dtype=first.meta.embed_dtype,
                         target_tokenizer=embedder.target_tokenizer if use_targets else None,
                         target_nouns=target_nouns, num_embed_targets=max(M, 1) if use_targets else 1,
                         shuffle=True, use_targets=use_targets, full_targets=full_targets,
                         default_weights=default_weights, unit_weights=unit_weights,
                         embedder_hash=first.header.embedder_hash,
                         embedder_strict=first.header.embedder_strict, seed=seed)

    def generate(self):
        log.info(f"Shuffle-merging {sum(self.freqs)} caches into {self.num_embed} embeddings...")
        with self:
            for cache, freq in zip(self.caches, self.freqs):
                with cache:
                    N = cache.header.embed_num
                    for start in range(0, N, self.merge_batch_size):
                        stop = min(start + self.merge_batch_size, N)
                        embeds, tids, _, _, weights = cache.get_samples(start, stop)
                        embeds = np.asarray(embeds)
                        if self.use_targets:
                            tids = np.asarray(tids)
                            weights = np.asarray(weights)
                            M = self.header.embed_targets_dim
                            Mc = cache.header.embed_targets_dim
                            if Mc < M:
                                tids = np.pad(tids, ((0, 0), (0, M - Mc)))
                                weights = np.pad(weights, ((0, 0), (0, M - Mc)))
                            elif Mc > M:
                                tids = tids[:, :M]
                                weights = weights[:, :M]
                            for _ in range(freq):
                                self.write(embeds, tids, weights)
                        else:
                            for _ in range(freq):
                                self.write(embeds)
        log.info("Shuffle-merge of embedding caches complete")
