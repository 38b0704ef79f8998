"""NOVIC inference API on PyTorch (the counterpart of novic_tpu.infer).

NOVICModel (a context manager that loads the embedder towers and the decoder,
then classify_image(s)/classify_embeds return NOVICOutput), GenerationConfig
with its compact name codec (``{method}_k{K}_v{none|tokX|tgtX}_g{n|p|r}_t{T}_a{A}``),
the GenerationTask evaluator with its top-k result bucketing, and the loader
helpers. Models run on an explicit device, CUDA by default.

Greedy decode and beam search (with vocab priors) are ported; exhaustive
('all') generation raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import re
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.base import Embedder
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.generate import generate_beam, generate_greedy
from novic_tpu_torch.models.guide_trie import build_guide_trie
from novic_tpu_torch.models.prefixed_iter import PrefixedIterDecoder
from novic_tpu_torch.text.target import TargetConfig, TargetTokenizer
from novic_tpu_torch.utils.logger import log
from novic_tpu_torch.utils.misc import format_semifix

# Guide sets at or above this size decode through trie-node state instead of
# the (B,K,W) alive mask, whose per-step cost grows with W (the trie's does not).
TRIE_MIN_TARGETS = 512

# ---------------------------------------------------------------------------
# GenerationConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    method: str            # greedy | beam | all
    topk: int
    vocab_prior: bool = False
    vocab_per_token: bool = False
    vocab_scaler: float = 0.0
    guided: bool = False
    guide_renorm: bool = False
    temperature: float = 1.0
    length_alpha: float = 0.0
    name: str = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "name", self.generate_name())

    def generate_name(self) -> str:
        vocab_prior = (f"{'tok' if self.vocab_per_token else 'tgt'}"
                       f"{format_semifix(self.vocab_scaler, precision=3)}"
                       if self.vocab_prior else "none")
        guide = "n" if not self.guided else ("r" if self.guide_renorm else "p")
        return (f"{self.method}_k{self.topk}_v{vocab_prior}_g{guide}"
                f"_t{format_semifix(self.temperature, precision=3)}"
                f"_a{format_semifix(self.length_alpha, precision=3)}")

    @staticmethod
    def from_name(name: str) -> "GenerationConfig":
        # Grammar: METHOD ( "_" FIELD )* with FIELD one of
        #   kINT | v(none|tokF|tgtF) | g(n|p|r) | tFLOAT | aFLOAT
        method, _, tail = name.partition("_")
        fields: dict[str, Any] = {"k": 0, "t": 1.0, "a": 0.0,
                                  "vp": False, "vtok": False, "vs": 0.0,
                                  "g": False, "gr": False}
        for field in tail.split("_") if tail else ():
            if not field:
                raise ValueError(f"Empty field (doubled '_'?) in gencfg name {name!r}")
            key, spec = field[0], field[1:]
            try:
                if key == "k":
                    fields["k"] = int(spec)
                elif key == "v":
                    if spec != "none":
                        match = re.fullmatch(r"(tok|tgt)(.*)", spec)
                        if match is None:
                            raise ValueError(f"Vocab prior must be none/tokF/tgtF, got {spec!r}")
                        fields["vp"] = True
                        fields["vtok"] = match.group(1) == "tok"
                        fields["vs"] = float(match.group(2))
                elif key == "g":
                    if spec not in ("n", "p", "r"):
                        raise ValueError(f"Guide mode must be one of n/p/r, got {spec!r}")
                    fields["g"] = spec != "n"
                    fields["gr"] = spec == "r"
                elif key == "t":
                    fields["t"] = float(spec)
                elif key == "a":
                    fields["a"] = float(spec)
                else:
                    raise ValueError(f"Unknown field key {key!r}")
            except ValueError:
                raise ValueError(f"Bad gencfg field {field!r} in name {name!r}")
        gencfg = GenerationConfig(method=method, topk=fields["k"], vocab_prior=fields["vp"],
                                  vocab_per_token=fields["vtok"], vocab_scaler=fields["vs"],
                                  guided=fields["g"], guide_renorm=fields["gr"],
                                  temperature=fields["t"], length_alpha=fields["a"])
        if gencfg.method not in ("greedy", "beam", "all"):
            raise ValueError(f"Gencfg method must be greedy/beam/all, got {gencfg.method!r}")
        if gencfg.topk < 1:
            raise ValueError(f"Gencfg needs a top-k of at least 1, got {gencfg.topk}")
        if gencfg.temperature <= 0:
            raise ValueError(f"Gencfg temperature must be positive, got {gencfg.temperature}")
        if gencfg.name != name:
            raise ValueError(f"Gencfg name {name!r} is not canonical (expected {gencfg.name!r})")
        return gencfg


# ---------------------------------------------------------------------------
# Decoder holder and GenerationTask
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Decoder:
    """A decoder module (on its device) + config + target tokenizer."""

    model: PrefixedIterDecoder
    cfg: DecoderModelConfig
    target_tokenizer: TargetTokenizer
    target_vocab: tuple[str, ...] = ()


RESULT_NAMES = ("correct", "valid_guide", "valid_vocab", "invalid")
COLOR_MAP = ("\033[92m", "\033[35m", "\033[33m", "\033[91m")


@dataclasses.dataclass(eq=False)
class GenerationTask:
    gencfg: GenerationConfig
    decoder: Decoder
    vocab_targets_set: set[str]
    vocab_targets: Optional[np.ndarray]
    guide_targets_set: set[str]
    guide_targets: Optional[np.ndarray]
    class_lists: Optional[Sequence[Sequence[str]]] = None

    target: Optional[np.ndarray] = None
    target_padding: Optional[np.ndarray] = None
    target_score: Optional[list] = None
    num_samples: int = 0
    target_str: Optional[list] = None
    invalid: Optional[np.ndarray] = None
    valid_vocab: Optional[np.ndarray] = None
    valid_guide: Optional[np.ndarray] = None
    correct: Optional[np.ndarray] = None
    result: Optional[np.ndarray] = None
    topk_counts: np.ndarray = dataclasses.field(init=False)
    topk_invalid: Optional[np.ndarray] = None
    topk_valid: Optional[np.ndarray] = None
    topk_vocab: Optional[np.ndarray] = None
    topk_guide: Optional[np.ndarray] = None
    topk: Optional[np.ndarray] = None
    batch_pad: int = 0  # pad ragged batches with unit e0 rows up to this size

    _trie_cache: dict = dataclasses.field(default_factory=dict)
    _targets_device: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.topk_counts = np.zeros((self.gencfg.topk, 4), dtype=np.int64)
        if self.gencfg.vocab_prior and self.vocab_targets is None:
            raise ValueError("Generation config specifies vocab priors but no vocab targets given")
        if self.gencfg.guided and self.guide_targets is None:
            raise ValueError("Guided gencfg requires guide targets")
        if self.gencfg.method == "greedy":
            if self.gencfg.topk != 1:
                raise ValueError(f"Greedy generation requires top-k == 1, got {self.gencfg.topk}")
            if self.gencfg.vocab_prior:
                raise ValueError("Vocab priors are not available for greedy generation")
        elif self.gencfg.method == "all":
            if not self.gencfg.guided:
                raise ValueError("The 'all' generation method must always be guided")
            raise NotImplementedError("Generation method 'all' is not ported yet "
                                      "(greedy and beam only)")

    def clear(self):
        self.target = self.target_padding = self.target_score = None
        self.num_samples = 0
        self.target_str = None
        self.invalid = self.valid_vocab = self.valid_guide = self.correct = self.result = None
        self.topk_counts = np.zeros((self.gencfg.topk, 4), dtype=np.int64)
        self.topk_invalid = self.topk_valid = self.topk_vocab = self.topk_guide = self.topk = None

    # -- generation ---------------------------------------------------------------

    def generate(self, embeds: np.ndarray):
        """→ (target BxKxC, padding BxKxC, scores BxK descending), numpy."""
        true_b = embeds.shape[0]
        if self.batch_pad and true_b < self.batch_pad:
            pad = np.zeros((self.batch_pad - true_b, embeds.shape[1]), np.float32)
            pad[:, 0] = 1.0  # unit vectors so decode math stays well-conditioned
            t, p, s = self.generate(np.concatenate([np.asarray(embeds, np.float32), pad], axis=0))
            return t[:true_b], p[:true_b], s[:true_b]
        g = self.gencfg
        model = self.decoder.model
        guide = self._targets("guide") if g.guided else None
        vocab = self._targets("vocab") if g.vocab_prior else None
        g_trie = self._maybe_trie(self.guide_targets, "guide") if g.guided else None
        e = torch.from_numpy(np.ascontiguousarray(embeds, dtype=np.float32)).to(model.device)
        if g.method == "greedy":
            t, p, _, _, _, s = generate_greedy(model, e, calc_loss=True, temperature=g.temperature,
                                               length_alpha=g.length_alpha, guide_targets=guide,
                                               guide_renorm=g.guide_renorm, guide_trie=g_trie)
            t, p, s = t[:, None], p[:, None], s[:, None]
        else:
            v_trie = (self._maybe_trie(self.vocab_targets, "vocab")
                      if vocab is not None and vocab is not guide else None)
            t, p, s = generate_beam(model, e, topk=g.topk, temperature=g.temperature,
                                    length_alpha=g.length_alpha, vocab_targets=vocab,
                                    vocab_per_token=g.vocab_per_token,
                                    vocab_scaler=g.vocab_scaler, guide_targets=guide,
                                    guide_renorm=g.guide_renorm, guide_trie=g_trie,
                                    vocab_trie=v_trie)
        return t.cpu().numpy(), p.cpu().numpy(), s.cpu().numpy()

    def _targets(self, which: str) -> torch.Tensor:
        """The guide or vocab target ids on the device, moved once. When both sets
        hold the same rows they share one tensor, which generate_beam reads as
        'the vocab prior counts the guide's alive rows'."""
        cached = self._targets_device.get(which)
        if cached is None:
            ids = self.guide_targets if which == "guide" else self.vocab_targets
            other = self.vocab_targets if which == "guide" else self.guide_targets
            shared = "vocab" if which == "guide" else "guide"
            if (shared in self._targets_device and other is not None
                    and (ids is other or np.array_equal(ids, other))):
                cached = self._targets_device[shared]
            else:
                cached = torch.from_numpy(np.asarray(ids, np.int64)).to(self.decoder.model.device)
            self._targets_device[which] = cached
        return cached

    def _maybe_trie(self, targets: Optional[np.ndarray], which: str):
        """Build (once per target set, "guide" or "vocab") and move to the device
        the trie tables for a target set, or return None when the set is small
        enough for the mask path. The row-count tables go along when the gencfg
        has a vocab prior."""
        if targets is None:
            return None
        targets = np.asarray(targets)
        G = self.decoder.cfg.token_length - 1
        if len(targets) < TRIE_MIN_TARGETS or targets.shape[1] < G:
            return None
        cached = self._trie_cache.get(which)
        if cached is not None:
            return cached
        trie = build_guide_trie(targets, self.decoder.cfg.vocab_size, G)
        keys = ["child_tok", "child_id", "child_pack"]
        if self.gencfg.vocab_prior:
            keys += ["child_cnt", "node_cnt"]
        tables = {k: trie[k] for k in keys}
        if trie["child_pack"] is not None:
            # With the packed table, child_tok/child_id are read only at depth 0
            # (the root special case): keep only those on the device
            dummy = np.zeros((1, 1), np.int32)
            for key in ("child_tok", "child_id"):
                tables[key] = [trie[key][0]] + [dummy] * (len(trie[key]) - 1)
        dev = self.decoder.model.device
        to_dev = lambda ts: None if ts is None else [torch.from_numpy(t).to(dev) for t in ts]
        self._trie_cache[which] = {k: to_dev(v) for k, v in tables.items()}
        return self._trie_cache[which]

    def process(self, embeds: np.ndarray, *, class_indices: Optional[Sequence[int]] = None):
        t, p, s = self.generate(embeds)
        self.update(target=t, target_padding=p, target_score=s, class_indices=class_indices)

    # -- statistics ---------------------------------------------------------------

    def update(self, target: np.ndarray, target_padding: np.ndarray, target_score: np.ndarray,
               *, class_indices: Optional[Sequence[int]] = None):
        self.target = np.asarray(target)
        self.target_padding = np.asarray(target_padding)
        self.target_score = np.asarray(target_score).tolist()

        self.num_samples += self.target.shape[0]
        self.target_str = self.decoder.target_tokenizer.detokenize_target(self.target)
        self.valid_vocab = np.asarray(
            [[pred in self.vocab_targets_set for pred in preds] for preds in self.target_str],
            dtype=bool)
        self.valid_guide = np.asarray(
            [[pred in self.guide_targets_set for pred in preds] for preds in self.target_str],
            dtype=bool)
        if class_indices is not None and self.class_lists is not None:
            self.correct = np.asarray(
                [[pred in self.class_lists[cls] for pred in preds]
                 for cls, preds in zip(class_indices, self.target_str)], dtype=bool)
        else:
            self.correct = np.zeros(self.target.shape[:-1], dtype=bool)
        self.invalid = np.logical_not(self.correct | self.valid_guide | self.valid_vocab)
        # result: 0 correct, 1 else valid guide, 2 else valid vocab, 3 invalid
        stacked = np.stack([self.correct, self.valid_guide, self.valid_vocab,
                            np.ones_like(self.invalid)], axis=2)
        stacked = np.maximum.accumulate(stacked, axis=2)
        self.result = np.argmax(stacked, axis=2)
        stacked[:, :, -1] = self.invalid
        self.topk_counts += np.maximum.accumulate(stacked, axis=1).sum(axis=0)
        counts = self.topk_counts.astype(np.float64)
        self.topk_valid = (self.num_samples - counts[:, 3]) / self.num_samples
        ratios = counts / self.num_samples
        self.topk_invalid = ratios[:, 3]
        self.topk_vocab = ratios[:, 2]
        self.topk_guide = ratios[:, 1]
        self.topk = ratios[:, 0]


class GenerationTaskList:
    """Several gencfg tasks over the same batches, generated and updated in the
    JAX package's order (a task's update after the next task's generation)."""

    def __init__(self, tasks: Sequence[GenerationTask]):
        self.tasks = list(tasks)

    def process(self, embeds: np.ndarray, *, class_indices: Optional[Sequence[int]] = None):
        pending = None
        for task in self.tasks:
            out = task.generate(embeds)
            if pending is not None:
                self._update(*pending, class_indices)
            pending = (task, out)
        if pending is not None:
            self._update(*pending, class_indices)

    @staticmethod
    def _update(task: GenerationTask, out: tuple, class_indices):
        task.update(target=out[0], target_padding=out[1], target_score=out[2],
                    class_indices=class_indices)

    def clear(self):
        for task in self.tasks:
            task.clear()


# ---------------------------------------------------------------------------
# Loader helpers
# ---------------------------------------------------------------------------


def load_guide_targets(target_tokenizer: TargetTokenizer, guide_targets: Sequence[str],
                       batch_size: int = 1024) -> tuple[np.ndarray, tuple[str, ...]]:
    """Batch-tokenize guide targets, dropping unencodable ones."""
    guide_list = list(dict.fromkeys(guide_targets))
    ids, _ = target_tokenizer.tokenize_targets_batched(guide_list, batch_size=batch_size)
    encodable = (ids >= 0).all(axis=1)
    if not encodable.all():
        dropped = [g for g, ok in zip(guide_list, encodable) if not ok]
        log.warning(f"Dropped {len(dropped)} unencodable guide targets "
                    f"(e.g. {dropped[:3]})")
    kept = tuple(g for g, ok in zip(guide_list, encodable) if ok)
    return ids[encodable], kept


def load_decoder_from_checkpoint(checkpoint_path: str, embedder: Embedder,
                                 device: Union[str, torch.device] = "cuda") -> Decoder:
    """Load a native .npz decoder checkpoint onto `device` and configure the
    embedder's target tokenizer from it."""
    from novic_tpu_torch.bridge import decoder_from_numpy
    from novic_tpu_torch.train.checkpoint import load_checkpoint, load_reference_checkpoint

    dev = resolve(device)
    if checkpoint_path.endswith(".npz") or os.path.isdir(checkpoint_path):
        ckpt = load_checkpoint(checkpoint_path)
    else:
        ckpt = load_reference_checkpoint(checkpoint_path)

    target_config: TargetConfig = ckpt["target_config"]
    valid_nouns = ckpt["target_nouns"][ckpt["num_invalid_target_nouns"]:]
    if embedder.spec.split(":", 1)[0] == "test":
        # The test embedder's tokenizer must be the one the checkpoint was
        # trained with: the compact map pins its vocab size. Rebuild the
        # word-level tokenizer from the checkpoint's own nouns if it differs.
        expected = (len(target_config.compact_map)
                    if target_config.compact_map is not None else None)
        if expected is not None and embedder.tokenizer.vocab_size != expected:
            from novic_tpu_torch.text.simple import make_test_tokenizer

            word_tok = make_test_tokenizer(valid_nouns)
            if word_tok.vocab_size == expected:
                embedder.tokenizer = word_tok
            else:
                log.warning(
                    f"Test-embedder tokenizer vocab ({embedder.tokenizer.vocab_size}) "
                    f"does not match the checkpoint's compact map ({expected}) and "
                    f"cannot be reconstructed from its target nouns ({word_tok.vocab_size})")
    embedder.configure_target(target_config, valid_nouns)

    cfg: DecoderModelConfig = ckpt["model_config"]
    if cfg.model != "PrefixedIterDecoder":
        raise NotImplementedError(f"Decoder model {cfg.model!r} is not ported yet")
    model = decoder_from_numpy(cfg, ckpt["params"]).to(dev)
    log.info(f"Loaded decoder {cfg.model}: {sum(p.numel() for p in model.parameters())} params")
    return Decoder(model=model, cfg=cfg, target_tokenizer=embedder.target_tokenizer,
                   target_vocab=tuple(valid_nouns))


# ---------------------------------------------------------------------------
# NOVICModel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NOVICOutput:
    preds: list[list[str]]      # BxK predicted noun strings
    logprobs: list[list[float]] # BxK log-probability scores
    probs: list[list[float]]    # BxK exponentiated scores
    types: list[list[str]]      # BxK result types (correct/valid_guide/valid_vocab/invalid)


class NOVICModel:
    """The packaged open-vocabulary classifier.

    with NOVICModel(checkpoint, embedder_spec=...) as model:
        output = model.classify_images(images)
    """

    def __init__(self, checkpoint: str, *, embedder_spec: Optional[str] = None,
                 gencfg: Union[str, GenerationConfig] = "beam_k10_vnone_gn_t1_a0",
                 guide_targets: Optional[Sequence[str]] = None,
                 batch_size: int = 64, embedder_kwargs: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.checkpoint = checkpoint
        self.device = resolve(device)
        self.gencfg = GenerationConfig.from_name(gencfg) if isinstance(gencfg, str) else gencfg
        self.batch_size = batch_size
        self._guide_target_strs = list(guide_targets) if guide_targets is not None else None
        spec = embedder_spec if embedder_spec is not None else self._peek_embedder_spec(checkpoint)
        if spec is None:
            raise ValueError("Embedder spec not found in checkpoint; pass embedder_spec=...")
        kwargs = {"device": self.device, **(embedder_kwargs or {})}
        self.embedder = Embedder.create(spec, load_model=False, **kwargs)
        self.decoder: Optional[Decoder] = None
        self.task: Optional[GenerationTask] = None
        self._task_cache: dict[str, GenerationTask] = {}
        self._entered = 0

    @staticmethod
    def _peek_embedder_spec(checkpoint: str) -> Optional[str]:
        """Read cfg_flat['embedder'] of a .npz checkpoint without loading tensors."""
        import json

        if not os.path.isfile(checkpoint):
            raise FileNotFoundError(f"Checkpoint not found: {checkpoint}")
        if not checkpoint.endswith(".npz"):
            raise NotImplementedError("Only .npz decoder checkpoints are ported yet")
        try:
            with np.load(checkpoint, allow_pickle=False) as data:
                cfg_flat = json.loads(bytes(data["__meta__"]).decode())["cfg_flat"]
        except (OSError, KeyError, ValueError) as e:
            raise ValueError(f"Checkpoint is unreadable or corrupt: {checkpoint} "
                             f"({type(e).__name__}: {e})") from e
        spec = cfg_flat.get("embedder") or cfg_flat.get("embedder_spec")
        if spec is None:
            log.warning(f"Checkpoint records no embedder spec: {checkpoint}")
        return spec

    # -- configuration setters ------------------------------------------------------

    def set_guide_targets(self, guide_targets: Optional[Sequence[str]] = None,
                          guide_targets_file: Optional[str] = None):
        if guide_targets_file:
            with open(guide_targets_file) as f:
                guide_targets = [line.strip() for line in f if line.strip()]
        self._guide_target_strs = list(guide_targets) if guide_targets is not None else None
        self._task_cache.clear()  # guide sets are baked into built tasks
        if self.decoder is not None:
            self.task = self.task_for(self.gencfg)

    # -- lifecycle ------------------------------------------------------------------

    def __enter__(self) -> "NOVICModel":
        self._entered += 1
        if self._entered == 1:
            self.embedder.load_model()
            self.load_decoder()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        self._entered -= 1
        if self._entered <= 0:
            self._entered = 0
            self.embedder.unload_model()
            self.decoder = None
            self.task = None
            self._task_cache.clear()
        return False

    def load_decoder(self):
        self.decoder = load_decoder_from_checkpoint(self.checkpoint, self.embedder, self.device)
        self._task_cache.clear()
        self.task = self.task_for(self.gencfg)

    def task_for(self, gencfg: Union[str, GenerationConfig]) -> GenerationTask:
        """GenerationTask for a gencfg (its guide tables built once), cached per name."""
        gencfg = GenerationConfig.from_name(gencfg) if isinstance(gencfg, str) else gencfg
        task = self._task_cache.get(gencfg.name)
        if task is not None:
            return task
        dec = self.decoder
        if dec is None:
            raise RuntimeError("NOVICModel must be entered before building tasks")
        vocab_ids, vocab_strs = load_guide_targets(dec.target_tokenizer, dec.target_vocab)
        if self._guide_target_strs is not None:
            guide_ids, guide_strs = load_guide_targets(dec.target_tokenizer, self._guide_target_strs)
        else:
            guide_ids, guide_strs = vocab_ids, vocab_strs
        task = GenerationTask(
            gencfg=gencfg, decoder=dec,
            vocab_targets_set=set(vocab_strs), vocab_targets=vocab_ids,
            guide_targets_set=set(guide_strs),
            guide_targets=guide_ids if (gencfg.guided or gencfg.method == "all") else None)
        task.batch_pad = self.batch_size
        self._task_cache[gencfg.name] = task
        return task

    # -- classification -------------------------------------------------------------

    def transform_images(self, images: Sequence):
        """Preprocessed (B,S,S,3) float32 images, as the embedder's transform gives them
        (a tensor on the embedder's device for TorchEmbedder, numpy for HashEmbedder)."""
        return self.embedder.get_image_transform()(list(images))

    def embed_images(self, images: Sequence) -> np.ndarray:
        images = list(images)
        batches = [self.embedder.inference_image(self.transform_images(images[i:i + self.batch_size]))
                   for i in range(0, len(images), self.batch_size)]
        return np.concatenate(batches, axis=0)

    def classify_embeds(self, embeds: np.ndarray,
                        gencfg: Union[None, str, GenerationConfig] = None) -> NOVICOutput:
        """Classify unit embeddings; `gencfg` selects a (cached) non-default
        generation config for this call only."""
        if self.task is None:
            raise RuntimeError("NOVICModel must be entered before classification")
        task = self.task if gencfg is None else self.task_for(gencfg)
        task.clear()
        preds, logprobs, types = [], [], []
        for i in range(0, embeds.shape[0], self.batch_size):
            task.process(embeds[i:i + self.batch_size])
            preds.extend(task.target_str)
            logprobs.extend(task.target_score)
            types.extend([[RESULT_NAMES[r] for r in row] for row in task.result.tolist()])
        probs = [[float(np.exp(lp)) for lp in row] for row in logprobs]
        return NOVICOutput(preds=preds, logprobs=logprobs, probs=probs, types=types)

    def classify_images(self, images: Sequence,
                        gencfg: Union[None, str, GenerationConfig] = None) -> NOVICOutput:
        return self.classify_embeds(self.embed_images(images), gencfg=gencfg)

    def classify_image(self, image,
                       gencfg: Union[None, str, GenerationConfig] = None) -> NOVICOutput:
        return self.classify_images([image], gencfg=gencfg)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    parser = argparse.ArgumentParser(description="NOVIC inference: open-vocabulary image classification")
    parser.add_argument("--checkpoint", required=True, help="Decoder checkpoint (.npz)")
    parser.add_argument("--image_dir", default=None,
                        help="Directory against which relative --images paths are resolved")
    parser.add_argument("--images", nargs="+", required=True, help="Image paths to classify")
    parser.add_argument("--embedder", default=None, help="Embedder spec override (TYPE:NAME)")
    parser.add_argument("--gencfg", default="beam_k10_vnone_gp_t1_a0",
                        help="Generation configuration name")
    parser.add_argument("--guide_targets", nargs="*", default=None)
    parser.add_argument("--guide_targets_file", default=None)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--weights", default=None, help="Converted embedder tower weights (.npz)")
    parser.add_argument("--compute_dtype", default=None,
                        help="Embedder compute dtype override (float32|bfloat16)")
    parser.add_argument("--device", default="cuda", help="Torch device (default cuda)")
    args = parser.parse_args(argv)

    from novic_tpu_torch.embedders.preprocess import load_images

    embedder_kwargs = {}
    if args.weights:
        embedder_kwargs["weights_path"] = args.weights
    if args.compute_dtype:
        embedder_kwargs["compute_dtype"] = args.compute_dtype
    model = NOVICModel(args.checkpoint, embedder_spec=args.embedder, gencfg=args.gencfg,
                       batch_size=args.batch_size, embedder_kwargs=embedder_kwargs,
                       device=args.device)
    if args.guide_targets or args.guide_targets_file:
        model.set_guide_targets(args.guide_targets, args.guide_targets_file)
    image_paths = args.images
    if args.image_dir:
        image_paths = [p if os.path.isabs(p) else os.path.join(args.image_dir, p)
                       for p in image_paths]
    images = load_images(image_paths)
    with model:
        output = model.classify_images(images)
    reset = "\033[0m"
    for path, preds, logprobs, types in zip(args.images, output.preds, output.logprobs, output.types):
        tops = "  ".join(
            f"{COLOR_MAP[RESULT_NAMES.index(t)]}{p}{reset} ({np.exp(lp):.1%})"
            for p, lp, t in itertools.islice(zip(preds, logprobs, types), 3))
        print(f"{path} --> {tops}")


if __name__ == "__main__":
    main()
