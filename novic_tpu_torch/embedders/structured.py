"""Structured dual-modality test embedder ('test-structured:<dim>[:gap[:jitter[:seed]]]'),
a copy of novic_tpu.embedders.structured on the port's HashEmbedder: host
numpy, so its embeddings equal novic_tpu's bit for bit.

The reference's entire reason to exist is the modality-gap mechanism: the
object decoder is trained purely on *text* embeddings (plus unit-sphere noise
augmentation, reference embedding_noise.py:59-173, and optional mean-shift,
reference train.py:1008-1026) and then applied zero-shot to *image*
embeddings that live an essentially constant rotation away on the sphere.
The plain hash test embedder ('test:<dim>') cannot exercise this: its text
and image embeddings are mutually orthogonal random vectors, so any
text-trained decoder scores 0 on images by construction.

This embedder builds a *structured* synthetic CLIP-like geometry on the unit
sphere so the full released recipe (cache -> train -> eval_cls) demonstrates
the mechanism in-stack:

- Every class noun has a deterministic unit **prototype** p(noun) (seeded
  hash). Random prototypes in dim F are ~90 degrees apart.
- **Text** embeddings of a text mentioning the noun are p(noun) jittered by a
  rotation of U(0, jitter_deg) degrees in a text-keyed random direction
  (the intra-class spread). Multi-noun multiset texts use the normalized
  mean of the mentioned prototypes (the reference's multiset texts
  'a photo of a {noun1} and a {noun2}', embedding_cache_writers.py:246-356).
- **Image** embeddings of an image depicting the noun are p(noun) rotated by
  exactly gap_deg degrees toward a single *global* gap direction
  (orthogonalized per-prototype so the angle is exact), then jittered the
  same way. A shared global direction is what makes the image-minus-text
  mean a consistent vector, i.e. what gives `mean_shift` something real to
  measure — mirroring the measured CLIP geometry in the reference's
  data/modality_gap_*.json files (image embeddings concentrated in a cone
  offset from the text cone).

Images are **self-describing**: the depicted class noun is steganographically
encoded in the first pixel rows (encode_class_image), so inference_image can
recover it after the (identity, nearest, mean/std=0.5) preprocessing without
any side-channel state. This keeps every CLI action (embedder_zero_shot with
measure_gap, cache_cls, eval_cls, infer --images) working unchanged.

Texts are matched against a noun **lexicon** (variant string -> target noun),
threaded in from the CLI's vocab_path exactly like the test tokenizer, or
derived from the configured target vocabulary (serving from a checkpoint).
Unmatched texts / undecodable images fall back to orthogonal hash embeddings
(the 'test:<dim>' behavior).
"""

from __future__ import annotations

import hashlib
import re
from typing import Optional, Sequence

import numpy as np

from novic_tpu_torch.embedders.base import HashEmbedder
from novic_tpu_torch.embedders.preprocess import PreprocessConfig, preprocess_pil_host

IMG_SIZE = 32
_MAGIC = (78, 86)  # 'N', 'V'
_MEAN = (0.5, 0.5, 0.5)
_STD = (0.5, 0.5, 0.5)


def structured_preprocess_config() -> PreprocessConfig:
    """Nearest-neighbour identity resize at IMG_SIZE with invertible 0.5/0.5
    normalization, so encode_class_image survives preprocessing bit-exactly."""
    return PreprocessConfig(size=IMG_SIZE, resize_mode="shortest", mean=_MEAN, std=_STD,
                            interpolation="nearest")


def encode_class_image(noun: str, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(IMG_SIZE, IMG_SIZE, 3) uint8 image depicting `noun`.

    Row 0 (channel 0) carries [magic0, magic1, len, utf8 bytes..., checksum];
    the rest is per-sample random texture (distinct images per call when an
    rng is given). The noun must fit in IMG_SIZE - 4 bytes.
    """
    data = noun.encode("utf-8")
    if len(data) > IMG_SIZE - 4:
        raise ValueError(f"Class noun too long to encode in a test image: {noun!r}")
    if rng is None:
        rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (IMG_SIZE, IMG_SIZE, 3), dtype=np.uint8)
    row = np.zeros(IMG_SIZE, np.uint8)
    row[0], row[1] = _MAGIC
    row[2] = len(data)
    row[3:3 + len(data)] = np.frombuffer(data, np.uint8)
    row[3 + len(data)] = (int(row[:3 + len(data)].sum()) + 7) % 256
    img[0, :, 0] = row
    return img


def decode_class_image(pixels: np.ndarray) -> Optional[str]:
    """Inverse of encode_class_image on a *preprocessed* (S, S, 3) float image."""
    if pixels.shape[0] != IMG_SIZE or pixels.shape[1] != IMG_SIZE:
        return None
    row = np.rint(np.asarray(pixels[0, :, 0], np.float64) * _STD[0] * 255.0
                  + _MEAN[0] * 255.0).astype(np.int64)
    if row[0] != _MAGIC[0] or row[1] != _MAGIC[1]:
        return None
    n = int(row[2])
    if n > IMG_SIZE - 4:
        return None
    if int(row[3 + n]) != (int(row[:3 + n].sum()) + 7) % 256:
        return None
    try:
        return bytes(row[3:3 + n].astype(np.uint8)).decode("utf-8")
    except UnicodeDecodeError:
        return None


def _seeded_rng(*parts) -> np.random.Generator:
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode("utf-8"))
        h.update(b"\x00")
    return np.random.default_rng(int.from_bytes(h.digest(), "little"))


def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(float(np.linalg.norm(v)), 1e-30)


def _rotate_toward(base: np.ndarray, direction: np.ndarray, angle_rad: float) -> np.ndarray:
    """Rotate unit `base` by exactly angle_rad toward `direction`
    (orthogonalized against base; falls back to base if degenerate)."""
    d = direction - float(direction @ base) * base
    n = float(np.linalg.norm(d))
    if n < 1e-12:
        return base
    return np.cos(angle_rad) * base + np.sin(angle_rad) * (d / n)


class StructuredEmbedder(HashEmbedder):
    """See module docstring. Spec: 'test-structured:<dim>[:gap[:jitter[:seed]]]'
    with gap/jitter in degrees (defaults 60 / 10 / 0)."""

    def __init__(self, *, spec: str, embed_dim: int, gap_deg: float = 60.0,
                 jitter_deg: float = 10.0, seed: int = 0, gap_mix: float = 1.0,
                 gap_spread_deg: float = 0.0, crowd: float = 0.0,
                 lexicon: Optional[dict[str, str]] = None,
                 tokenizer_batch_size: int = 1024, inference_batch_size: int = 256,
                 image_batch_size: int = 128, check: bool = False, tokenizer=None):
        super().__init__(spec=spec, embed_dim=embed_dim,
                         tokenizer_batch_size=tokenizer_batch_size,
                         inference_batch_size=inference_batch_size,
                         image_batch_size=image_batch_size, check=check,
                         tokenizer=tokenizer)
        self.configuration.update(gap_deg=gap_deg, jitter_deg=jitter_deg, seed=seed,
                                  gap_mix=gap_mix)
        # New difficulty knobs enter the configuration hash only when active:
        # at the defaults (0.0) the embedder is mathematically identical to
        # the pre-knob one, so caches written earlier keep validating.
        if gap_spread_deg:
            self.configuration.update(gap_spread_deg=gap_spread_deg)
        if crowd:
            self.configuration.update(crowd=crowd)
        self.gap_deg = float(gap_deg)
        self.jitter_deg = float(jitter_deg)
        # gap_mix: weight of the GLOBAL gap direction vs a per-class one.
        # 1.0 = purely global (a constant rotation: mean_shift alone fully
        # compensates it); <1.0 mixes in a class-dependent component that a
        # translation cannot undo — the real-CLIP regime where the paper's
        # arm ordering (noise+shift >= noise > shift > none) emerges.
        self.gap_mix = float(gap_mix)
        # Difficulty knobs (they take the testbed off its ceiling):
        # gap_spread_deg: per-class gap MAGNITUDE becomes
        # gap_deg + U(-spread, +spread) (seeded per class) — a radial
        # class-dependence on top of gap_mix's directional one.
        # crowd in [0, 1): prototype crowding — prototypes are drawn as
        # unit(sqrt(1-c^2) * gauss + c * center), giving expected pairwise
        # cosine ~= c^2 instead of ~90-degrees-apart (c=0, the easy regime).
        self.gap_spread_deg = float(gap_spread_deg)
        self.crowd = float(crowd)
        if not 0.0 <= self.crowd < 1.0:
            raise ValueError(f"crowd must be in [0, 1): {crowd}")
        self.seed = int(seed)
        self._proto_center = _unit(_seeded_rng("protocenter", self.seed)
                                   .standard_normal(embed_dim))
        self._explicit_lexicon = dict(lexicon) if lexicon else None
        self._lexicon: Optional[dict[str, str]] = None
        self._lexicon_vocab: Optional[tuple[str, ...]] = None
        self._matcher: Optional[re.Pattern] = None
        self._protos: dict[str, np.ndarray] = {}
        self._gap_dir = _unit(_seeded_rng("gapdir", self.seed).standard_normal(embed_dim))

    # -- lexicon ------------------------------------------------------------

    def _ensure_lexicon(self) -> bool:
        """Lexicon = explicit (CLI vocab variants) else derived from the
        configured target vocab (serving from a checkpoint: noun + noun+'s')."""
        if self._explicit_lexicon is not None:
            if self._lexicon is None:
                self._lexicon = dict(self._explicit_lexicon)
        elif self.target_vocab is not None and self._lexicon_vocab != self.target_vocab:
            self._lexicon = {}
            for noun in self.target_vocab:
                if noun:
                    self._lexicon[noun.lower()] = noun
                    self._lexicon.setdefault(noun.lower() + "s", noun)
            self._lexicon_vocab = self.target_vocab
            self._matcher = None
        if not self._lexicon:
            return False
        if self._matcher is None:
            variants = sorted(self._lexicon, key=len, reverse=True)
            self._matcher = re.compile(
                r"\b(?:" + "|".join(re.escape(v) for v in variants) + r")\b")
        return True

    def prototype(self, noun: str) -> np.ndarray:
        p = self._protos.get(noun)
        if p is None:
            g = _seeded_rng("proto", self.seed, noun).standard_normal(self.embed_dim)
            if self.crowd > 0.0:
                c = self.crowd
                g = np.sqrt(1.0 - c * c) * _unit(g) + c * self._proto_center
            p = _unit(g)
            self._protos[noun] = p
        return p

    def class_gap_deg(self, noun: str) -> float:
        """Per-class gap magnitude: gap_deg +- U(gap_spread_deg)."""
        if self.gap_spread_deg == 0.0:
            return self.gap_deg
        u = float(_seeded_rng("gapmag", self.seed, noun).uniform(-1.0, 1.0))
        return max(self.gap_deg + self.gap_spread_deg * u, 0.0)

    def image_center(self, noun: str) -> np.ndarray:
        """Prototype rotated by the class's gap magnitude toward the class's
        gap direction (gap_mix-weighted blend of the global direction and a
        per-class one) — the noiseless image embedding of the class."""
        direction = self._gap_dir
        if self.gap_mix < 1.0:
            per_class = _unit(_seeded_rng("gapdir", self.seed, noun)
                              .standard_normal(self.embed_dim))
            direction = _unit(self.gap_mix * direction + (1.0 - self.gap_mix) * per_class)
        return _rotate_toward(self.prototype(noun), direction,
                              np.deg2rad(self.class_gap_deg(noun)))

    def _jitter(self, base: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        angle = np.deg2rad(self.jitter_deg) * float(rng.uniform())
        direction = rng.standard_normal(self.embed_dim)
        return _rotate_toward(base, direction, angle).astype(np.float32)

    # -- inference ----------------------------------------------------------

    def _embed_text(self, text: str) -> np.ndarray:
        if self._ensure_lexicon():
            nouns = list(dict.fromkeys(
                self._lexicon[m] for m in self._matcher.findall(text.lower())))
            if nouns:
                base = _unit(np.sum([self.prototype(n) for n in nouns], axis=0))
                return self._jitter(base, _seeded_rng("text", self.seed, text))
        return self._hash_embed(text.encode("utf-8"))

    def inference_text(self, text, max_tokens=None) -> np.ndarray:
        texts = [text] if isinstance(text, str) else list(text)
        return np.stack([self._embed_text(t) for t in texts])

    def inference_tokens(self, tokens_dict: dict) -> np.ndarray:
        # Detokenize back to text so token- and string-based callers agree
        # (the cache writers tokenize; zero-shot embeds strings directly).
        ids = np.asarray(tokens_dict["input_ids"])
        return np.stack([self._embed_text(self.tokenizer.detokenize(row)) for row in ids])

    def inference_image(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images)
        out = np.empty((images.shape[0], self.embed_dim), np.float32)
        for i, px in enumerate(images):
            noun = decode_class_image(px)
            if noun is not None:
                rng = _seeded_rng("img", self.seed,
                                  np.ascontiguousarray(px).tobytes())
                out[i] = self._jitter(self.image_center(noun), rng)
            else:
                out[i] = self._hash_embed(np.ascontiguousarray(px).tobytes())
        return out

    def get_image_transform(self):
        cfg = structured_preprocess_config()

        def transform(images):
            if not isinstance(images, (list, tuple)):
                images = [images]
            return preprocess_pil_host(images, cfg)

        return transform


def parse_structured_spec(spec: str, name: str) -> dict:
    """'<dim>[:gap[:jitter[:seed[:gap_mix[:gap_spread[:crowd]]]]]]' ->
    StructuredEmbedder kwargs."""
    parts = name.split(":")
    if not 1 <= len(parts) <= 7:
        raise ValueError(
            f"Bad test-structured spec "
            f"(dim[:gap[:jitter[:seed[:gap_mix[:gap_spread[:crowd]]]]]]): {spec}")
    kwargs = {"embed_dim": int(parts[0])}
    for i, (key, conv) in enumerate(
            (("gap_deg", float), ("jitter_deg", float), ("seed", int),
             ("gap_mix", float), ("gap_spread_deg", float), ("crowd", float)), start=1):
        if len(parts) > i:
            kwargs[key] = conv(parts[i])
    return kwargs


def write_structured_cls_dataset(root: str, nouns: Sequence[str], n_per_class: int,
                                 split: str = "test", seed: int = 0) -> str:
    """Write a synthetic classification dataset of self-describing class
    images in the Food101 layout (root/food-101/meta/classes.txt +
    {train,test}.json + images/<class>/<i>.jpg), loadable via
    cls_dataset=Food101. Food101 is the one benchmark whose class names come
    from the dataset itself (meta/classes.txt — no cls_class_names_*.json
    override exists for it), so the vocabulary nouns pass through verbatim to
    eval_cls/zero_shot class alignment. The .jpg files contain PNG data
    (PIL dispatches decoding on content, not extension) because JPEG's lossy
    compression would destroy the steganographic class row."""
    import json
    import os

    import PIL.Image

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "food-101")
    os.makedirs(os.path.join(base, "meta"), exist_ok=True)
    for noun in nouns:
        if "_" in noun or "/" in noun or noun != noun.strip() or not noun:
            raise ValueError(f"Class nouns must be clean non-empty words: {noun!r}")
    with open(os.path.join(base, "meta", "classes.txt"), "w") as f:
        f.write("".join(n + "\n" for n in nouns))
    manifest = {}
    for noun in nouns:
        d = os.path.join(base, "images", noun)
        os.makedirs(d, exist_ok=True)
        rels = []
        for i in range(n_per_class):
            img = encode_class_image(noun, rng)
            rel = f"{noun}/{i:05d}"
            PIL.Image.fromarray(img).save(os.path.join(base, "images", rel + ".jpg"),
                                          format="PNG")
            rels.append(rel)
        manifest[noun] = rels
    with open(os.path.join(base, "meta", f"{split}.json"), "w") as f:
        json.dump(manifest, f)
    return root


def make_structured_vocab(num_classes: int, freq: int = 1, seed: int = 0) -> list[dict]:
    """Synthetic underscore-free noun vocabulary entries in the reference
    vocab-JSON schema (SURVEY.md §2.6), pluralized with +'s' so the lexicon
    matches both variants."""
    rng = np.random.default_rng(seed)
    nouns: list[str] = []
    seen = set()
    consonants = "bcdfgklmnprstvz"
    vowels = "aeiou"
    while len(nouns) < num_classes:
        w = "".join(rng.choice(list(consonants)) + rng.choice(list(vowels))
                    for _ in range(3))
        if w not in seen:
            seen.add(w)
            nouns.append(w)
    return [{"id": i, "target_noun": n, "pretty_noun": n.capitalize(),
             "singulars": [n], "plurals": [n + "s"],
             "singulars_freq": [freq], "plurals_freq": [freq], "hypernyms": []}
            for i, n in enumerate(nouns)]


def lexicon_from_vocab_json(vocab_json: Sequence[dict]) -> dict[str, str]:
    """All singular/plural variant strings -> target noun, for text matching."""
    lex: dict[str, str] = {}
    for entry in vocab_json:
        noun = entry["target_noun"]
        for variant in [noun, *entry.get("singulars", ()), *entry.get("plurals", ())]:
            lex.setdefault(variant.lower(), noun)
    return lex
