"""Embedder: the frozen dual-encoder abstraction (the counterpart of
novic_tpu.embedders.base), image side.

'TYPE:NAME' factory, lazy model load/unload, target-config management,
unit-norm float32 image embeddings. The towers are PyTorch modules on an
explicit device (CUDA by default). Embeddings come back as numpy float32 unit
vectors, as in the JAX package. Configuration hashing and the text side wait
for the slices that use them.

Also provides the 'test:<dim>' embedder, whose BLAKE2-derived vectors are
byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.preprocess import (
    PreprocessConfig,
    is_final_size_batch,
    preprocess_frames,
    preprocess_pil_host,
)
from novic_tpu_torch.embedders.registry import EmbedderArch, lookup
from novic_tpu_torch.text.simple import SimpleWordTokenizer
from novic_tpu_torch.text.target import TargetConfig, TargetTokenizer
from novic_tpu_torch.text.tokenizer import TextTokenizer
from novic_tpu_torch.utils.logger import log


class Embedder:
    """Frozen dual-encoder wrapper; see module docstring."""

    @staticmethod
    def create(
        spec: str,                          # 'TYPE:NAME' (openai:/openclip:/transformers:/test:)
        *,
        load_model: bool = True,
        check: bool = False,
        weights_path: Optional[str] = None,    # converted .npz tower weights
        tokenizer: Optional[TextTokenizer] = None,  # explicit override (tests/benches)
        compute_dtype: str = "bfloat16",
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ) -> "Embedder":
        if ":" not in spec:
            raise ValueError(f"Embedder spec must be of the format 'TYPE:NAME': {spec}")
        kind, name = spec.split(":", maxsplit=1)
        if kind == "test":
            return HashEmbedder(spec=spec, embed_dim=int(name), check=check, tokenizer=tokenizer)
        if kind not in ("openai", "openclip", "transformers"):
            raise ValueError(f"Unsupported embedder type: {kind}")
        return TorchEmbedder(spec=spec, arch=lookup(spec), load_model=load_model, check=check, weights_path=weights_path, tokenizer=tokenizer,
                             compute_dtype=compute_dtype, seed=seed, device=device)

    def __init__(self, *, spec: str, tokenizer: TextTokenizer, embed_dim: int, check: bool):
        self.spec = spec
        self.tokenizer = tokenizer
        self.embed_dim = embed_dim
        self.check = check
        self.target_tokenizer: Optional[TargetTokenizer] = None
        self.target_vocab: Optional[tuple[str, ...]] = None
        log.info(f"Created embedder {spec}: dim {embed_dim}, "
                 f"context {tokenizer.context_length}, vocab {tokenizer.vocab_size}")

    # -- target config ------------------------------------------------------------

    def configure_target(self, target_config: TargetConfig, target_vocab: Sequence[str]):
        self.target_tokenizer = TargetTokenizer(self.tokenizer, target_config, check=self.check)
        self.target_vocab = tuple(target_vocab)

    # -- inference ---------------------------------------------------------------

    def load_model(self) -> bool:
        raise NotImplementedError

    def unload_model(self) -> bool:
        raise NotImplementedError

    def is_model_loaded(self) -> bool:
        raise NotImplementedError

    def inference_image(self, images: np.ndarray) -> np.ndarray:
        """Preprocessed (B,S,S,3) float32 images → unit-norm float32 embeddings."""
        raise NotImplementedError

    def get_image_transform(self) -> Callable:
        raise NotImplementedError


class TorchEmbedder(Embedder):
    """PyTorch towers for a registered CLIP-family architecture (the
    counterpart of JaxEmbedder). Only the vision tower is ported so far."""

    def __init__(self, *, spec: str, arch: EmbedderArch, load_model: bool, check: bool,
                 weights_path: Optional[str], tokenizer: Optional[TextTokenizer],
                 compute_dtype: str, seed: int, device: Union[str, torch.device] = "cuda"):
        if compute_dtype != arch.vision.compute_dtype:
            arch = dataclasses.replace(
                arch, vision=dataclasses.replace(arch.vision, compute_dtype=compute_dtype),
                text=dataclasses.replace(arch.text, compute_dtype=compute_dtype))
        self.arch = arch
        self.device = resolve(device)
        self.weights_path = weights_path
        self.seed = seed
        self._vision = None
        if tokenizer is None:
            log.warning("No tokenizer given => word-level test tokenizer (the BPE/"
                        "SentencePiece tokenizers are not ported yet)")
            tokenizer = SimpleWordTokenizer(words=(), context_length=arch.text.context_length)
        super().__init__(spec=spec, tokenizer=tokenizer, embed_dim=arch.vision.embed_dim,
                         check=check)
        if load_model:
            self.load_model()

    # -- model lifecycle ---------------------------------------------------------

    def load_model(self) -> bool:
        if self._vision is not None:
            return False
        from novic_tpu_torch.embedders.vit import VisionTransformer

        if self.weights_path:
            from novic_tpu_torch.bridge import vision_tower_from_numpy
            from novic_tpu_torch.embedders.convert import load_params_npz

            vision_params, _ = load_params_npz(self.weights_path)
            model = vision_tower_from_numpy(self.arch.vision, vision_params)
            log.info(f"Loaded converted tower weights: {self.weights_path}")
        else:
            model = VisionTransformer(self.arch.vision).init_random(
                torch.Generator().manual_seed(self.seed))
            log.warning("No tower weights provided => using random initialization "
                        "(perf benchmarking / testing only)")
        self._vision = model.to(self.device).eval()
        return True

    def unload_model(self) -> bool:
        if self._vision is None:
            return False
        self._vision = None
        log.info("Unloaded embedder towers")
        return True

    def is_model_loaded(self) -> bool:
        return self._vision is not None

    # -- inference ---------------------------------------------------------------

    def embed_image_tensor(self, images: torch.Tensor) -> torch.Tensor:
        """(B,S,S,3) float32 tensor on the embedder's device → (B,F) unit-norm."""
        if self._vision is None:
            raise RuntimeError("Embedder towers not loaded")
        with torch.inference_mode():
            out = self._vision(images)
            return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    def inference_image(self, images: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
        """Preprocessed (B,S,S,3) float32 images (numpy, or a tensor from
        get_image_transform) → unit-norm float32 embeddings (numpy)."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        return self.embed_image_tensor(images.to(self.device)).cpu().numpy()

    def get_image_transform(self) -> Callable:
        """images → (B,S,S,3) float32 tensor on the embedder's device. uint8
        frames already at the squash size are copied as uint8 and normalised
        on the device (bit-identical to the host path); others go through PIL."""
        cfg = self.arch.preprocess

        def transform(images):
            if not isinstance(images, (list, tuple)):
                images = [images]
            if is_final_size_batch(images, cfg):
                frames = torch.from_numpy(np.stack(images)).to(self.device)
                return preprocess_frames(frames, cfg)
            return torch.from_numpy(preprocess_pil_host(images, cfg)).to(self.device)

        return transform


class HashEmbedder(Embedder):
    """Deterministic test embedder ('test:<dim>'): unit vectors derived from a
    BLAKE2 hash of the text / image bytes (the same bytes as the JAX package's)."""

    def __init__(self, *, spec: str, embed_dim: int, check: bool = False, tokenizer=None):
        tok = tokenizer if tokenizer is not None else SimpleWordTokenizer(words=(), context_length=77)
        super().__init__(spec=spec, tokenizer=tok, embed_dim=embed_dim, check=check)
        self._loaded = True

    def load_model(self) -> bool:
        was = self._loaded
        self._loaded = True
        return not was

    def unload_model(self) -> bool:
        was = self._loaded
        self._loaded = False
        return was

    def is_model_loaded(self) -> bool:
        return self._loaded

    def _hash_embed(self, data: bytes) -> np.ndarray:
        seed = int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(self.embed_dim,)).astype(np.float32)
        return v / np.linalg.norm(v)

    def inference_text(self, text, max_tokens=None) -> np.ndarray:
        texts = [text] if isinstance(text, str) else list(text)
        return np.stack([self._hash_embed(t.encode("utf-8")) for t in texts])

    def inference_image(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images)
        return np.stack([self._hash_embed(np.ascontiguousarray(img).tobytes())
                         for img in images])

    def get_image_transform(self) -> Callable:
        cfg = PreprocessConfig(size=32)

        def transform(images):
            if not isinstance(images, (list, tuple)):
                images = [images]
            return preprocess_pil_host(images, cfg)

        return transform
