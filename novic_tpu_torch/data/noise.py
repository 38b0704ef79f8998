"""Unit-sphere embedding noise augmentation (the counterpart of novic_tpu.data.noise).

All five reference schemes (reference embedding_noise.py) and the modality-gap
mean shift. Each scheme is split into
  * a draw: the random tensors it needs, from a torch.Generator on the batch's
    device (no host round trip), and
  * a transform: a pure function of the embeddings and those draws,
so the tests can feed the JAX package's draws into the port's transforms.

Draw layouts, per scheme (B, F the embedding batch shape):
  gausselem:             noise (B,F) standard normal
  gaussvec:              noise (B,F) standard normal, length (B,1) standard normal
  gaussangle:            angle (B,1) radians (clamped Gaussian), direction (B,F) normal
  uniformangle:          angle (B,1) radians (uniform), direction (B,F) normal
  gausselemuniformangle: angle, direction, noise as above, mix (B,1) bool
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

SCHEMES = ("gausselem", "gaussvec", "gaussangle", "uniformangle", "gausselemuniformangle")


def _renorm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _normal(shape, like: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=like.dtype, device=like.device)


def _uniform(shape, like: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)


def gauss_elem(embed: torch.Tensor, noise: torch.Tensor, *, vec_norm: float) -> torch.Tensor:
    """Add iid N(0, (vec_norm/sqrt(F))^2) per element, renormalise (ref embedding_noise.py:59-75)."""
    elem_std = vec_norm / math.sqrt(embed.shape[-1])
    if elem_std <= 0:
        raise ValueError(f"Element noise standard deviation must be positive: {elem_std:.3g}")
    return _renorm(embed + elem_std * noise)


def gauss_vec(embed: torch.Tensor, noise: torch.Tensor, length: torch.Tensor, *,
              vec_norm: float) -> torch.Tensor:
    """Add a random-direction vector with N(0, vec_norm) length (ref embedding_noise.py:78-95)."""
    if vec_norm <= 0:
        raise ValueError(f"Vector noise norm must be positive: {vec_norm:.3g}")
    return _renorm(embed + _renorm(noise) * length * vec_norm)


def angle_rotate(embed: torch.Tensor, direction: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate each unit embedding by `angle` toward a random orthogonal direction
    (ref embedding_noise.py:98-112)."""
    dot = (embed * direction).sum(dim=-1, keepdim=True)
    ortho = _renorm(direction - embed * dot)
    return _renorm(embed * torch.cos(angle) + ortho * torch.sin(angle))


@dataclasses.dataclass(frozen=True)
class EmbeddingNoise:
    """Factory matching the reference's config surface (ref embedding_noise.py:17-42)."""

    scheme: str
    vec_norm: float = 0.0
    angle_min: float = 0.0
    angle_max: float = 0.0
    angle_std: float = 0.0
    mix_ratio: float = 0.0

    @staticmethod
    def create(scheme: str, *, embed_dim: int = 0, vec_norm: float = 0.0, angle_min: float = 0.0,
               angle_max: float = 0.0, angle_std: float = 0.0, mix_ratio: float = 0.0
               ) -> Optional["EmbeddingNoise"]:
        if not scheme:
            return None
        canon = scheme.lower()
        if canon not in SCHEMES:
            raise ValueError(f"Embedding noise scheme not recognised: {scheme}")
        return EmbeddingNoise(scheme=canon, vec_norm=vec_norm, angle_min=angle_min,
                              angle_max=angle_max, angle_std=angle_std, mix_ratio=mix_ratio)

    def validate(self) -> None:
        s = self.scheme
        if s in ("gaussangle",) and (self.angle_std <= 0 or self.angle_max <= 0):
            raise ValueError("Angular noise std and max must both be positive")
        if s in ("uniformangle", "gausselemuniformangle") and self.angle_min > self.angle_max:
            raise ValueError("Minimum angular noise must be smaller than maximum angular noise")
        if s == "gausselemuniformangle" and not 0 <= self.mix_ratio <= 1:
            raise ValueError(f"Mix ratio must be in [0, 1]: {self.mix_ratio:.3g}")

    def draw(self, embed: torch.Tensor, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The random tensors of this scheme for `embed`, on embed's device."""
        self.validate()
        B1 = embed.shape[:-1] + (1,)
        s = self.scheme
        draws: dict[str, torch.Tensor] = {}
        if s == "gaussvec":
            draws["noise"] = _normal(embed.shape, embed, generator)
            draws["length"] = _normal(B1, embed, generator)
        if s == "gaussangle":
            std, mx = math.radians(self.angle_std), math.radians(self.angle_max)
            draws["angle"] = (std * _normal(B1, embed, generator)).clamp(-mx, mx)
            draws["direction"] = _normal(embed.shape, embed, generator)
        if s in ("uniformangle", "gausselemuniformangle"):
            lo, hi = math.radians(self.angle_min), math.radians(self.angle_max)
            draws["angle"] = lo + (hi - lo) * _uniform(B1, embed, generator)
            draws["direction"] = _normal(embed.shape, embed, generator)
        if s in ("gausselem", "gausselemuniformangle"):
            draws["noise"] = _normal(embed.shape, embed, generator)
        if s == "gausselemuniformangle":
            draws["mix"] = _uniform(B1, embed, generator) < self.mix_ratio
        return draws

    def transform(self, embed: torch.Tensor, draws: dict[str, torch.Tensor]) -> torch.Tensor:
        """Noised unit embeddings: a pure function of embed and the draws."""
        s = self.scheme
        if s == "gausselem":
            return gauss_elem(embed, draws["noise"], vec_norm=self.vec_norm)
        if s == "gaussvec":
            return gauss_vec(embed, draws["noise"], draws["length"], vec_norm=self.vec_norm)
        if s in ("gaussangle", "uniformangle"):
            return angle_rotate(embed, draws["direction"], draws["angle"])
        if s == "gausselemuniformangle":
            e_angle = angle_rotate(embed, draws["direction"], draws["angle"])
            e_elem = gauss_elem(embed, draws["noise"], vec_norm=self.vec_norm)
            return torch.where(draws["mix"], e_angle, e_elem)
        raise ValueError(f"Unsupported embedding noise type: {s}")

    def __call__(self, embed: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.transform(embed, self.draw(embed, generator))


def apply_mean_shift(embed: torch.Tensor, mean_shift: Optional[torch.Tensor]) -> torch.Tensor:
    """Add the measured image-minus-text modality-gap mean and renormalise
    (ref train.py:1263-1265)."""
    if mean_shift is None:
        return embed
    return _renorm(embed + mean_shift)
