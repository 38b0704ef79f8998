"""Image preprocessing: resize, crop and normalise to (B, S, S, 3) float32.

`preprocess_pil_host` is the counterpart of novic_tpu.embedders.preprocess's
PIL path. `preprocess_frames` does the same for uint8 frames already at the
squash size (where PIL's resize is the identity) on any torch device, with
the same float32 operations in the same order, so the result is bit-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    size: int = 224
    resize_mode: str = "shortest"  # shortest (resize shorter side + center crop) | squash (resize to SxS)
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD
    interpolation: str = "bicubic"  # bicubic | bilinear | nearest
    # squash mode only: resize to resize_size² first, then center crop to size²
    # (0 means resize directly to size²)
    resize_size: int = 0


def _is_final_size_rgb(img, cfg: PreprocessConfig) -> bool:
    """True for a uint8 (S, S, 3) array that squash mode would hand to PIL's
    resize unchanged (PIL returns a copy when the size already matches)."""
    return (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.shape == (cfg.size, cfg.size, 3) and cfg.resize_mode == "squash"
            and cfg.resize_size in (0, cfg.size))


def preprocess_pil_host(images: Sequence, cfg: PreprocessConfig) -> np.ndarray:
    """PIL-exact preprocessing (resize, center crop, normalise). Returns
    (B, S, S, 3) float32. uint8 arrays already at the squash size skip PIL,
    whose resize is the identity for them; PIL is imported only when needed."""
    S = cfg.size
    out = np.empty((len(images), S, S, 3), dtype=np.float32)
    for i, img in enumerate(images):
        if _is_final_size_rgb(img, cfg):
            out[i] = img.astype(np.float32) / 255.0
            continue
        import PIL.Image

        resample = {"bicubic": PIL.Image.Resampling.BICUBIC,
                    "bilinear": PIL.Image.Resampling.BILINEAR,
                    "nearest": PIL.Image.Resampling.NEAREST}[cfg.interpolation]
        if not isinstance(img, PIL.Image.Image):
            img = PIL.Image.fromarray(np.asarray(img))
        img = img.convert("RGB")
        if cfg.resize_mode == "squash":
            R = cfg.resize_size or S
            img = img.resize((R, R), resample)
            if R != S:
                off = (R - S) // 2
                img = img.crop((off, off, off + S, off + S))
        else:
            w, h = img.size
            # Long side via truncation (int(), not round())
            if h <= w:
                new_h, new_w = S, max(int(w * S / h), S)
            else:
                new_h, new_w = max(int(h * S / w), S), S
            img = img.resize((new_w, new_h), resample)
            left = (new_w - S) // 2
            top = (new_h - S) // 2
            img = img.crop((left, top, left + S, top + S))
        out[i] = np.asarray(img, dtype=np.float32) / 255.0
    mean = np.asarray(cfg.mean, dtype=np.float32)
    std = np.asarray(cfg.std, dtype=np.float32)
    return (out - mean) / std


def is_final_size_batch(images: Sequence, cfg: PreprocessConfig) -> bool:
    """True when every image is a uint8 (S, S, 3) array that needs no resize."""
    return len(images) > 0 and all(_is_final_size_rgb(img, cfg) for img in images)


def preprocess_frames(frames: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """uint8 (B, S, S, 3) frames at the squash size → normalised float32 on the
    frames' device: (x / 255 - mean) / std, as preprocess_pil_host computes it."""
    if frames.dtype != torch.uint8 or tuple(frames.shape[1:]) != (cfg.size, cfg.size, 3):
        raise ValueError(f"Expected uint8 (B, {cfg.size}, {cfg.size}, 3) frames, "
                         f"got {frames.dtype} {tuple(frames.shape)}")
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=frames.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=frames.device)
    return (frames.float() / 255.0 - mean) / std


def load_images(paths: Sequence[str]) -> list:
    import PIL.Image

    return [PIL.Image.open(p).convert("RGB") for p in paths]
