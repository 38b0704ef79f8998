"""Parameters between the JAX package's numpy trees and the port's modules.

A flax param tree (after `jax.tree.map(np.asarray, ...)`) or the flat
`params.*` keys of a novic_tpu `.npz` checkpoint hold the same names as the
port's state dicts once flattened with dots, so the bridge is a flatten, a
float32 cast (the FT0 asset stores float16) and a strict `load_state_dict`.
"""

from __future__ import annotations

import numpy as np
import torch

from novic_tpu_torch.embedders.vit import VisionTowerConfig, VisionTransformer
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.prefixed_iter import PrefixedIterDecoder
from novic_tpu_torch.utils.misc import flatten_dict, unflatten_dict


def _state_dict(tree: dict) -> dict[str, torch.Tensor]:
    flat = flatten_dict(tree) if any(isinstance(v, dict) for v in tree.values()) else tree
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy()) for k, v in flat.items()}


def _load(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    module.load_state_dict(_state_dict(tree), strict=True)
    return module.eval()


def vision_tower_from_numpy(cfg: VisionTowerConfig, tree: dict) -> VisionTransformer:
    """VisionTransformer (on the CPU) holding the given param tree."""
    return _load(VisionTransformer(cfg), tree)


def decoder_from_numpy(cfg: DecoderModelConfig, tree: dict) -> PrefixedIterDecoder:
    """PrefixedIterDecoder (on the CPU) holding the given param tree (nested, or
    flat with dotted keys as in a checkpoint's `params.*` entries)."""
    return _load(PrefixedIterDecoder(cfg), tree)


def decoder_to_numpy(module: PrefixedIterDecoder) -> dict:
    """Nested dict of float32 numpy arrays with the JAX package's param names."""
    return unflatten_dict({k: v.detach().cpu().numpy() for k, v in module.state_dict().items()})
