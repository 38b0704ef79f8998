"""Converted tower weights (.npz written by novic_tpu.embedders.convert.save_params_npz)."""

from __future__ import annotations

import numpy as np

from novic_tpu_torch.utils.misc import unflatten_dict


def load_params_npz(path: str) -> tuple[dict, dict]:
    """→ (vision param tree, text param tree) of numpy arrays."""
    with np.load(path) as data:
        flat_v = {k[len("vision."):]: data[k] for k in data.files if k.startswith("vision.")}
        flat_t = {k[len("text."):]: data[k] for k in data.files if k.startswith("text.")}
    return unflatten_dict(flat_v), unflatten_dict(flat_t)
