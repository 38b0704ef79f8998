"""Decoder checkpoints: the native .npz format of novic_tpu.train.checkpoint.

One .npz holds the flattened `params.*` arrays plus a `__meta__` JSON entry
(format novic_tpu.checkpoint.v1). The orbax directory format and the reference
torch pickles are not ported yet.
"""

from __future__ import annotations

import json
import os

import numpy as np

from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.text.target import TargetConfig
from novic_tpu_torch.utils.misc import unflatten_dict


def load_checkpoint(path: str) -> dict:
    """Load a native .npz checkpoint → dict with params (nested numpy tree) and meta."""
    if os.path.isdir(path):
        raise NotImplementedError("Orbax directory checkpoints are not ported yet")
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("format") != "novic_tpu.checkpoint.v1":
            raise ValueError(f"Unsupported checkpoint format in {path}")
        params_flat = {k[len("params."):]: data[k] for k in data.files if k.startswith("params.")}
        opt_leaves = [data[k] for k in sorted(k for k in data.files if k.startswith("opt."))] or None
    return {
        "meta": meta,
        "params": unflatten_dict(params_flat),
        "opt_arrays": opt_leaves,
        "model_config": DecoderModelConfig.from_dict(meta["model_config"]),
        "target_config": TargetConfig.from_jsonable(meta["target_config"]),
        "target_nouns": tuple(meta["target_nouns"]),
        "num_invalid_target_nouns": meta["num_invalid_target_nouns"],
        "cfg_flat": meta["cfg_flat"],
        "data_config": meta["data_config"],
        "train_meta": meta["train_meta"],
    }


def load_reference_checkpoint(path: str) -> dict:
    raise NotImplementedError("Reference torch checkpoints are not ported yet (.npz only)")
