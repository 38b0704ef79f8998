"""Decoder checkpoints: the native .npz format of novic_tpu.train.checkpoint.

One .npz holds the flattened `params.*` arrays, the optimizer state as `opt.*`
arrays in the leaf order of the JAX package's optax state (bridge.py
converts torch AdamW state to and from it), and a `__meta__` JSON entry
(format novic_tpu.checkpoint.v1). Either package reads what the other writes.
The orbax directory format and the reference torch pickles are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.text.target import TargetConfig
from novic_tpu_torch.utils.logger import log
from novic_tpu_torch.utils.misc import flatten_dict, unflatten_dict


def save_checkpoint(
    path: str,
    *,
    params: dict,
    cfg_flat: dict,
    model_config: DecoderModelConfig,
    target_config: TargetConfig,
    data_config: dict,
    target_nouns: tuple,
    num_invalid_target_nouns: int,
    opt_state_arrays: Optional[list] = None,
    train_meta: Optional[dict] = None,
):
    """Write a native .npz checkpoint atomically (a temporary file, then a rename).

    params: nested or dotted-flat dict of numpy arrays; opt_state_arrays: the
    optax leaf list (bridge.adamw_state_to_leaves)."""
    flat = flatten_dict(params) if any(isinstance(v, dict) for v in params.values()) else params
    arrays = {f"params.{k}": np.asarray(v) for k, v in flat.items()}
    if opt_state_arrays is not None:
        arrays.update({f"opt.{i:05d}": np.asarray(v) for i, v in enumerate(opt_state_arrays)})
    meta = {
        "format": "novic_tpu.checkpoint.v1",
        "cfg_flat": cfg_flat,
        "model_config": model_config.as_dict(),
        "target_config": target_config.as_jsonable(),
        "data_config": data_config,
        "target_nouns": list(target_nouns),
        "num_invalid_target_nouns": num_invalid_target_nouns,
        "train_meta": train_meta or {},
        "saved_unix_time": time.time(),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)  # atomic commit
    log.info(f"Saved checkpoint: {path}")


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
