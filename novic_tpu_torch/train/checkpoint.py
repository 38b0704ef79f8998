"""Decoder checkpoints: the native .npz format of novic_tpu.train.checkpoint and
the reference's torch pickles.

Native: one .npz holds the flattened `params.*` arrays, the optimizer state as
`opt.*` arrays in the leaf order of the JAX package's optax state (bridge.py
converts the port's optimizer state to and from it), and a `__meta__` JSON
entry (format novic_tpu.checkpoint.v1). Either package reads what the other
writes.

Orbax: a directory as `orbax.checkpoint.StandardCheckpointer` writes it (the
tree {"params": ..., "opt": [leaves]}), with the same metadata in its
novic_meta.json. The port reads and writes it with its own zarr v2, OCDBT and
zstd code (orbax_format.py, ocdbt.py, zstd.py): either package reads what the
other writes.

Reference (reference train.py:1450-1473): a torch.save'd flat dict with keys
cfg_flat, target_config, data_config, model_state_dict, target_nouns,
num_invalid_target_nouns (+ train-only: train_loop_config, train_loop_state,
optimizer_type, optimizer_state_dict, ...), named
outputs/ovod_<stamp>/ovod_chunk####_<stamp>.{train|model}. It is read with
PyTorch's restricted unpickler (`torch.load(weights_only=True)`), then audited
against the class set the reference pickles (ref utils.py:484-537): anything
else is refused with pickle.UnpicklingError, never retried another way. The
state-dict names map onto the port's parameter names below; every value is
read as float32.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import time
from typing import Any, Optional

import numpy as np
import torch

from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.text.target import TargetConfig
from novic_tpu_torch.train import orbax_format
from novic_tpu_torch.train.loop import TrainLoopState
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
    optax leaf list (bridge.opt_state_to_leaves)."""
    arrays = {f"params.{k}": np.asarray(v) for k, v in _flat(params).items()}
    if opt_state_arrays is not None:
        arrays.update({f"opt.{i:05d}": np.asarray(v) for i, v in enumerate(opt_state_arrays)})
    meta = _meta(cfg_flat, model_config, target_config, data_config, target_nouns,
                 num_invalid_target_nouns, train_meta)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)  # atomic commit
    log.info(f"Saved checkpoint: {path}")


def _flat(params: dict) -> dict:
    """A nested or dotted-flat param dict, dotted-flat."""
    return flatten_dict(params) if any(isinstance(v, dict) for v in params.values()) else params


def _meta(cfg_flat, model_config, target_config, data_config, target_nouns,
          num_invalid_target_nouns, train_meta) -> dict:
    return {
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


def load_checkpoint(path: str) -> dict:
    """Load a native checkpoint (.npz file or orbax directory) → dict with params
    (nested numpy tree), the optimizer leaves and meta."""
    if os.path.isdir(path):
        return load_checkpoint_orbax(path)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("format") != "novic_tpu.checkpoint.v1":
            raise ValueError(f"Unsupported checkpoint format in {path}")
        params_flat = {k[len("params."):]: data[k] for k in data.files if k.startswith("params.")}
        opt_leaves = [data[k] for k in sorted(k for k in data.files if k.startswith("opt."))] or None
    return _loaded(meta, unflatten_dict(params_flat), opt_leaves)


# ---------------------------------------------------------------------------
# Orbax directories
# ---------------------------------------------------------------------------

_ORBAX_META = "novic_meta.json"


def save_checkpoint_orbax(path: str, *, params: dict, cfg_flat: dict,
                          model_config: DecoderModelConfig, target_config: TargetConfig,
                          data_config: dict, target_nouns: tuple,
                          num_invalid_target_nouns: int,
                          opt_state_arrays: Optional[list] = None,
                          train_meta: Optional[dict] = None):
    """Write an orbax directory checkpoint (the .npz format's schema): the tree
    {"params": nested params, "opt": the optax leaf list} and novic_meta.json,
    written under a temporary name and renamed into place."""
    tree = {"params": unflatten_dict({k: np.asarray(v) for k, v in _flat(params).items()})}
    if opt_state_arrays is not None:
        tree["opt"] = [np.asarray(v) for v in opt_state_arrays]
    meta = _meta(cfg_flat, model_config, target_config, data_config, target_nouns,
                 num_invalid_target_nouns, train_meta)
    orbax_format.write_tree(path, tree, {_ORBAX_META: json.dumps(meta).encode()})
    log.info(f"Saved orbax checkpoint: {path}")


def load_checkpoint_orbax(path: str) -> dict:
    with open(os.path.join(path, _ORBAX_META)) as f:
        meta = json.load(f)
    if meta.get("format") != "novic_tpu.checkpoint.v1":
        raise ValueError(f"Unsupported checkpoint format in {path}")
    tree = orbax_format.read_tree(path)
    return _loaded(meta, tree["params"], tree.get("opt"))


def _loaded(meta: dict, params: dict, opt_leaves: Optional[list]) -> dict:
    return {
        "meta": meta,
        "params": params,
        "opt_arrays": opt_leaves,
        "model_config": DecoderModelConfig.from_dict(meta["model_config"]),
        "target_config": TargetConfig.from_jsonable(meta["target_config"]),
        "target_nouns": tuple(meta["target_nouns"]),
        "num_invalid_target_nouns": meta["num_invalid_target_nouns"],
        "cfg_flat": meta["cfg_flat"],
        "data_config": meta["data_config"],
        "train_meta": meta["train_meta"],
    }


# ---------------------------------------------------------------------------
# Reference state-dict names ↔ the port's parameter names
# ---------------------------------------------------------------------------

# Per transformer layer: reference name → ours
_LAYER_KEYS = {
    "self_attn.in_proj_weight": "self_attn_in_proj_weight",
    "self_attn.in_proj_bias": "self_attn_in_proj_bias",
    "self_attn.out_proj.weight": "self_attn_out_proj_weight",
    "self_attn.out_proj.bias": "self_attn_out_proj_bias",
    "linear1.weight": "linear1_weight",
    "linear1.bias": "linear1_bias",
    "linear2.weight": "linear2_weight",
    "linear2.bias": "linear2_bias",
    "norm1.weight": "norm1_weight",
    "norm1.bias": "norm1_bias",
    "norm2.weight": "norm2_weight",
    "norm2.bias": "norm2_bias",
    "scale1": "scale1",
    "scale2": "scale2",
}
_LAYER_KEYS_INV = {v: k for k, v in _LAYER_KEYS.items()}
_TOP_KEYS = {
    "logits_linear.weight": "logits_weight",
    "logits_linear.bias": "logits_bias",
    "token_embedding.weight": "token_embedding",
    "pos_embedding.embedding.weight": "pos_embedding",
    "transformer.norm.weight": "transformer.norm_weight",
    "transformer.norm.bias": "transformer.norm_bias",
}
_TOP_KEYS_INV = {v: k for k, v in _TOP_KEYS.items()}


def _mlp_indices(cfg: DecoderModelConfig) -> dict[str, int]:
    """The embedding MLP's nn.Sequential index of each linear/norm: [linear1,
    (norm), activation, linear2, (dropout)] with a hidden layer, else [linear1]."""
    if cfg.mlp_hidden_layer == "none":
        return {"linear1": 0}
    if cfg.mlp_hidden_norm:
        return {"linear1": 0, "norm": 1, "linear2": 3}
    return {"linear1": 0, "linear2": 2}


def _torch_key_to_ours(key: str, cfg: DecoderModelConfig) -> Optional[str]:
    if key == "causality_mask":
        return None  # constant buffer, rebuilt from config
    if key in _TOP_KEYS:
        return _TOP_KEYS[key]
    if key.startswith("embed_mlp.mlp."):
        idx, _, leaf = key[len("embed_mlp.mlp."):].partition(".")
        names = {i: n for n, i in _mlp_indices(cfg).items()}
        if int(idx) not in names:
            raise ValueError(f"Unexpected MLP sequential index in checkpoint key: {key}")
        return f"embed_mlp.{names[int(idx)]}_{leaf}"
    if key.startswith("transformer.layers."):
        layer, _, sub = key[len("transformer.layers."):].partition(".")
        if sub not in _LAYER_KEYS:
            raise ValueError(f"Unknown transformer-layer checkpoint key: {key}")
        return f"transformer.layers_{layer}.{_LAYER_KEYS[sub]}"
    raise ValueError(f"Unknown checkpoint key: {key}")


def _ours_to_torch_key(path: str, cfg: DecoderModelConfig) -> str:
    if path in _TOP_KEYS_INV:
        return _TOP_KEYS_INV[path]
    if path.startswith("embed_mlp."):
        name, _, leaf = path[len("embed_mlp."):].rpartition("_")
        return f"embed_mlp.mlp.{_mlp_indices(cfg)[name]}.{leaf}"
    if path.startswith("transformer.layers_"):
        layer, _, sub = path[len("transformer.layers_"):].partition(".")
        return f"transformer.layers.{layer}.{_LAYER_KEYS_INV[sub]}"
    raise ValueError(f"Unknown param path: {path}")


def _to_numpy(value) -> np.ndarray:
    """A tensor (bf16 widened to float32, exactly) or array → numpy."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def torch_state_dict_to_params(state_dict: dict[str, Any], cfg: DecoderModelConfig) -> dict:
    """Reference PrefixedIterDecoder state dict → the port's nested param tree
    (float32 numpy; the causality_mask buffer is dropped)."""
    flat = {}
    for key, value in state_dict.items():
        ours = _torch_key_to_ours(key, cfg)
        if ours is not None:
            flat[ours] = _to_numpy(value).astype(np.float32)
    return unflatten_dict(flat)


def _causality_mask(cfg: DecoderModelConfig) -> np.ndarray:
    """The reference's persistent causal-mask buffer (ref embedding_decoder.py:
    651-654): -inf above the diagonal over max_seq_len, the prefix block
    unmasked unless strictly_causal."""
    L = cfg.mlp_seq_len + cfg.token_length - 1
    mask = np.triu(np.full((L, L), -np.inf, dtype=np.float32), k=1)
    if not cfg.strictly_causal:
        mask[:cfg.mlp_seq_len, :cfg.mlp_seq_len] = 0.0
    return mask


def params_to_torch_state_dict(params: dict, cfg: DecoderModelConfig) -> dict:
    """The port's param tree (nested or dotted-flat) → reference state-dict names
    (numpy values), with the causality_mask buffer a strict load requires."""
    flat = flatten_dict(params) if any(isinstance(v, dict) for v in params.values()) else params
    out = {_ours_to_torch_key(path, cfg): np.asarray(arr) for path, arr in flat.items()}
    out["causality_mask"] = _causality_mask(cfg)
    return out


# ---------------------------------------------------------------------------
# Reading and writing reference checkpoints
# ---------------------------------------------------------------------------

# What the reference pickles (ref utils.py:484-537, TorchSaveClasses); the
# JAX package's restricted unpickler admits the same set
_AUDITED = (dict, collections.OrderedDict, list, tuple, set, frozenset, bytearray, bytes,
            str, int, float, complex, bool, type(None), torch.Tensor, torch.dtype)


def _audit(obj, where: str = "checkpoint"):
    """Refuse any object outside the audited class set (exact types, so a dict
    subclass such as collections.Counter is refused)."""
    kind = type(obj)
    if kind not in _AUDITED:
        raise pickle.UnpicklingError(
            f"Refusing to unpickle {kind.__module__}.{kind.__qualname__} at {where} (not in "
            f"the reference's TorchSaveClasses audit, ref utils.py:484-537)")
    if isinstance(obj, dict):
        for k, v in obj.items():
            _audit(k, where)
            _audit(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            _audit(v, where)


def read_reference_pickle(path: str) -> dict:
    """torch.load(weights_only=True) of a reference checkpoint, audited. A
    refusal raises pickle.UnpicklingError; nothing is retried another way."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    _audit(ckpt)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a reference checkpoint dict")
    return ckpt


def load_reference_checkpoint(path: str) -> dict:
    """Load a reference ovod_*.train/.model torch checkpoint → the dict
    load_checkpoint returns: params (float32 tree), model_config,
    target_config, target_nouns, cfg_flat, train_meta (the loop state of a
    .train) and `opt_moments` ({"step", "mu", "nu"} trees of the AdamW
    moments, or None), which bridge.adamw_state_from_reference loads."""
    ckpt = read_reference_pickle(path)
    cfg_flat = dict(ckpt["cfg_flat"])

    tc_json = {}
    for k, v in dict(ckpt["target_config"]).items():
        if isinstance(v, torch.Tensor):
            v = v.numpy().tolist()
        elif isinstance(v, torch.dtype):
            v = str(v)
        tc_json[k] = v
    target_config = TargetConfig.from_jsonable(tc_json)

    sd = ckpt["model_state_dict"]
    model_config = DecoderModelConfig.from_dict(
        {k: cfg_flat[k] for k in DecoderModelConfig.__dataclass_fields__ if k in cfg_flat},
        embed_dim=int(cfg_flat.get("embed_dim", 0) or next(
            v.shape[1] for k, v in sd.items() if k.startswith("embed_mlp.mlp.0.weight"))),
        vocab_size=target_config.vocab_size,
        token_length=target_config.token_length,
    )
    params = torch_state_dict_to_params(sd, model_config)

    # .train checkpoints carry the loop state (ref train.py:948-974); the
    # intersecting fields resume training
    train_meta = {}
    ref_loop = ckpt.get("train_loop_state")
    if isinstance(ref_loop, dict):
        fields = set(TrainLoopState.__dataclass_fields__)
        loop_state = {k: (v.item() if hasattr(v, "item") else v)
                      for k, v in ref_loop.items() if k in fields}
        if loop_state:
            train_meta["loop_state"] = loop_state

    return {
        "params": params,
        "model_config": model_config,
        "target_config": target_config,
        "target_nouns": tuple(ckpt["target_nouns"]),
        "num_invalid_target_nouns": int(ckpt.get("num_invalid_target_nouns", 0)),
        "cfg_flat": cfg_flat,
        "data_config": ckpt.get("data_config"),
        "train_meta": train_meta,
        "opt_arrays": None,
        "opt_moments": reference_adamw_moments(ckpt, model_config, cfg_flat),
    }


def _reference_param_order(state_dict: dict, cfg_flat: dict) -> list[str]:
    """State-dict keys in the reference optimizer's position order."""
    keys = [k for k in state_dict if k != "causality_mask"]
    if bool(cfg_flat.get("weight_decay_1d", False)):
        return keys
    ndim = {k: len(state_dict[k].shape) for k in keys}
    return [k for k in keys if ndim[k] < 2] + [k for k in keys if ndim[k] >= 2]


def reference_adamw_moments(ckpt: dict, model_config: DecoderModelConfig,
                            cfg_flat: dict) -> Optional[dict]:
    """The reference's torch-AdamW moments → {"step", "mu", "nu"} param trees
    under the port's names, or None (logged) where the optimizer restarts.

    Torch indexes optimizer state by global position across its param groups;
    the reference builds them as [1-D no-decay params, N-D decay params], each
    in parameters() order (= state-dict order minus buffers, ref
    train.py:1103-1116), or one group in that order when weight_decay_1d. Each
    position is named through that order, so the moments land by name."""
    opt_sd = ckpt.get("optimizer_state_dict")
    if not isinstance(opt_sd, dict) or not opt_sd.get("state"):
        return None
    opt_type = str(ckpt.get("optimizer_type", "AdamW"))
    if "AdamW" not in opt_type:
        log.warning(f"Reference optimizer {opt_type} is not AdamW => optimizer restarts")
        return None

    ordered = _reference_param_order(ckpt["model_state_dict"], cfg_flat)
    state = opt_sd["state"]
    if len(state) != len(ordered):
        log.warning(f"Reference optimizer state covers {len(state)}/{len(ordered)} params "
                    f"=> optimizer restarts")
        return None
    mu_sd, nu_sd = {}, {}
    step = 0
    try:
        for idx, st in state.items():
            key = ordered[int(idx)]
            mu_sd[key], nu_sd[key] = st["exp_avg"], st["exp_avg_sq"]
            s = st.get("step", 0)
            step = max(step, int(s.item() if hasattr(s, "item") else s))
        mu = torch_state_dict_to_params(mu_sd, model_config)
        nu = torch_state_dict_to_params(nu_sd, model_config)
    except (KeyError, IndexError, ValueError, TypeError) as e:
        log.warning(f"Could not convert reference optimizer state ({e}) => optimizer restarts")
        return None
    log.info(f"Converted reference AdamW optimizer state: {len(state)} param moments "
             f"at step {step}")
    return {"step": step, "mu": mu, "nu": nu}


def _reference_optimizer_state_dict(state_dict: dict, opt_moments: dict,
                                   model_config: DecoderModelConfig, cfg_flat: dict,
                                   lr: float = 0.0) -> dict:
    """{"step", "mu", "nu"} moment trees → a torch AdamW state_dict in the
    reference's layout: positions over the groups [1-D no-decay, N-D decay] (one
    group if weight_decay_1d), ordered as `state_dict` (reference names) lists
    them; reference_adamw_moments reads it back."""
    mu = flatten_dict(opt_moments["mu"])
    nu = flatten_dict(opt_moments["nu"])
    step = torch.tensor(float(opt_moments["step"]))
    order = _reference_param_order(state_dict, cfg_flat)
    ours = {k: _torch_key_to_ours(k, model_config) for k in order}
    state = {i: {"step": step.clone(),
                 "exp_avg": torch.from_numpy(np.asarray(mu[ours[k]], np.float32).copy()),
                 "exp_avg_sq": torch.from_numpy(np.asarray(nu[ours[k]], np.float32).copy())}
             for i, k in enumerate(order)}
    group = dict(lr=float(lr), betas=(float(cfg_flat.get("beta1", 0.9)),
                                      float(cfg_flat.get("beta2", 0.95))),
                 eps=1e-8, amsgrad=False, maximize=False, foreach=None, capturable=False,
                 differentiable=False, fused=None)
    wd = float(cfg_flat.get("weight_decay", 0.1))
    if bool(cfg_flat.get("weight_decay_1d", False)):
        groups = [{**group, "weight_decay": wd, "params": list(range(len(order)))}]
    else:
        n1 = sum(len(state_dict[k].shape) < 2 for k in order)
        groups = [{**group, "weight_decay": 0.0, "params": list(range(n1))},
                  {**group, "weight_decay": wd, "params": list(range(n1, len(order)))}]
    return {"state": state, "param_groups": groups}


def save_reference_checkpoint(path: str, *, params: dict, model_config: DecoderModelConfig,
                              target_config: TargetConfig, target_nouns: tuple,
                              num_invalid_target_nouns: int, cfg_flat: dict,
                              data_config: Optional[dict] = None,
                              loop_state: Optional[dict] = None,
                              opt_moments: Optional[dict] = None):
    """Write a reference-schema torch checkpoint: a .model (what the reference's
    infer.py consumes), or with `loop_state` and `opt_moments` ({"step", "mu",
    "nu"}, as reference_adamw_moments returns them) a .train that resumes."""
    sd_np = params_to_torch_state_dict(params, model_config)
    state_dict = {k: torch.from_numpy(np.array(v)) for k, v in sd_np.items()}
    # As dataclasses.asdict(model.target_config) in ref train.py:1445-1457: the
    # token/mask dtypes are torch.dtype objects and the compact maps tensors
    # (ref infer.py:695 and embedders.py use them as such)
    tc = target_config.as_jsonable()
    tc["token_dtype"] = getattr(torch, tc["token_dtype"])
    tc["mask_dtype"] = getattr(torch, tc["mask_dtype"])
    for key in ("compact_map", "compact_unmap"):
        if tc[key] is not None:
            tc[key] = torch.tensor(tc[key], dtype=tc["token_dtype"])
    ckpt = {
        "cfg_flat": dict(cfg_flat),
        "target_config": tc,
        "data_config": data_config,
        "model_state_dict": state_dict,
        "target_nouns": tuple(target_nouns),
        "num_invalid_target_nouns": num_invalid_target_nouns,
    }
    if loop_state is not None:
        ckpt["train_loop_state"] = dict(loop_state)
    if opt_moments is not None:
        ckpt["optimizer_type"] = "torch.optim.AdamW"
        ckpt["optimizer_state_dict"] = _reference_optimizer_state_dict(
            sd_np, opt_moments, model_config, cfg_flat)
    torch.save(ckpt, path)
    log.info(f"Saved reference-format checkpoint: {path}")


def checkpoint_dir_and_name(output_dir: str, chunk_id: int, stamp: Optional[str] = None,
                            kind: str = "train") -> str:
    """outputs/ovod_<stamp>/ovod_chunk####_<stamp>.<kind> (ref train.py:1459-1463)."""
    stamp = stamp or time.strftime("%Y%m%d_%H%M%S")
    run_dir = os.path.join(output_dir, f"ovod_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    return os.path.join(run_dir, f"ovod_chunk{chunk_id:04d}_{stamp}.{kind}")
