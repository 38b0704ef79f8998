"""Parameters and optimizer state between the JAX package's numpy trees and
the port's modules.

A flax param tree (after `jax.tree.map(np.asarray, ...)`) or the flat
`params.*` keys of a novic_tpu `.npz` checkpoint hold the same names as the
port's state dicts once flattened with dots, so the param bridge is a flatten,
a float32 cast and a strict `load_state_dict`. The FT0 asset stores float16:
its values are exact in float32, and the decoder's `float16_params` flag
rounds the decode steps as JAX computes with them (models/prefixed_iter.py).
The DFN5B attention harness's params (a list of per-layer dicts, the same keys
in exp/dfn5b_attention.py and novic_tpu_torch/exp/dfn5b_attention.py) cross
as float32 arrays and tensors.

The optimizer bridge converts torch AdamW state (per parameter: step,
exp_avg, exp_avg_sq) to and from the leaf list of the JAX package's
`optax.inject_hyperparams(optax.adamw)` state, in its tree-flatten order:

  count, b1, b2, eps, eps_root, learning_rate, mask, weight_decay,
  mask schedule count, adam count, mu (one per param), nu (one per param)

with the params in flax order (nested dict keys sorted at every level). Both
packages write and read `opt.*` checkpoint arrays in that order, so a
checkpoint from either resumes in the other. AdamP (train/optim.py; per
parameter mu and nu, one count) maps onto `inject_hyperparams(adamp)`'s
leaves the same way. A reference torch checkpoint's AdamW moments load by
parameter name (adamw_state_from_reference).
"""

from __future__ import annotations

import numpy as np
import torch

from novic_tpu_torch.embedders.align import (
    AlignTextConfig,
    AlignVisionConfig,
    BertTextTower,
    EfficientNetTower,
)
from novic_tpu_torch.embedders.eva import EvaVisionConfig, EvaVisionTransformer
from novic_tpu_torch.embedders.vit import (
    TextTowerConfig,
    TextTransformer,
    VisionTowerConfig,
    VisionTransformer,
)
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.prefixed_iter import PrefixedIterDecoder
from novic_tpu_torch.train.optim import AdamP
from novic_tpu_torch.utils.misc import flatten_dict, unflatten_dict


def _state_dict(tree: dict) -> dict[str, torch.Tensor]:
    flat = flatten_dict(tree) if any(isinstance(v, dict) for v in tree.values()) else tree
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy()) for k, v in flat.items()}


def load_tree(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Load a param tree (nested, or flat with dotted keys) into `module`, strictly."""
    module.load_state_dict(_state_dict(tree), strict=True)
    return module.eval()


def vision_tower_from_numpy(cfg: VisionTowerConfig, tree: dict) -> VisionTransformer:
    """VisionTransformer (on the CPU) holding the given param tree."""
    return load_tree(VisionTransformer(cfg), tree)


def text_tower_from_numpy(cfg: TextTowerConfig, tree: dict) -> TextTransformer:
    """TextTransformer (on the CPU) holding the given param tree."""
    return load_tree(TextTransformer(cfg), tree)


def eva_tower_from_numpy(cfg: EvaVisionConfig, tree: dict) -> EvaVisionTransformer:
    """EvaVisionTransformer (on the CPU) holding the given param tree."""
    return load_tree(EvaVisionTransformer(cfg), tree)


def align_vision_from_numpy(cfg: AlignVisionConfig, tree: dict) -> EfficientNetTower:
    """EfficientNetTower (on the CPU) holding the given param tree."""
    return load_tree(EfficientNetTower(cfg), tree)


def bert_text_from_numpy(cfg: AlignTextConfig, tree: dict) -> BertTextTower:
    """BertTextTower (on the CPU) holding the given (flat) param tree."""
    return load_tree(BertTextTower(cfg), tree)


def harness_params_from_numpy(layers: list[dict], device="cpu") -> list[dict[str, torch.Tensor]]:
    """exp/dfn5b_attention.py's params (one dict of arrays per layer, the same
    keys in novic_tpu_torch.exp.dfn5b_attention) as float32 tensors on `device`."""
    return [{k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy()).to(device)
             for k, v in layer.items()} for layer in layers]


def harness_params_to_numpy(layers: list[dict]) -> list[dict[str, np.ndarray]]:
    """The port harness's params as float32 numpy dicts (the JAX harness's form)."""
    return [{k: v.detach().cpu().numpy().astype(np.float32) for k, v in layer.items()}
            for layer in layers]


def decoder_from_numpy(cfg: DecoderModelConfig, tree: dict) -> PrefixedIterDecoder:
    """PrefixedIterDecoder (on the CPU) holding the given param tree (nested, or
    flat with dotted keys as in a checkpoint's `params.*` entries). When every
    array is float16 (the FT0 asset), `float16_params` makes the decode steps
    round where the JAX decoder computing with those arrays rounds; a tree
    that mixes float16 and float32 is served in float32."""
    model = load_tree(PrefixedIterDecoder(cfg), tree)
    flat = flatten_dict(tree) if any(isinstance(v, dict) for v in tree.values()) else tree
    model.float16_params = all(np.asarray(v).dtype == np.float16 for v in flat.values())
    return model


def decoder_to_numpy(module: PrefixedIterDecoder) -> dict:
    """Nested dict of float32 numpy arrays with the JAX package's param names."""
    return unflatten_dict({k: v.detach().cpu().numpy() for k, v in module.state_dict().items()})


ADAMW_HEAD = 10  # leaves before the moments
ADAMP_HEAD = 9


def flax_order(names) -> list[str]:
    """Dotted param names in the order jax.tree.leaves visits the nested dict."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def _f32(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def _moment(optimizer, p, key) -> np.ndarray:
    st = optimizer.state.get(p, {})
    if key in st:
        return st[key].detach().cpu().numpy().astype(np.float32)
    return np.zeros(tuple(p.shape), np.float32)


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _counts(step: int, first: dict) -> tuple[np.ndarray, np.ndarray]:
    """(inject_hyperparams' count, the inner count). A state grafted from a
    reference checkpoint starts the first at 0 while the second holds the
    reference's step, as the JAX package grafts it; `count_offset` keeps that
    difference through later steps."""
    inner = np.asarray(step, dtype=np.int32)
    return np.asarray(step - first.get("count_offset", 0), dtype=np.int32), inner


def adamw_state_to_leaves(model: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                          weight_decay_1d: bool) -> list[np.ndarray]:
    """Torch AdamW state → the optax leaf list (see the module docstring). The
    mask leaf is what the JAX package's inject_hyperparams evaluates its mask
    callable to: weight_decay_1d."""
    named = dict(model.named_parameters())
    order = flax_order(named)
    first = optimizer.param_groups[0]
    b1, b2 = first["betas"]
    wd = first.get("weight_decay_hparam", first["weight_decay"])
    states = [optimizer.state.get(named[n], {}) for n in order]
    step = int(max((float(st["step"]) for st in states if "step" in st), default=0))
    outer, inner = _counts(step, first)
    head = [outer, _f32(b1), _f32(b2), _f32(first["eps"]), _f32(0.0), _f32(first["lr"]),
            np.asarray(bool(weight_decay_1d)), _f32(wd), outer.copy(), inner]
    return (head + [_moment(optimizer, named[n], "exp_avg") for n in order]
            + [_moment(optimizer, named[n], "exp_avg_sq") for n in order])


def _check_moments(name: str, p: torch.Tensor, m, v):
    if tuple(np.shape(m)) != tuple(p.shape) or tuple(np.shape(v)) != tuple(p.shape):
        raise ValueError(f"Optimizer moment shape mismatch for {name}: {np.shape(m)} "
                         f"vs {tuple(p.shape)}")


def _set_adamw(model, optimizer, mu: dict, nu: dict, step: int, count_offset: int):
    for name, p in model.named_parameters():
        m, v = mu[name], nu[name]
        _check_moments(name, p, m, v)
        optimizer.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": _tensor(m, p.device),
            "exp_avg_sq": _tensor(v, p.device),
        }
    optimizer.param_groups[0]["count_offset"] = count_offset


def adamw_state_from_leaves(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                            leaves: list) -> int:
    """Load an optax leaf list into torch AdamW state; return the step count."""
    order = flax_order(dict(model.named_parameters()))
    if len(leaves) != ADAMW_HEAD + 2 * len(order):
        raise ValueError(f"Optimizer state has {len(leaves)} arrays; AdamW over "
                         f"{len(order)} params needs {ADAMW_HEAD + 2 * len(order)}")
    step = int(np.asarray(leaves[ADAMW_HEAD - 1]))
    mu = dict(zip(order, leaves[ADAMW_HEAD:ADAMW_HEAD + len(order)]))
    nu = dict(zip(order, leaves[ADAMW_HEAD + len(order):]))
    _set_adamw(model, optimizer, mu, nu, step, step - int(np.asarray(leaves[0])))
    optimizer.param_groups[0]["lr"] = float(np.asarray(leaves[5]))
    return step


def adamw_state_from_reference(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                               moments: dict) -> int:
    """Load a reference checkpoint's AdamW moments ({"step", "mu", "nu"} param
    trees, train.checkpoint.reference_adamw_moments) into torch AdamW state by
    parameter name; return the step. adamw_state_to_leaves then gives the leaf
    list of the JAX package's grafted state (its hyperparameter count at 0)."""
    mu, nu = flatten_dict(moments["mu"]), flatten_dict(moments["nu"])
    named = dict(model.named_parameters())
    if set(mu) != set(named) or set(nu) != set(named):
        raise ValueError(f"Reference moments name {sorted(set(mu) ^ set(named))[:3]} "
                         f"unlike the model's parameters")
    step = int(moments["step"])
    _set_adamw(model, optimizer, mu, nu, step, step)
    return step


def adamw_moments(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """Torch AdamW state → {"step", "mu", "nu"} param trees (the form
    train.checkpoint.save_reference_checkpoint writes into a .train)."""
    named = dict(model.named_parameters())
    steps = [float(st["step"]) for st in optimizer.state.values() if "step" in st]
    return {"step": int(max(steps, default=0)),
            "mu": unflatten_dict({n: _moment(optimizer, p, "exp_avg") for n, p in named.items()}),
            "nu": unflatten_dict({n: _moment(optimizer, p, "exp_avg_sq")
                                  for n, p in named.items()})}


def adamp_state_to_leaves(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> list:
    """train.optim.AdamP state → the leaf list of the JAX package's
    `optax.inject_hyperparams(adamp)` state: count, b1, b2, delta, eps,
    learning_rate, wd_ratio, weight_decay, then the inner {count, mu, nu}."""
    named = dict(model.named_parameters())
    order = flax_order(named)
    g = optimizer.param_groups[0]
    outer, inner = _counts(int(g["count"]), g)
    head = [outer, _f32(g["betas"][0]), _f32(g["betas"][1]), _f32(g["delta"]), _f32(g["eps"]),
            _f32(g["lr"]), _f32(g["wd_ratio"]), _f32(g["weight_decay"]), inner]
    return (head + [_moment(optimizer, named[n], "mu") for n in order]
            + [_moment(optimizer, named[n], "nu") for n in order])


def adamp_state_from_leaves(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                            leaves: list) -> int:
    """Load the JAX package's AdamP leaf list into train.optim.AdamP; return the count."""
    named = dict(model.named_parameters())
    order = flax_order(named)
    if len(leaves) != ADAMP_HEAD + 2 * len(order):
        raise ValueError(f"Optimizer state has {len(leaves)} arrays; AdamP over "
                         f"{len(order)} params needs {ADAMP_HEAD + 2 * len(order)}")
    count = int(np.asarray(leaves[ADAMP_HEAD - 1]))
    mu = leaves[ADAMP_HEAD:ADAMP_HEAD + len(order)]
    nu = leaves[ADAMP_HEAD + len(order):]
    for name, m, v in zip(order, mu, nu):
        p = named[name]
        _check_moments(name, p, m, v)
        optimizer.state[p] = {"mu": _tensor(m, p.device), "nu": _tensor(v, p.device)}
    g = optimizer.param_groups[0]
    g["count"], g["count_offset"] = count, count - int(np.asarray(leaves[0]))
    g["lr"] = float(np.asarray(leaves[5]))
    return count


def opt_state_to_leaves(model: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                        weight_decay_1d: bool) -> list:
    """The optax leaf list of either optimizer (what a .npz checkpoint stores)."""
    if isinstance(optimizer, AdamP):
        return adamp_state_to_leaves(model, optimizer)
    return adamw_state_to_leaves(model, optimizer, weight_decay_1d=weight_decay_1d)


def opt_state_from_leaves(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          leaves: list) -> int:
    """Load a .npz checkpoint's optax leaf list into either optimizer; return the step."""
    if isinstance(optimizer, AdamP):
        return adamp_state_from_leaves(model, optimizer, leaves)
    return adamw_state_from_leaves(model, optimizer, leaves)
