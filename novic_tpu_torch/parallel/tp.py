"""Tensor parallelism for the CLIP-family towers over torch.distributed
(Megatron-style; the counterpart of novic_tpu.parallel.tp).

The towers keep novic_tpu's leaf names (embedders/vit.py, eva.py), so the
same name tables decide each parameter's layout (torch layout, (out, in)):
  q/k/v proj + MLP fc1 : column-parallel, weight cut on dim 0, bias on dim 0
  out_proj + MLP fc2   : row-parallel, weight cut on dim 1, bias replicated
  embeddings / norms / pooling probe / final projection: replicated

`shard_tower` cuts a loaded tower's parameters to this rank's shards and
hands each block the 'model' axis group. A block then runs attention on
heads/size local heads (K1 on the card), and each row-parallel matmul ends
with one all_reduce(SUM) over the group, after which its replicated bias is
added once. The MAP head is cut by name too, so its cross-attention runs on
local heads and needs a reduce after map_attn's out_proj and another after
map_fc2. EVA02's layer norms over a sharded dim (the SwiGLU hidden state's
mlp_norm, whose params are cut with it, and the sub-LN attn_norm over the
local heads' output, whose params are replicated and sliced at use) all-reduce
their mean and variance (`tp_layer_norm`). Rotary embeddings are per head and
need nothing.

Requirements: heads % size == 0 and mlp_dim % size == 0
(`validate_tp_divisibility`). The ALIGN conv tower and the int8 mode are
refused by TorchEmbedder.set_mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

# Leaf-name -> (column|row|bias_col|replicated) classification, as in novic_tpu.
# fc1_g/fc1_x/mlp_norm cover the EVA02 trunk (embedders/eva.py): SwiGLU's
# inner LN runs over the TP-sharded hidden dim, so its mean and variance are
# all-reduced, one extra all-reduce per block. Fused-qkv checkpoints are split
# into separate q/k/v at conversion, so a column shard never crosses the
# q/k/v boundary.
_COLUMN = ("q_proj_weight", "k_proj_weight", "v_proj_weight", "fc1_weight",
           "map_fc1_weight", "fc1_g_weight", "fc1_x_weight")
_COLUMN_BIAS = ("q_proj_bias", "k_proj_bias", "v_proj_bias", "fc1_bias",
                "map_fc1_bias", "fc1_g_bias", "fc1_x_bias",
                "mlp_norm_weight", "mlp_norm_bias")
_ROW = ("out_proj_weight", "fc2_weight", "map_fc2_weight")

COLUMN, COLUMN_BIAS, ROW, REPLICATED = "column", "column_bias", "row", "replicated"


def tp_param_spec(name: str) -> str:
    """The layout of one tower parameter by its leaf name (the last dotted
    component of a state-dict key): column, column_bias, row or replicated."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _COLUMN:
        return COLUMN
    if leaf in _COLUMN_BIAS:
        return COLUMN_BIAS
    if leaf in _ROW:
        return ROW
    return REPLICATED


def validate_tp_divisibility(vision_cfg=None, text_cfg=None, *, axis_size: int):
    """Heads and MLP hidden dims must split evenly over the model axis."""
    for name, cfg in (("vision", vision_cfg), ("text", text_cfg)):
        if cfg is None:
            continue
        if cfg.heads % axis_size:
            raise ValueError(
                f"{name} tower heads ({cfg.heads}) not divisible by the "
                f"model-axis size ({axis_size})")
        if cfg.mlp_dim % axis_size:
            raise ValueError(
                f"{name} tower mlp_dim ({cfg.mlp_dim}) not divisible by the "
                f"model-axis size ({axis_size})")


def _cut(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"Dim {dim} of a {tuple(t.shape)} parameter does not split "
                         f"over {size} ranks")
    per = t.shape[dim] // size
    return t.narrow(dim, rank * per, per).contiguous()


def shard_tower_state(state_dict: dict, rank: int, size: int) -> dict:
    """This rank's shards of a tower's state dict, cut by name: column weights
    and column biases on dim 0, row weights on dim 1; the rest whole."""
    out = {}
    for name, t in state_dict.items():
        spec = tp_param_spec(name)
        if spec in (COLUMN, COLUMN_BIAS):
            out[name] = _cut(t, 0, rank, size)
        elif spec == ROW:
            out[name] = _cut(t, 1, rank, size)
        else:
            out[name] = t
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class TPGroup:
    """The 'model' axis a tower block reduces over: its process group, this
    rank's index on it, and its size."""

    group: object
    rank: int
    size: int

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a replicated vector over a sharded dim."""
        return _cut(t, 0, self.rank, self.size)


def shard_tower(module: nn.Module, tp: TPGroup) -> nn.Module:
    """Replace a loaded tower's parameters by this rank's shards
    (shard_tower_state) and give every submodule with a `tp` attribute the group."""
    shards = shard_tower_state(dict(module.named_parameters()), tp.rank, tp.size)
    for name, t in shards.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        if tp_param_spec(name) != REPLICATED:
            setattr(owner, leaf, nn.Parameter(t.detach().clone(), requires_grad=False))
    for sub in module.modules():
        if hasattr(sub, "tp"):
            sub.tp = tp
    return module


def tp_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                  tp: TPGroup, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm in float32 over a dim cut over the group: x holds this rank's
    columns, weight and bias its slices; the sums of x and of its squared
    deviations are all-reduced, so mean and variance are those of the whole row."""
    x = x.float()
    full = x.shape[-1] * tp.size
    mean = tp.all_reduce(x.sum(dim=-1, keepdim=True)) / full
    d = x - mean
    var = tp.all_reduce(torch.square(d).sum(dim=-1, keepdim=True)) / full
    return (d * torch.rsqrt(var + eps) * weight + bias).to(out_dtype)


def row_parallel_finish(y: torch.Tensor, bias: Optional[torch.Tensor],
                        tp: Optional[TPGroup]) -> torch.Tensor:
    """A row-parallel matmul's partial product y (bias not added): summed over
    the group, then the replicated bias added once."""
    if tp is not None:
        y = tp.all_reduce(y.contiguous())
    return y if bias is None else y + bias
