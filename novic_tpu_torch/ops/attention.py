"""Tower self-attention: the hand-written CUDA kernel and its plain version.

`fused_attention(q, k, v, bias, key_bias)` computes softmax(q·kᵀ/√hd + bias)·v
per (batch, head) with the numerics of the JAX package's Pallas kernel
(novic_tpu/ops/attention.py): q scaled in float32 then rounded to bf16, k and
v rounded to bf16, float32 scores and softmax, the normalised probabilities
rounded to bf16, float32 accumulation of P·v. The bias is either `bias`, one
(S, S) float32 matrix shared by every batch row (the causal mask), or
`key_bias`, a (B, S) float32 row per batch row added to every query row and
head of it (BERT's pad mask, as novic_tpu's ALIGN text tower adds its
(B, 1, 1, S) bias); never both.

* On a CPU tensor it runs `attention_reference`, the plain PyTorch version.
* On a CUDA tensor it launches the kernel in csrc/attention.cu, or raises. It
  never falls back to the plain version.

The kernel (csrc/attention.cu) runs a pre-pass that rounds q * scale, k and
v to bf16 once into a scratch buffer, then a persistent TMA + wgmma kernel
that reads them through the tensor maps `_tma_plans` lays out. q, k and v
must start on 16-byte boundaries (every tower's tensors do); a view that does
not is refused before any launch. The kernel is compiled with nvcc for
sm_90a at first use into build/novic_tpu_torch/ at the root of the checkout
and loaded through ctypes. `LAUNCHES` counts its launches (each runs the
pre-pass and the attention kernel).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from novic_tpu_torch.ops import build as _build
from novic_tpu_torch.ops.attention_bf16 import KV_ROWS, _tma_plan, q_rows

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

SOURCE = _build.CSRC / "attention.cu"
BUILD_DIR = _build.BUILD_DIR
MAX_HD = 128  # the largest hd the kernel takes (a multiple of 8)
_library = _build.Library(SOURCE, {"novic_attention": (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int],
    ctypes.c_int)})


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: q, k, v (B, S, H, hd) float32; bias optional (S, S)
    float32; key_bias optional (B, S) float32.

    Mirrors novic_tpu.ops.attention.xla_attention step for step. bf16 operands
    are held in float32, whose products of bf16 values are exact."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    qb = (q * scale).to(torch.bfloat16).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qb, k.to(torch.bfloat16).float())
    if bias is not None:
        scores = scores + bias
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn.to(torch.bfloat16).float(),
                        v.to(torch.bfloat16).float())


def _tma_plans(scratch: torch.Tensor) -> list[int]:
    """The kernel's tensor maps of the pre-pass's bf16 q, k and v (scratch
    (3, B, S, H, hd), contiguous), 11 values each, as
    `attention_bf16._tma_plan` lays them out: dims (hd, S, H, B), the byte
    strides of S, H and B, a box of one 64-wide atom by the query block (q:
    128 rows where hd <= 64, else 192) or the 64-key tile (k, v)."""
    _, _, S, _, hd = scratch.shape
    return (_tma_plan(scratch[0], S, q_rows(hd)) + _tma_plan(scratch[1], S, KV_ROWS)
            + _tma_plan(scratch[2], S, KV_ROWS))


def _launch(q, k, v, bias, key_bias=None):
    global LAUNCHES
    lib = _library()
    B, S, H, hd = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"fused_attention: {name} must be contiguous float32 on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"fused_attention: {name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} must start on a 16-byte boundary")
    if bias is not None and key_bias is not None:
        raise ValueError("fused_attention: pass bias or key_bias, not both")
    for name, t, shape in (("bias", bias, (S, S)), ("key_bias", key_bias, (B, S))):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                              or t.device != q.device or tuple(t.shape) != shape):
            raise ValueError(f"fused_attention: {name} must be contiguous float32 {shape} "
                             f"on {q.device}")
    bias_ptr = next((t.data_ptr() for t in (bias, key_bias) if t is not None), None)
    if hd > MAX_HD or hd % 8:
        raise ValueError(f"fused_attention: unsupported hd={hd} (a multiple of 8, at most "
                         f"{MAX_HD})")
    out = torch.empty_like(q)
    scratch = torch.empty((3, B, S, H, hd), dtype=torch.bfloat16, device=q.device)
    plan = _build.longs(_tma_plans(scratch))
    _build.launch("fused_attention", q.device, lambda stream: lib.novic_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(), scratch.data_ptr(),
        plan, B, S, H, hd, 1.0 / math.sqrt(hd), stream, int(key_bias is not None)))
    LAUNCHES += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) float32; bias: optional (S, S) additive float32;
    key_bias: optional (B, S) additive float32, per batch row and key (not
    with bias). Returns (B, S, H, hd) float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if bias is not None and key_bias is not None:
        raise ValueError("fused_attention: pass bias or key_bias, not both")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _launch(q, k, v, bias, key_bias)
