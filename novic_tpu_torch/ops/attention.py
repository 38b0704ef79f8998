"""Tower self-attention: the hand-written CUDA kernel and its plain version.

`fused_attention(q, k, v, bias)` computes softmax(q·kᵀ/√hd + bias)·v per
(batch, head) with the numerics of the JAX package's Pallas kernel
(novic_tpu/ops/attention.py): q scaled in float32 then rounded to bf16, k and
v rounded to bf16, float32 scores and softmax, the normalised probabilities
rounded to bf16, float32 accumulation of P·v.

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
import threading
from pathlib import Path
from typing import Optional

import torch

from novic_tpu_torch.ops import build as _build
from novic_tpu_torch.ops.attention_bf16 import KV_ROWS, _tma_plan, q_rows

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

SOURCE = _build.CSRC / "attention.cu"
BUILD_DIR = _build.BUILD_DIR
MAX_HD = 128  # the largest hd the kernel takes (a multiple of 8)
_lib = None
_lib_lock = threading.Lock()


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: q, k, v (B, S, H, hd) float32; bias optional (S, S) float32.

    Mirrors novic_tpu.ops.attention.xla_attention step for step. bf16 operands
    are held in float32, whose products of bf16 values are exact."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    qb = (q * scale).to(torch.bfloat16).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qb, k.to(torch.bfloat16).float())
    if bias is not None:
        scores = scores + bias
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn.to(torch.bfloat16).float(),
                        v.to(torch.bfloat16).float())


def build(force: bool = False) -> Path:
    """Compile csrc/attention.cu into the build directory (if stale); return the .so path."""
    return _build.build(SOURCE, force=force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.novic_attention.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
            lib.novic_attention.restype = ctypes.c_int
            _lib = lib
    return _lib


def _tma_plans(scratch: torch.Tensor) -> list[int]:
    """The kernel's tensor maps of the pre-pass's bf16 q, k and v (scratch
    (3, B, S, H, hd), contiguous), 11 values each, as
    `attention_bf16._tma_plan` lays them out: dims (hd, S, H, B), the byte
    strides of S, H and B, a box of one 64-wide atom by the query block (q:
    128 rows where hd <= 64, else 192) or the 64-key tile (k, v)."""
    _, _, S, _, hd = scratch.shape
    return (_tma_plan(scratch[0], S, q_rows(hd)) + _tma_plan(scratch[1], S, KV_ROWS)
            + _tma_plan(scratch[2], S, KV_ROWS))


def _launch(q, k, v, bias):
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
    if bias is not None:
        if (bias.dtype != torch.float32 or not bias.is_contiguous() or bias.device != q.device
                or tuple(bias.shape) != (S, S)):
            raise ValueError(f"fused_attention: bias must be contiguous float32 ({S}, {S}) "
                             f"on {q.device}")
    if hd > MAX_HD or hd % 8:
        raise ValueError(f"fused_attention: unsupported hd={hd} (a multiple of 8, at most "
                         f"{MAX_HD})")
    out = torch.empty_like(q)
    scratch = torch.empty((3, B, S, H, hd), dtype=torch.bfloat16, device=q.device)
    plan = ctypes.cast((ctypes.c_longlong * 33)(*_tma_plans(scratch)), ctypes.c_void_p)
    with torch.cuda.device(q.device):
        err = lib.novic_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr() if bias is not None else None, out.data_ptr(),
                                  scratch.data_ptr(), plan, B, S, H, hd, 1.0 / math.sqrt(hd),
                                  torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) float32; bias: optional (S, S) additive float32.
    Returns (B, S, H, hd) float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _launch(q, k, v, bias)
