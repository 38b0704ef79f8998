"""bf16-input attention in strided layouts: the hand-written CUDA kernel that
takes the place of the exp/ harnesses' Pallas attention (X1 and X2), its plain
version, and those harnesses' wrappers.

`attention_bf16(q, k, v, s_valid, scale, out_dtype)` computes, per (batch,
head), softmax(scale * q·kᵀ over the keys < s_valid)·v with the numerics of
the Pallas bodies of exp/pallas_attn_v2.py and exp/dfn5b_attention.py: bf16
operands, float32 scores (scale applied to them after the product), float32
softmax, the normalised probabilities rounded to bf16, float32 accumulation
of P·v, stored as float32 or bf16. q, k and v are (B, S, H, hd) views with hd
contiguous and any other strides, so the harnesses' layouts are read in
place; the result holds the s_valid queries, (B, s_valid, H, hd).

* On CPU tensors it runs `attention_bf16_reference`, the plain version.
* On CUDA tensors it launches the kernel in csrc/attention_bf16.cu, or raises.
  It never falls back to the plain version. The kernel reads q, k and v by TMA
  through tensor maps that `_tma_plan` lays out (dims, byte strides, box);
  a view a map cannot take (a base or stride not a multiple of 16 bytes) is
  refused before any launch.

The harness wrappers: `fused_attention2` (exp/pallas_attn_v2.py, X1) reads the
(B, S, E) projections in place; `attn_fullseq`, `attn_allheads` and
`attn_direct` (exp/dfn5b_attention.py `make_attn_*`, X2) scale q in its own
dtype, cast to bf16, pad to the harness's sequence length (768 or 736) and, for
fullseq, move to (B*H, 768, hd), as the harness's prep does; each launches the
kernel once. The towers keep K1 (ops/attention.py), as the JAX towers keep
their `fused_attention`.

The kernel is compiled with nvcc for sm_90a at first use into
build/novic_tpu_torch/ and loaded through ctypes. `LAUNCHES` counts its launches.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from novic_tpu_torch.ops import build as _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

SOURCE = _build.CSRC / "attention_bf16.cu"
MAX_HD = 128  # the largest hd the kernel takes (a multiple of 8)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_lib = None
_lib_lock = threading.Lock()


def attention_bf16_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             s_valid: Optional[int] = None, scale: float = 1.0,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: (B, S, H, hd) bf16 → (B, s_valid, H, hd) out_dtype.

    Keys at or past s_valid take no part (the Pallas bodies mask them with
    -1e30, whose exp is 0), so only the first s_valid rows are read. bf16
    operands are held in float32, whose products of bf16 values are exact."""
    s_valid = q.shape[1] if s_valid is None else s_valid
    qf, kf, vf = (t[:, :s_valid].float() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(out_dtype)


def build(force: bool = False) -> Path:
    """Compile csrc/attention_bf16.cu into the build directory (if stale); return the .so path."""
    return _build.build(SOURCE, force=force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.novic_attention_bf16.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                              ctypes.c_void_p])
            lib.novic_attention_bf16.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(q, k, v, s_valid: int, out_dtype: torch.dtype) -> None:
    if q.dim() != 4:
        raise ValueError(f"attention_bf16: q must be (B, S, H, hd), got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"attention_bf16: {name} must be bfloat16 {tuple(q.shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"attention_bf16: {name} must be contiguous along hd")
    if not 1 <= s_valid <= q.shape[1]:
        raise ValueError(f"attention_bf16: s_valid={s_valid} outside [1, {q.shape[1]}]")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"attention_bf16: out_dtype must be float32 or bfloat16, got {out_dtype}")


TMA_ATOM = 64   # bf16 per 128-byte swizzled row: a box's innermost extent
KV_ROWS = 64    # the kernel's key tile


def q_rows(hd: int) -> int:
    """The kernel's query block: 64 rows for each consumer warpgroup, two
    where a row of hd features is one 64-wide atom, else three."""
    return 128 if hd <= TMA_ATOM else 192


def _tma_plan(t: torch.Tensor, s_valid: int, rows: int) -> list[int]:
    """The kernel's tensor map of a (B, S, H, hd) bf16 view: dims (hd, s_valid,
    H, B) innermost first, the byte strides of dims 1-3, and a box of one
    64-wide atom by `rows`. The seq extent s_valid keeps rows past it unread
    and the hd extent zero-fills the atom past hd. A size-1 dimension is never
    stepped; it gets the byte span of the dimensions inside it, since a map's
    strides are positive."""
    B, _, H, hd = t.shape
    dims = [hd, s_valid, H, B]
    es = t.element_size()
    span, strides = hd * es, []
    for n, st in zip(dims[1:], (t.stride(1), t.stride(2), t.stride(0))):
        sb = st * es if n > 1 else span
        strides.append(sb)
        span = max(span, sb * n)
    return dims + strides + [TMA_ATOM, rows, 1, 1]


def _check_map(label: str, t: torch.Tensor, plan: list[int]) -> None:
    """Raise where a tensor map cannot take the view `label` names: TMA reads
    from a 16-byte aligned base with byte strides that are positive multiples
    of 16."""
    strides = plan[4:7]
    if t.data_ptr() % 16 or any(s <= 0 or s % 16 for s in strides):
        raise ValueError(f"{label} must be 16-byte aligned with strides that are multiples of "
                         f"16 bytes, got element strides {tuple(t.stride())}")


def _launch(q, k, v, s_valid: int, scale: float, out_dtype: torch.dtype) -> torch.Tensor:
    global LAUNCHES
    B, _, H, hd = q.shape
    if hd % 8 or hd > MAX_HD:
        raise ValueError(f"attention_bf16: unsupported hd={hd} (a multiple of 8, at most {MAX_HD})")
    plan = []
    for name, t, rows in (("q", q, q_rows(hd)), ("k", k, KV_ROWS), ("v", v, KV_ROWS)):
        p = _tma_plan(t, s_valid, rows)
        _check_map(f"attention_bf16: {name}", t, p)
        plan += p
    lib = _library()
    out = torch.empty((B, s_valid, H, hd), dtype=out_dtype, device=q.device)
    ostrides = [out.stride(0), out.stride(1), out.stride(2)]
    with torch.cuda.device(q.device):
        err = lib.novic_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                       ctypes.cast((ctypes.c_longlong * 33)(*plan),
                                                   ctypes.c_void_p),
                                       ctypes.cast((ctypes.c_longlong * 3)(*ostrides),
                                                   ctypes.c_void_p),
                                       B, H, s_valid, hd, scale, int(out_dtype == torch.bfloat16),
                                       torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_bf16 kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   s_valid: Optional[int] = None, scale: float = 1.0,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) bfloat16 views, hd contiguous; keys and queries at
    or past s_valid (default S) take no part. Returns (B, s_valid, H, hd)
    out_dtype. CPU tensors take the plain version; CUDA tensors launch the kernel."""
    s_valid = q.shape[1] if s_valid is None else int(s_valid)
    _check(q, k, v, s_valid, out_dtype)
    if q.device.type == "cpu":
        return attention_bf16_reference(q, k, v, s_valid, scale, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bf16: unsupported device {q.device}")
    return _launch(q, k, v, s_valid, float(scale), out_dtype)


# -- the harnesses' wrappers ----------------------------------------------------


def fused_attention2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int = 12) -> torch.Tensor:
    """exp/pallas_attn_v2.py `fused_attention2` (X1): q, k, v (B, S, E) bfloat16
    → (B, S, E) float32, scale 1/√hd applied to the float32 scores. The Pallas
    version moves each to head-major (B, H, 256, hd) and pads; the kernel reads
    the (B, S, E) layout in place and masks nothing (every key is valid)."""
    B, S, E = q.shape
    hd = E // heads
    split = lambda t: t.reshape(B, S, heads, hd)  # noqa: E731
    out = attention_bf16(split(q), split(k), split(v), S, 1.0 / math.sqrt(hd), torch.float32)
    return out.reshape(B, S, E)


def _pad_seq(x: torch.Tensor, sp: int) -> torch.Tensor:
    """(B, S, H, hd) zero-padded along S to sp rows."""
    return F.pad(x, (0, 0, 0, 0, 0, sp - x.shape[1]))


def _prescaled(q: torch.Tensor) -> torch.Tensor:
    """The X2 preps' q * SCALE, in q's dtype, then bf16."""
    return (q * (1.0 / math.sqrt(q.shape[-1]))).to(torch.bfloat16)


def _padded_projections(q, k, v, sp: int) -> list[torch.Tensor]:
    """allheads' and direct's prep: scaled q, k and v in bf16, padded to sp rows."""
    return [_pad_seq(x, sp) for x in (_prescaled(q), k.to(torch.bfloat16), v.to(torch.bfloat16))]


def attn_fullseq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 sp: int = 768) -> torch.Tensor:
    """exp/dfn5b_attention.py `make_attn_fullseq()` (X2): q, k, v (B, S, H, hd)
    → (B, S, H, hd) float32. q is scaled, each is cast to bf16, padded to sp
    rows and moved to (B*H, sp, hd) as the harness's prep does; keys past S
    are masked; the output is sliced back to S and to (B, S, H, hd)."""
    B, S, H, hd = q.shape

    def prep(x):  # (B, S, H, hd) -> (B*H, sp, 1, hd) bf16
        return _pad_seq(x.to(torch.bfloat16), sp).transpose(1, 2).reshape(B * H, sp, 1, hd)

    out = attention_bf16(prep(_prescaled(q)), prep(k), prep(v), S, 1.0, torch.float32)
    return out.reshape(B, H, S, hd).transpose(1, 2)


def attn_allheads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sp: int = 736) -> torch.Tensor:
    """exp/dfn5b_attention.py `make_attn_allheads()` (X2): the (B, sp, H, hd)
    projection layout read in place (after the harness's scale, cast and pad),
    the output stored as bf16, then sliced to S and returned as float32."""
    return attention_bf16(*_padded_projections(q, k, v, sp), q.shape[1], 1.0,
                          torch.bfloat16).float()


def attn_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                sp: int = 736) -> torch.Tensor:
    """exp/dfn5b_attention.py `make_attn_direct()` (X2): as `attn_allheads`,
    with the output stored as float32."""
    return attention_bf16(*_padded_projections(q, k, v, sp), q.shape[1], 1.0, torch.float32)
