"""One-pass attention with segment ids (X6): the hand-written CUDA kernel that
takes the place of JAX's TPU flash-attention kernel
(jax.experimental.pallas.ops.tpu.flash_attention, which the exp/ harnesses'
`make_attn_flash` and `attn_flash` call), and its plain version.

`flash_attention(q, k, v, segment_ids=None, sm_scale=1.0)` computes what that
kernel's forward pass computes: q (B, H, Sq, hd), k and v (B, H, Skv, hd)
bf16; s = q·kᵀ in float32, times sm_scale; where the segment ids of a query
and a key differ, s gets MASK_VALUE (-0.7 * float32 max) added (finite, so a
query whose keys are all masked gets the mean of v); softmax online over key
blocks with the unnormalised p rounded to bf16 before its product with v;
the result in bf16, (B, H, Sq, hd).

* On CPU tensors it runs `flash_attention_reference`, the plain version, with
  JAX's blocking: online updates over `block_k` keys in JAX's order of
  operations, or JAX's single-step body (p normalised, then rounded) when
  block_k is the kv length. block_k defaults to the kernel's own blocking.
* On CUDA tensors it launches the kernel in csrc/flash_attention.cu, or
  raises; the kernel's online-update block is always its 64-key tile, so
  block_k sets only the plain version's blocking. It never falls back to the
  plain version.

q, k and v may be strided (batch, head, seq) views with hd contiguous; the
kernel reads them in place through tensor maps (TMA) that `_tma_plans` lays
out, and a view a map cannot take (a base or a stride that is not a multiple
of 16 bytes) is refused before any launch. JAX's `ab` (an additive bias) and
`causal` are not called by any caller in the repo and raise
NotImplementedError. The kernel is compiled with nvcc for sm_90a at first use
into build/novic_tpu_torch/ and loaded through ctypes. `LAUNCHES` counts its
launches.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from novic_tpu_torch.ops import build as _build
from novic_tpu_torch.ops.attention_bf16 import _check_map, _tma_plan, q_rows

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

SOURCE = _build.CSRC / "flash_attention.cu"
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # flash_attention.py DEFAULT_MASK_VALUE
KERNEL_BLOCK_K = 64  # the kernel's key tile, over which it updates the softmax online
MAX_HD = 128  # the largest hd the kernel takes (a multiple of 8)
_lib = None
_lib_lock = threading.Lock()


class SegmentIds(NamedTuple):
    """Segment ids of the queries (B, Sq) and of the keys (B, Skv): a query
    attends only to keys of its own segment."""
    q: torch.Tensor
    kv: torch.Tensor


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              segment_ids: Optional[SegmentIds] = None, sm_scale: float = 1.0,
                              block_k: Optional[int] = None) -> torch.Tensor:
    """Plain version, (B, H, Sq, hd) bf16, in JAX's blocking and order of
    operations: per block of block_k keys (the last one may be shorter) the
    online update of `_flash_attention_kernel_single_batch`, with the
    accumulator kept normalised; when block_k is the kv length, the
    single-step body. block_k None is the kernel's blocking: online updates
    over 64 keys, also when there are 64 keys or fewer. bf16 operands are held
    in float32, whose products of bf16 values are exact."""
    qf, kf, vf = q.float(), k.float(), v.float()
    skv = k.shape[2]
    if segment_ids is not None:
        segment_ids = SegmentIds(*segment_ids)
    single_step = block_k == skv
    block_k = KERNEL_BLOCK_K if block_k is None else block_k
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    if segment_ids is not None:
        same = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None, :]
        s = s + torch.where(same, 0.0, MASK_VALUE)
    if single_step:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        return torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf).to(q.dtype)
    m = torch.full(s.shape[:-1] + (1,), -torch.inf, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, device=s.device)
    for k0 in range(0, skv, block_k):
        sb = s[..., k0:k0 + block_k]
        m_next = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)
        o_curr = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                              vf[:, :, k0:k0 + block_k])
        acc = acc + o_curr * inv
        m, l = m_next, l_next
    return acc.to(q.dtype)


def build(force: bool = False) -> Path:
    """Compile csrc/flash_attention.cu into the build directory (if stale); return the .so path."""
    return _build.build(SOURCE, force=force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.novic_flash_attention.argtypes = (
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
            lib.novic_flash_attention.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(q, k, v, segment_ids: Optional[SegmentIds]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be (B, H, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k and v must be ({B}, {H}, Skv, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bfloat16 on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous along hd")
    if segment_ids is not None:
        sq, skv = q.shape[2], k.shape[2]
        for name, t, n in (("q", segment_ids.q, sq), ("kv", segment_ids.kv, skv)):
            if tuple(t.shape) != (B, n) or t.dtype.is_floating_point or t.device != q.device:
                raise ValueError(f"flash_attention: segment_ids.{name} must be integer ({B}, {n}) "
                                 f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _tma_plans(q, k, v) -> list[int]:
    """The kernel's tensor maps of q, k and v, 11 values each: every (B, H, S,
    hd) view is read as its (B, S, H, hd) transpose through
    `attention_bf16._tma_plan`, dims (hd, S, H, B) with the view's byte
    strides, a box of one 64-wide atom by the query block (q) or the 64-key
    tile (k, v). The harnesses' (B, H, Sp, hd) views of their (B, Sp, H, hd)
    projections are so read in place."""
    hd = q.shape[-1]
    plan = []
    for t, rows in ((q, q_rows(hd)), (k, KERNEL_BLOCK_K), (v, KERNEL_BLOCK_K)):
        plan += _tma_plan(t.transpose(1, 2), t.shape[2], rows)
    return plan


def _launch(q, k, v, segment_ids: Optional[SegmentIds], sm_scale: float) -> torch.Tensor:
    global LAUNCHES
    B, H, sq, hd = q.shape
    skv = k.shape[2]
    if hd % 8 or hd > MAX_HD:
        raise ValueError(f"flash_attention: unsupported hd={hd} (a multiple of 8, at most {MAX_HD})")
    plan = _tma_plans(q, k, v)
    for i, (name, t) in enumerate((("q", q), ("k", k), ("v", v))):
        _check_map(f"flash_attention: {name}", t, plan[11 * i:11 * (i + 1)])
    seg_q = seg_kv = None
    if segment_ids is not None:
        # The kernel reads the key ids a 64-key tile at a time: pad to whole tiles
        seg_q, seg_kv = (t.to(torch.int32).contiguous() for t in segment_ids)
        seg_kv = F.pad(seg_kv, (0, -skv % KERNEL_BLOCK_K))
    lib = _library()
    out = torch.empty((B, H, sq, hd), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.novic_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if seg_q is None else seg_q.data_ptr(),
            None if seg_kv is None else seg_kv.data_ptr(),
            ctypes.cast((ctypes.c_longlong * 33)(*plan), ctypes.c_void_p),
            ctypes.cast((ctypes.c_longlong * 3)(*out.stride()[:3]), ctypes.c_void_p),
            B, H, sq, skv, hd, sm_scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ab: Optional[torch.Tensor] = None,
                    segment_ids: Optional[SegmentIds] = None, *, causal: bool = False,
                    sm_scale: float = 1.0, block_k: Optional[int] = None) -> torch.Tensor:
    """q (B, H, Sq, hd), k and v (B, H, Skv, hd) bfloat16 views with hd
    contiguous; segment_ids a SegmentIds (or (q, kv) pair) of integer (B, Sq)
    and (B, Skv) tensors. Returns (B, H, Sq, hd) bfloat16. CPU tensors take
    the plain version in block_k's blocking (default: the kernel's); CUDA
    tensors launch the kernel."""
    if ab is not None or causal:
        raise NotImplementedError("flash_attention: ab and causal are not ported (no caller "
                                  "in the repo passes them)")
    if segment_ids is not None:
        segment_ids = SegmentIds(*segment_ids)
    _check(q, k, v, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, segment_ids, float(sm_scale), block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, segment_ids, float(sm_scale))
