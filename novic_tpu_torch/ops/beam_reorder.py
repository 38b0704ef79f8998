"""Beam KV-cache permutation: the hand-written CUDA kernel (X5) and its plain version.

For a cache viewed as (B, H, row) and cand (B, H) int, out[b, i] = x[b, cand[b, i]]:
each of the B samples' H beam candidates takes the token-cache row of the
parent it was chosen from (generate_beam, cache_mode="reorder").

* `beam_reorder(x, cand)` permutes one cache (exp/beam_reorder_kernel.py
  `reorder_pallas`); `beam_reorder_many(xs, cand)` permutes a list of caches of
  one shape and dtype in one launch (`reorder_pallas_many`), the form the
  decode path uses: all 2L token caches of a step.
* On CPU tensors they run `reorder_reference`, the one-hot batched product of
  novic_tpu/models/generate.py (reorder mode). It is exact: each output row has
  one unit coefficient (a -0.0 comes back as +0.0, so compare values).
* On CUDA tensors they launch the kernel in csrc/beam_reorder.cu, or raise. They
  never fall back to the plain version.

The kernel is out of place: candidates repeat, so a row cannot be overwritten
while another candidate still has to read it. Pass `out=` (a second set of
caches) to write into preallocated tensors. It is compiled with nvcc for
sm_90a at first use into build/novic_tpu_torch/ and loaded through ctypes.
`LAUNCHES` counts its launches (one per 64 caches of a call).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

from novic_tpu_torch.ops import build as _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

SOURCE = _build.CSRC / "beam_reorder.cu"
MAX_CACHES_PER_LAUNCH = 64  # kMaxCaches in the source
_lib = None
_lib_lock = threading.Lock()


def reorder_reference(x: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Plain version: the one-hot (B, H, H) product with x viewed as (B, H, row).
    An index outside [0, H) has an all-zero one-hot row (jax.nn.one_hot)."""
    B, H = cand.shape
    onehot = (cand[:, :, None] == torch.arange(H, device=cand.device)).to(x.dtype)
    return torch.bmm(onehot, x.reshape(B, H, -1)).reshape(x.shape)


def build(force: bool = False) -> Path:
    """Compile csrc/beam_reorder.cu into the build directory (if stale); return the .so path."""
    return _build.build(SOURCE, force=force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.novic_beam_reorder.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            lib.novic_beam_reorder.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(xs: Sequence[torch.Tensor], cand: torch.Tensor,
           out: Optional[Sequence[torch.Tensor]]) -> str:
    """Validate the operands; return the device kind ("cpu" or "cuda")."""
    if not xs:
        raise ValueError("beam_reorder: no caches given")
    if cand.dim() != 2 or cand.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"beam_reorder: cand must be a (B, H) int32 or int64 tensor, got "
                         f"{cand.dtype} {tuple(cand.shape)}")
    B, H = cand.shape
    x0 = xs[0]
    for x in xs:
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError("beam_reorder: the caches differ in shape or dtype")
    if B * H == 0 or x0.numel() % (B * H) != 0:
        raise ValueError(f"beam_reorder: a cache of shape {tuple(x0.shape)} cannot be viewed "
                         f"as ({B}, {H}, row)")
    if out is not None:
        if len(out) != len(xs):
            raise ValueError("beam_reorder: out must hold one tensor per cache")
        if any(o.shape != x0.shape or o.dtype != x0.dtype for o in out):
            raise ValueError("beam_reorder: out differs from the caches in shape or dtype")
        src = {x.data_ptr() for x in xs}
        if any(o.data_ptr() in src for o in out):
            raise ValueError("beam_reorder: out must not alias the caches (the kernel is out "
                             "of place)")
    tensors = list(xs) + [cand] + list(out or [])
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"beam_reorder: operands on mixed devices {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"beam_reorder: unsupported device {kind}")
    return kind


def _launch(xs: Sequence[torch.Tensor], cand: torch.Tensor,
            out: Optional[Sequence[torch.Tensor]]) -> list[torch.Tensor]:
    global LAUNCHES
    dev = xs[0].device
    if any(t.device != dev or not t.is_contiguous() for t in list(xs) + [cand] + list(out or [])):
        raise ValueError(f"beam_reorder: every operand must be contiguous on {dev}")
    if out is None:
        out = [torch.empty_like(x) for x in xs]
    n = len(xs)
    rows = cand.numel()
    if xs[0].numel() == 0:
        return list(out)
    lib = _library()
    src = (ctypes.c_void_p * n)(*[x.data_ptr() for x in xs])
    dst = (ctypes.c_void_p * n)(*[o.data_ptr() for o in out])
    row_bytes = xs[0].numel() // rows * xs[0].element_size()
    with torch.cuda.device(dev):
        err = lib.novic_beam_reorder(src, dst, n, cand.data_ptr(), int(cand.dtype == torch.int64),
                                     rows, cand.shape[1], row_bytes,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"beam_reorder kernel launch failed: CUDA error {err}")
    LAUNCHES += -(-n // MAX_CACHES_PER_LAUNCH)
    return list(out)


def beam_reorder_many(xs: Sequence[torch.Tensor], cand: torch.Tensor,
                      out: Optional[Sequence[torch.Tensor]] = None) -> list[torch.Tensor]:
    """Permute every cache in xs (one shape, one dtype) by cand (B, H): one launch
    on CUDA. Writes into `out` (distinct tensors) when given; returns the outputs."""
    xs = list(xs)
    if _check(xs, cand, out) == "cpu":
        ref = [reorder_reference(x, cand) for x in xs]
        if out is None:
            return ref
        for o, r in zip(out, ref):
            o.copy_(r)
        return list(out)
    return _launch(xs, cand, out)


def beam_reorder(x: torch.Tensor, cand: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Permute one cache x, viewed as (B, H, row), by cand (B, H)."""
    return beam_reorder_many([x], cand, None if out is None else [out])[0]
