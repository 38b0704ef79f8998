"""Tiled x·w with w row-major (K, N): the hand-written CUDA kernel that takes
the place of the exp/ int8 probes' Pallas GEMMs (X3), and its plain version.

`tiled_matmul(x, w)` is exp/pallas_int8_matmul.py `make_matmul`'s product:
(M, K)·(K, N) → (M, N), int8 → int32, bfloat16 → float32 or float32 →
float32. `tiled_matmul(x, w, bn=...)` is exp/pallas_int8_rate_pin.py
`make_mm`'s: the same product reduced to the sum of each row over each
bn-wide column block, (M, N / bn) float32 (an int8 product's sums are taken
in int32, wrapping as int32 does, then cast, as the probe's int32 scratch
is). The TPU's bm and bk were VMEM tilings; the kernel picks its own tiles.

* On CPU tensors it runs `tiled_matmul_reference`: int8 as an exact float64
  product cast to int32; bfloat16 as a float32 product of its (exact) float32
  values; float32 as a float32 product.
* On CUDA tensors it launches the kernel in csrc/tiled_matmul.cu, or raises:
  s8 on the tensor cores by mma.sync; bf16 by wgmma in a persistent kernel
  whose clusters of two blocks share each w stage by TMA multicast; float32
  as exact float32 FMA on the CUDA cores (no TF32) in a persistent kernel
  whose producer warp feeds the FMA warps by TMA through an mbarrier ring.
  The bf16 and float32 forms read x and w through tensor maps that
  `_tma_plan` lays out. It never falls back to the plain version.

The kernel is compiled with nvcc for sm_90a at first use into
build/novic_tpu_torch/ and loaded through ctypes. `LAUNCHES` counts its launches.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from novic_tpu_torch.ops import build as _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

SOURCE = _build.CSRC / "tiled_matmul.cu"
_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_lib = None
_lib_lock = threading.Lock()


def out_dtype(in_dtype: torch.dtype) -> torch.dtype:
    """The full product's dtype: int32 for int8 inputs, float32 otherwise."""
    return torch.int32 if in_dtype == torch.int8 else torch.float32


def _checksum(y: torch.Tensor, bn: int) -> torch.Tensor:
    M, N = y.shape
    return y.reshape(M, N // bn, bn).sum(dim=-1)


def tiled_matmul_reference(x: torch.Tensor, w: torch.Tensor, bn: Optional[int] = None) -> torch.Tensor:
    """Plain version (see the module docstring)."""
    if x.dtype == torch.int8:
        y = x.double() @ w.double()  # exact: |acc| <= K * 127^2 < 2^53
        if bn:
            # int32 sums that wrap as the kernel's: exact in float64, then mod 2^32
            return _checksum(y, bn).to(torch.int64).to(torch.int32).float()
        return y.to(torch.int32)
    y = x.float() @ w.float()
    return _checksum(y, bn) if bn else y


def build(force: bool = False) -> Path:
    """Compile csrc/tiled_matmul.cu into the build directory (if stale); return the .so path."""
    return _build.build(SOURCE, force=force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.novic_tiled_matmul.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                               + [ctypes.c_void_p])
            lib.novic_tiled_matmul.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(x: torch.Tensor, w: torch.Tensor, bn: Optional[int]) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"tiled_matmul: x (M, K) and w (K, N) expected, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype not in _KINDS or w.dtype != x.dtype:
        raise ValueError(f"tiled_matmul: x and w must share one of int8, bfloat16, float32, "
                         f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"tiled_matmul: x on {x.device}, w on {w.device}")
    N = w.shape[1]
    if bn is not None and (bn <= 0 or bn % 8 or N % bn):
        raise ValueError(f"tiled_matmul: bn={bn} must be a positive multiple of 8 dividing N={N}")


TMA_ROW = 128  # bytes of a 128-byte swizzled row: a box's innermost extent
BLOCK_M = 128  # the bf16 and float32 kernels' x box rows


def _tma_plan(x: torch.Tensor, w: torch.Tensor) -> list[int]:
    """The bf16 and float32 kernels' tensor maps. A box's innermost extent
    is one 128-byte row, `atom` elements (64 bf16, 32 float32), which is also
    the k of a stage. x (M, K) K-major: dims (K, M), the byte stride of a
    row, box (atom, 128). w (K, N) row-major: dims (N, K), box (atom, atom),
    atom columns by a stage's k-rows; the kernels load 256 / atom (bf16, the
    MN-major wgmma operand) or 128 / atom (float32) of them a stage. The
    dims' extents zero-fill the ragged edges."""
    (M, K), N = x.shape, w.shape[1]
    atom = TMA_ROW // x.element_size()
    return ([K, M, x.stride(0) * x.element_size(), atom, BLOCK_M]
            + [N, K, w.stride(0) * w.element_size(), atom, atom])


def _launch(x: torch.Tensor, w: torch.Tensor, bn: Optional[int]) -> torch.Tensor:
    global LAUNCHES
    (M, K), N = x.shape, w.shape[1]
    if K % 16 or N % 16:
        raise ValueError(f"tiled_matmul: K={K} and N={N} must be multiples of 16")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"tiled_matmul: {name} must be contiguous and 16-byte aligned")
    plan = None
    if x.dtype != torch.int8:
        # TMA reads rows whose byte strides are multiples of 16 (K and N
        # multiples of 16 give 32 or 64) from 16-byte aligned bases
        plan = ctypes.cast((ctypes.c_longlong * 10)(*_tma_plan(x, w)), ctypes.c_void_p)
    if bn:
        # The kernel adds into the checksum: int32 sums for int8, cast after
        out = torch.zeros((M, N // bn), dtype=out_dtype(x.dtype), device=x.device)
    else:
        out = torch.empty((M, N), dtype=out_dtype(x.dtype), device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.novic_tiled_matmul(x.data_ptr(), w.data_ptr(), plan, out.data_ptr(), M, N, K,
                                     _KINDS[x.dtype], bn or 0,
                                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out.float() if bn else out


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, bn: Optional[int] = None) -> torch.Tensor:
    """x (M, K) · w (K, N), both int8, bfloat16 or float32 → (M, N) int32 or
    float32; with bn, the (M, N / bn) float32 block sums. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check(x, w, bn)
    if x.device.type == "cpu":
        return tiled_matmul_reference(x, w, bn)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {x.device}")
    return _launch(x, w, bn)
