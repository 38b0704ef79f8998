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
* On CUDA tensors it launches the kernels in csrc/tiled_matmul.cu, or
  raises. s8, in one call of the library: the transpose kernel
  (`transpose_s8`'s) copies w into a K-major wᵀ (N, K) (8-bit wgmma takes
  no transposed operand), then the port's s8 wgmma engine
  (csrc/int8_wgmma.cuh, K2's Hopper instance) multiplies x by it, storing
  the int32 product by TMA or adding the checksum's block sums by atomics.
  wᵀ is made on every call, never cached: the Pallas kernel reads w on every
  call, and a cache would go stale after an in-place write to w. bf16:
  wgmma in a persistent kernel whose clusters of two blocks share each w
  stage by TMA multicast. float32: exact float32 FMA on the CUDA cores (no
  TF32) in a persistent kernel whose producer warp feeds the FMA warps by
  TMA through an mbarrier ring. Every form reads its
  operands through tensor maps that `_tma_plan` (bf16, float32) or
  `_s8_plan` lays out. It never falls back to the plain version.

The kernels are compiled with nvcc for sm_90a at first use into
build/novic_tpu_torch/ and loaded through ctypes. `LAUNCHES` counts the GEMM's
launches, `INSTANCE_LAUNCHES` the same by instance (one a form), and
`TRANSPOSE_LAUNCHES` the transpose's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from novic_tpu_torch.ops import build as _build

LAUNCHES = 0  # GEMM launches since import (or since a caller reset it)
INSTANCE_LAUNCHES = {"s8_wgmma": 0, "bf16_wgmma": 0, "f32_fma": 0}  # the same, by instance
TRANSPOSE_LAUNCHES = 0  # transpose_s8 launches

SOURCE = _build.CSRC / "tiled_matmul.cu"
_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_INSTANCES = {torch.int8: "s8_wgmma", torch.bfloat16: "bf16_wgmma", torch.float32: "f32_fma"}
_library = _build.Library(SOURCE, {
    "novic_tiled_matmul": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                           ctypes.c_int),
    "novic_transpose_s8": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
                           ctypes.c_int)})


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


def transpose_s8_reference(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the transpose: w (K, N) → wᵀ (N, K), contiguous."""
    return w.t().contiguous()


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


S8_BOX_K, S8_BOX_ROWS = 128, 64  # the s8 engine's x and wᵀ boxes: 128 K bytes by half a tile
S8_OUT_BOX = (32, 16)             # its int32 out box: 32 columns (128 bytes) by a warp's 16 rows


def _s8_plan(x: torch.Tensor, wt: torch.Tensor, bn: Optional[int]) -> list[int]:
    """The s8 engine's tensor maps (K2's Hopper instance, int8_matmul._tma_plan):
    x (M, K) and wᵀ (N, K), both K-major, dims (K, rows), rows K bytes apart,
    a box of 128 K bytes by 64 rows (each block of a 2 x 2 cluster loads half
    of a 128-row tile and multicasts it). Without bn also the int32 out (M, N)
    that the TMA store writes: dims (N, M), rows 4 N bytes apart, a box of 32
    columns by 16 rows, the piece one consumer warp stages. The dims' extents
    zero-fill the ragged edges on load and drop them on store."""
    (M, K), N = x.shape, wt.shape[0]
    plan = [K, M, K, S8_BOX_K, S8_BOX_ROWS, K, N, K, S8_BOX_K, S8_BOX_ROWS]
    return plan if bn else plan + [N, M, 4 * N, *S8_OUT_BOX]


@functools.lru_cache(maxsize=64)
def _plan_arg(values: tuple) -> ctypes.c_void_p:
    """A plan as the library reads it, kept per distinct plan: the probe loops
    call one shape many times, and building the array is a few µs of host
    time a call, which small shapes wait for."""
    return _build.longs(values)


def _launch_transpose(w: torch.Tensor) -> torch.Tensor:
    """Launch the transpose kernel alone on w (K, N), int8, contiguous,
    16-byte aligned, K and N multiples of 16 (the caller checks); return wᵀ."""
    global TRANSPOSE_LAUNCHES
    K, N = w.shape
    wt = torch.empty((N, K), dtype=torch.int8, device=w.device)
    lib = _library()
    _build.launch("transpose_s8", w.device,
                  lambda stream: lib.novic_transpose_s8(w.data_ptr(), wt.data_ptr(), K, N, stream))
    TRANSPOSE_LAUNCHES += 1
    return wt


def _check_layout(fn: str, name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")


def _launch(x: torch.Tensor, w: torch.Tensor, bn: Optional[int]) -> torch.Tensor:
    """One call of the library's entry point: for int8 it launches the
    transpose of w into this call's own wᵀ, then the s8 engine on (x, wᵀ); for
    bf16 and float32 the GEMM on (x, w). A checksum's out is zeroed there."""
    global LAUNCHES, TRANSPOSE_LAUNCHES
    (M, K), N = x.shape, w.shape[1]
    if K % 16 or N % 16:
        raise ValueError(f"tiled_matmul: K={K} and N={N} must be multiples of 16")
    # TMA reads rows whose byte strides are multiples of 16 (K and N multiples
    # of 16 give 16, 32 or 64) from 16-byte aligned bases
    _check_layout("tiled_matmul", "x", x)
    _check_layout("tiled_matmul", "w", w)
    wt = None
    if x.dtype == torch.int8:
        wt = torch.empty((N, K), dtype=torch.int8, device=x.device)
        values = _s8_plan(x, wt, bn)
    else:
        values = _tma_plan(x, w)
    plan = _plan_arg(tuple(values))
    out = torch.empty((M, N // bn) if bn else (M, N), dtype=out_dtype(x.dtype), device=x.device)
    lib = _library()
    _build.launch("tiled_matmul", x.device, lambda stream: lib.novic_tiled_matmul(
        x.data_ptr(), w.data_ptr(), None if wt is None else wt.data_ptr(), plan, out.data_ptr(),
        M, N, K, _KINDS[x.dtype], bn or 0, x.device.index, stream))
    LAUNCHES += 1
    INSTANCE_LAUNCHES[_INSTANCES[x.dtype]] += 1
    if wt is not None:
        TRANSPOSE_LAUNCHES += 1
    # an int8 checksum's int32 sums, cast as the probe's int32 scratch is
    return out.float() if bn else out


def transpose_s8(w: torch.Tensor) -> torch.Tensor:
    """w (K, N) int8 → its transpose (N, K), contiguous: the s8 path's K-major
    copy of w. CPU tensors take the plain version; CUDA tensors launch the
    kernel (w contiguous and 16-byte aligned, K and N multiples of 16)."""
    if w.dim() != 2 or w.dtype != torch.int8:
        raise ValueError(f"transpose_s8: a 2-D int8 w expected, got {w.dtype} {tuple(w.shape)}")
    if w.device.type == "cpu":
        return transpose_s8_reference(w)
    if w.device.type != "cuda":
        raise ValueError(f"transpose_s8: unsupported device {w.device}")
    if w.shape[0] % 16 or w.shape[1] % 16:
        raise ValueError(f"transpose_s8: K={w.shape[0]} and N={w.shape[1]} must be multiples of 16")
    _check_layout("transpose_s8", "w", w)
    return _launch_transpose(w)


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, bn: Optional[int] = None) -> torch.Tensor:
    """x (M, K) · w (K, N), both int8, bfloat16 or float32 → (M, N) int32 or
    float32; with bn, the (M, N / bn) float32 block sums. CPU tensors take
    the plain version; CUDA tensors launch the kernels (for int8 the
    transpose, then the GEMM)."""
    _check(x, w, bn)
    if x.device.type == "cpu":
        return tiled_matmul_reference(x, w, bn)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {x.device}")
    return _launch(x, w, bn)
