"""W8A8 int8 dense: the hand-written s8 tensor-core GEMM (K2) and its plain version.

The counterpart of novic_tpu/ops/int8_matmul.py. The scheme is the JAX
package's: per-output-channel weight scales (`quantize_weight`), dynamic
per-row activation scales (`quantize_rows`), both symmetric, rounded half to
even and clipped to +-127 with a 1e-12 scale floor; an int8 x int8 -> int32
product; a float32 dequant y = ((float)acc * sx) * sw + b.

* `int8_matmul(xq, wq)` is K2's own function: (M, K) int8 times the torch-layout
  (N, K) int8 weight -> (M, N) int32.
* `int8_matmul_dequant(xq, sx, wq, sw, bias, out_dtype)` fuses the dequant into
  the GEMM's epilogue: float32 with an optional bias (the tower's `int8_dense`),
  or bfloat16 without one (exp/pallas_int8_mlp_chain.py `pallas_int8_mm_deq`).
* `int8_dense(x, wq, sw, b)` is the JAX contract: x (..., I) float -> f32 (..., O).

On a CPU tensor the GEMMs run their plain versions (`int8_matmul_reference`,
`int8_matmul_dequant_reference`): a float64 product of the int8 values, exact
because |acc| <= K * 127^2 < 2^53, cast to int32, then the dequant as separate
torch ops. On a CUDA tensor they launch the kernel in csrc/int8_matmul.cu, or
raise; they never fall back. The quantizers are plain torch on every device, as
in the JAX package, where they are XLA ops outside the Pallas kernel.

The kernel has two instances, and the wrapper picks one by shape (`_instance`),
never by what a launch returns:
* "wgmma", the Hopper instance (the s8 wgmma engine of csrc/int8_wgmma.cuh,
  which X3's s8 path runs too: TMA + s8 wgmma, persistent, two consumer
  warpgroups taking alternate tiles so that one stores while the other
  multiplies, clusters of 2 x 2 blocks sharing each A and B stage by TMA
  multicast), where tensor maps can take both operands: K a positive
  multiple of 16 (the rows' byte stride) and both bases 16-byte aligned.
  Every GEMM of the int8 towers and of X4 is such a shape. `_tma_plan` lays
  out its maps.
* "mma_sync", the first (mma.sync) instance, for every other shape: K not a
  multiple of 16, an unaligned base (a view into a larger buffer), K = 0.
A CUDA tensor that the chosen instance refuses raises.

The kernel is compiled with nvcc for sm_90a at first use into
build/novic_tpu_torch/ and loaded through ctypes. `LAUNCHES` counts its
launches, and `INSTANCE_LAUNCHES` each instance's.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from novic_tpu_torch.ops import build as _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
INSTANCE_LAUNCHES = {"wgmma": 0, "mma_sync": 0}  # the same, by instance

SOURCE = _build.CSRC / "int8_matmul.cu"
_EPILOGUES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_lib = None
_lib_lock = threading.Lock()


def _quantize(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along `dim`: scale max|x| / 127 (floor 1e-12), codes
    round-half-even(x / scale) clipped to +-127, all in float32. A bfloat16 x
    gives the bits of x.float(): its max |x| is exact, and x / scale promotes
    x to float32 exactly, so no float32 copy of x is made."""
    amax = torch.linalg.vector_norm(x, ord=float("inf"), dim=dim, keepdim=True).float()
    scale = (amax / 127.0).clamp_min(1e-12)
    q = x / scale
    return q.round_().clamp_(-127, 127).to(torch.int8), scale


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, I) float weight -> (int8 (O, I), float32 per-output-channel scales (O,))."""
    wq, sw = _quantize(w.float(), 1)
    return wq, sw[:, 0]


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., I) float activations -> (int8 (..., I), float32 per-row scales (..., 1)).
    bfloat16 input is taken as its float32 values, as the JAX package does."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return _quantize(x, -1)


def int8_matmul_reference(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (M, K) int8 @ (N, K)ᵀ int8 -> (M, N) int32, exact."""
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int8_matmul_dequant_reference(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                                  sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the dequant epilogues: ((float)acc * sx) * sw (+ bias), in
    that order, each a separately rounded float32 op, then cast to out_dtype."""
    acc = int8_matmul_reference(xq, wq)
    y = acc.float() * sx.reshape(-1, 1) * sw[None, :]
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def build(force: bool = False) -> Path:
    """Compile csrc/int8_matmul.cu into the build directory (if stale); return the .so path."""
    return _build.build(SOURCE, force=force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.novic_int8_matmul.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                                              + [ctypes.c_void_p])
            lib.novic_int8_matmul.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_operands(xq: torch.Tensor, wq: torch.Tensor) -> tuple[int, int, int]:
    for name, t in (("xq", xq), ("wq", wq)):
        if t.dtype != torch.int8 or t.dim() != 2:
            raise ValueError(f"int8_matmul: {name} must be a 2-D int8 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_matmul: xq {tuple(xq.shape)} and wq {tuple(wq.shape)} "
                         "differ in K")
    return xq.shape[0], wq.shape[0], xq.shape[1]


def _device_kind(*tensors: Optional[torch.Tensor]) -> str:
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) != 1:
        raise ValueError(f"int8_matmul: operands on mixed devices {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: unsupported device {kind}")
    return kind


TMA_BOX = 128  # 128 K bytes: one swizzled row, the Hopper instance's box width and tile


def _instance(xq: torch.Tensor, wq: torch.Tensor) -> str:
    """The kernel instance for these contiguous operands: "wgmma" where tensor
    maps can take them (K a positive multiple of 16, both bases 16-byte
    aligned), else "mma_sync"."""
    K = xq.shape[1]
    aligned = xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    return "wgmma" if K > 0 and K % 16 == 0 and aligned else "mma_sync"


def _tma_plan(xq: torch.Tensor, wq: torch.Tensor) -> list[int]:
    """The Hopper instance's tensor maps: xq (M, K) and wq (N, K), both
    contiguous and K-major: dims (K, rows), rows K bytes apart, a box of 128 K
    bytes by 64 rows, half of a 128-row tile (each block of a 2 x 2 cluster
    loads half of its tiles and multicasts it to the block that shares the
    tile). The dims' extents zero-fill the ragged edges."""
    (M, K), N = xq.shape, wq.shape[0]
    return [K, M, K, TMA_BOX, TMA_BOX // 2, K, N, K, TMA_BOX, TMA_BOX // 2]


def _launch(xq, wq, sx, sw, bias, out_dtype: torch.dtype) -> torch.Tensor:
    global LAUNCHES
    M, N, K = _check_operands(xq, wq)
    if out_dtype not in _EPILOGUES:
        raise ValueError(f"int8_matmul: unsupported output dtype {out_dtype}")
    tensors = [xq, wq, sx, sw, bias]
    for name, t, shape in (("sx", sx, (M,)), ("sw", sw, (N,)), ("bias", bias, (N,))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            raise ValueError(f"int8_matmul: {name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    dev = xq.device
    if any(t is not None and (t.device != dev or not t.is_contiguous()) for t in tensors):
        raise ValueError(f"int8_matmul: every operand must be contiguous on {dev}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    instance = _instance(xq, wq)
    plan = None
    if instance == "wgmma":
        plan = ctypes.cast((ctypes.c_longlong * 10)(*_tma_plan(xq, wq)), ctypes.c_void_p)
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.novic_int8_matmul(xq.data_ptr(), wq.data_ptr(), plan, ptr(sx), ptr(sw),
                                    ptr(bias), out.data_ptr(), M, N, K, _EPILOGUES[out_dtype],
                                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed ({instance} instance): "
                           f"CUDA error {err}")
    LAUNCHES += 1
    INSTANCE_LAUNCHES[instance] += 1
    return out


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)ᵀ int8 -> (M, N) int32 (K2). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if _device_kind(xq, wq) == "cpu":
        _check_operands(xq, wq)
        return int8_matmul_reference(xq, wq)
    return _launch(xq, wq, None, None, None, torch.int32)


def int8_matmul_dequant(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """((float)(xq @ wqᵀ) * sx) * sw (+ bias) -> (M, N) out_dtype: float32 with an
    optional bias, or bfloat16 without one. sx is (M,) or (M, 1); sw and bias (N,)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul_dequant: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    if out_dtype == torch.bfloat16 and bias is not None:
        raise ValueError("int8_matmul_dequant: the bfloat16 epilogue takes no bias")
    sx = sx.reshape(-1)
    if _device_kind(xq, wq, sx, sw, bias) == "cpu":
        _check_operands(xq, wq)
        return int8_matmul_dequant_reference(xq, sx, wq, sw, bias, out_dtype)
    return _launch(xq, wq, sx.contiguous(), sw.contiguous(),
                   None if bias is None else bias.contiguous(), out_dtype)


def int8_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, b: Optional[torch.Tensor],
               rows: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Quantized x @ w.T + b with pre-quantized torch-layout weights.

    x: (..., I) float; wq: (O, I) int8; sw: (O,) float32; b: (O,) or None.
    Returns float32 (..., O): the rows of x quantized (or `rows`, the
    quantize_rows of x flattened to (-1, I), where the caller has them), one
    GEMM with the float32 dequant (and bias) in its epilogue."""
    lead, I = x.shape[:-1], x.shape[-1]
    xq, sx = rows if rows is not None else quantize_rows(x.reshape(-1, I))
    bias = None if b is None else b.float()
    y = int8_matmul_dequant(xq, sx, wq, sw, bias, torch.float32)
    return y.reshape(*lead, wq.shape[0])
