"""Dropout with a counter-based mask: the hand-written CUDA kernel (K3′) and its
plain version.

`dropout(x, seed, rate, offset)` computes y = keep ? x * inv_keep : 0 with the
semantics of the JAX package's Pallas kernel (novic_tpu/ops/dropout.py
`hw_dropout`): keep where the element's 32 random bits are below
thresh = min(round((1 - rate) * 2^32), 2^32 - 1), inv_keep = 1 / (1 - rate)
rounded to x's float type. The bits are Philox4x32-10 with the two seed words
as key and counter (lo32(i / 4), hi32(i / 4), 0, 0); element i takes word
i mod 4, so the mask is a function of (seed, element index) only. `offset`
(default 0) shifts the index: x's element i takes the bits of element
offset + i, so a data-parallel rank that holds rows [r*b, (r+1)*b) of a
batch-major tensor draws, with offset r * x.numel(), the same mask as one
device does for the whole batch.

Its gradient is a `torch.autograd.Function` that keeps only the seed words and
the rate, and regenerates the same mask on dy in the backward pass.

* On a CPU tensor it runs `dropout_reference`, the plain PyTorch version, which
  reproduces the kernel's bits exactly.
* On a CUDA tensor it launches the kernel in csrc/dropout.cu, or raises. It
  never falls back to the plain version.

The kernel is compiled with nvcc for sm_90a at first use into
build/novic_tpu_torch/ and loaded through ctypes. `LAUNCHES` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from novic_tpu_torch.ops import build as _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

SOURCE = _build.CSRC / "dropout.cu"
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_library = _build.Library(SOURCE, {"novic_dropout": (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p],
    ctypes.c_int)})


@functools.lru_cache(maxsize=None)
def keep_threshold(rate: float) -> int:
    """Keep where bits < this (the Pallas kernel's thresh)."""
    return min(int(round((1.0 - rate) * 2 ** 32)), 2 ** 32 - 1)


@functools.lru_cache(maxsize=None)
def inv_keep(rate: float, dtype: torch.dtype) -> float:
    """1 / (1 - rate) rounded to `dtype`, as a Python float."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def draw_seed(generator: torch.Generator) -> tuple[int, int]:
    """Two 32-bit seed words from a CPU generator (no device work)."""
    return tuple(torch.randint(0, 2 ** 32, (2,), generator=generator, dtype=torch.int64).tolist())


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a * b for a < 2^32 and b < 2^32 in int64, from
    16-bit halves so no partial product overflows."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    ll = b_lo * a_lo
    mid = b_hi * a_lo + b_lo * a_hi + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = b_hi * a_hi + (mid >> 16)
    return hi, lo


def philox_bits(seed: tuple[int, int], start: int, count: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernel's random words for elements [start, start + count): (count,) int64
    holding uint32 values."""
    g0, g1 = start // 4, (start + count + 3) // 4
    group = torch.arange(g0, g1, dtype=torch.int64, device=device)
    c0, c1 = group & _MASK32, group >> 32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed[0] & _MASK32, seed[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    words = torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)
    off = start - 4 * g0
    return words[off:off + count]


def dropout_reference(x: torch.Tensor, seed: tuple[int, int], rate: float,
                      offset: int = 0) -> torch.Tensor:
    """Plain version of the kernel: the same bits, the same products, the same rounding."""
    bits = philox_bits(seed, offset, x.numel(), device=x.device).reshape(x.shape)
    keep = bits < keep_threshold(rate)
    y = x.float() * inv_keep(rate, x.dtype)
    return torch.where(keep, y, torch.zeros((), dtype=y.dtype, device=y.device)).to(x.dtype)


def _launch(x: torch.Tensor, seed: tuple[int, int], rate: float, offset: int) -> torch.Tensor:
    global LAUNCHES
    if x.dtype not in _DTYPE_IDS:
        raise ValueError(f"dropout kernel: unsupported dtype {x.dtype} (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("dropout kernel: x must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _library()
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"dropout kernel: x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    _build.launch("dropout", x.device, lambda stream: lib.novic_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), offset, _DTYPE_IDS[x.dtype], seed[0] & _MASK32,
        seed[1] & _MASK32, keep_threshold(rate), inv_keep(rate, x.dtype), stream))
    LAUNCHES += 1
    return y


def dropout_apply(x: torch.Tensor, seed: tuple[int, int], rate: float,
                  offset: int = 0) -> torch.Tensor:
    """One application of the mask (no autograd): CPU tensors take the plain
    version, CUDA tensors launch the kernel."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1): {rate}")
    if offset < 0:
        raise ValueError(f"dropout offset must be >= 0: {offset}")
    if x.device.type == "cpu":
        return dropout_reference(x, seed, rate, offset)
    if x.device.type != "cuda":
        raise ValueError(f"dropout: unsupported device {x.device}")
    return _launch(x, seed, rate, offset)


class _Dropout(torch.autograd.Function):
    """Keeps only the seed words and the rate; backward regenerates the mask."""

    @staticmethod
    def forward(ctx, x, seed0: int, seed1: int, rate: float, offset: int):
        ctx.mask_args = ((seed0, seed1), rate, offset)
        return dropout_apply(x, (seed0, seed1), rate, offset)

    @staticmethod
    def backward(ctx, dy):
        seed, rate, offset = ctx.mask_args
        return dropout_apply(dy.contiguous(), seed, rate, offset), None, None, None, None


def dropout(x: torch.Tensor, seed: tuple[int, int], rate: float, offset: int = 0) -> torch.Tensor:
    """Dropout(x) with the counter-based mask of `seed` (two 32-bit words), x
    taking the bits of elements [offset, offset + x.numel())."""
    return _Dropout.apply(x, int(seed[0]), int(seed[1]), float(rate), int(offset))
