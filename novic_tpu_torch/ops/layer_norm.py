"""LayerNorm over the last dim, computed in float32: the hand-written CUDA
kernel and its plain version.

`layer_norm(x, weight, bias, eps, out_dtype)` computes
((x - mean) * rsqrt(var + eps)) * weight + bias in float32, with the mean and
variance over the last dim, and rounds it into `out_dtype`: the towers'
LayerNorm (embedders/vit.py `f32_layer_norm`). The JAX package writes it in
plain jnp, which XLA fuses into one pass; the kernel (csrc/layer_norm.cu) is
that pass written by hand: x read once, y written once.

* x is float32 or bfloat16, of any shape (..., D) with unit stride along D.
  Its rows may be strided (a view such as x[:, 0, :] is read in place); a
  layout that one row stride cannot step over is made contiguous first.
  weight and bias are float32 (D,). out_dtype is float32 or bfloat16; the
  output is contiguous.
* On a CPU tensor it runs `layer_norm_reference`, the plain PyTorch version.
* On a CUDA tensor it launches the kernel, or raises. It never falls back to
  the plain version. The kernel has no backward: an operand that requires
  grad while grad mode is on is refused.

The kernel is compiled with nvcc for sm_90a at first use into
build/novic_tpu_torch/ and loaded through ctypes. `LAUNCHES` counts its
launches; each launch also adds one to the program's counter
`tower.layer_norm` (utils/trace.py), which counts only while a profiler runs.
"""

from __future__ import annotations

import ctypes

import torch

from novic_tpu_torch.ops import build as _build
from novic_tpu_torch.utils import trace

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

SOURCE = _build.CSRC / "layer_norm.cu"
MAX_D = 16384  # the widest row the kernel takes (kMaxD in the source)
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
_library = _build.Library(SOURCE, {"novic_layer_norm": (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_float]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int)})


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: LayerNorm computed in float32, emitted in out_dtype."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * weight + bias).to(out_dtype)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           out_dtype: torch.dtype) -> None:
    if x.dtype not in _DTYPE_IDS:
        raise ValueError(f"layer_norm: unsupported input dtype {x.dtype} (float32 or bfloat16)")
    if out_dtype not in _DTYPE_IDS:
        raise ValueError(f"layer_norm: unsupported output dtype {out_dtype} "
                         f"(float32 or bfloat16)")
    if x.dim() == 0 or not 1 <= x.shape[-1] <= MAX_D:
        raise ValueError(f"layer_norm: x must be (..., D) with 1 <= D <= {MAX_D}, got "
                         f"{tuple(x.shape)}")
    D = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (D,):
            raise ValueError(f"layer_norm: {name} must be float32 ({D},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"layer_norm: x, weight and bias lie on different devices "
                         f"({x.device}, {weight.device}, {bias.device})")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as (rows, D) with unit stride along D, a view where one row stride
    steps over x's leading dims, else a contiguous copy."""
    D = x.shape[-1]
    try:
        x2 = x.view(-1, D)
    except RuntimeError:  # leading dims that no single row stride steps over
        x2 = x.contiguous().view(-1, D)
    return x2 if x2.stride(1) == 1 or D == 1 else x2.contiguous()


def _vector(x2: torch.Tensor, *others: torch.Tensor) -> bool:
    """16-byte accesses: D a whole number of 16-byte chunks of x, every base and
    x's row stride 16-byte aligned."""
    size = x2.element_size()
    return (x2.shape[1] % (16 // size) == 0 and x2.stride(0) * size % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x2, *others)))


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
            out_dtype: torch.dtype) -> torch.Tensor:
    global LAUNCHES
    _check(x, weight, bias, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise ValueError("layer_norm kernel: it has no backward, and an operand requires grad")
    weight, bias = weight.contiguous(), bias.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    x2 = _rows(x)
    rows, D = x2.shape
    vector = _vector(x2, y, weight, bias)
    lib = _library()
    _build.launch("layer_norm", x.device, lambda stream: lib.novic_layer_norm(
        x2.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), rows, D, x2.stride(0),
        eps, _DTYPE_IDS[x.dtype], _DTYPE_IDS[out_dtype], int(vector), stream))
    LAUNCHES += 1
    trace.count("tower.layer_norm")
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm of x over its last dim in float32, emitted in out_dtype: CPU
    tensors take the plain version, CUDA tensors launch the kernel."""
    if x.device.type == "cuda":
        return _launch(x, weight, bias, eps, out_dtype)
    _check(x, weight, bias, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    return layer_norm_reference(x, weight, bias, eps, out_dtype)
