"""The int8 GEMM probes on the port (the counterparts of exp/pallas_int8_matmul.py
and exp/pallas_int8_rate_pin.py).

`make_matmul` is the first probe's product, x (M, K) · w (K, N) at the DFN5B-H
MLP shape M=16384, K=1280, N=5120, int8 → int32 or bf16 → float32; `make_mm`
the second's, at M=8192, reduced to an (M, N / bn) checksum, float32, bf16 or
int8 in. Both launch ops/tiled_matmul.py's kernel (X3) once per call. bm and
bk were the Pallas kernels' VMEM tiles: they are accepted and unused (the
kernel picks its own tiles); bn still names the checksum's column blocks.

Nothing runs at import: `main(device=...)` runs both probes' loops.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from novic_tpu_torch.device import resolve
from novic_tpu_torch.ops import tiled_matmul as _tm

M, K, N = 16384, 1280, 5120  # make_matmul's shape
MM_M = 8192                  # make_mm's rows
INNER, ITERS = 8, 3
# make_matmul's first tile (the kernel's own tiles do not follow the others of
# the sweep), and make_mm's sweep, whose bn names the checksum's blocks
MATMUL_TILE = (512, 512, 1280)
MM_TILES = ((512, 512, 1280), (256, 256, 1280), (1024, 1024, 640), (512, 512, 256),
            (2048, 512, 1280))


def make_matmul(bm: int, bn: int, bk: int, in_dtype: torch.dtype, acc_dtype: torch.dtype,
                out_dtype: torch.dtype):
    """exp/pallas_int8_matmul.py `make_matmul`: returns mm(x, w) → (M, N)
    out_dtype, for (in, acc, out) = (int8, int32, int32) or (bf16, f32, f32)."""
    if _tm.out_dtype(in_dtype) != out_dtype or acc_dtype != out_dtype:
        raise ValueError(f"make_matmul: ({in_dtype}, {acc_dtype}, {out_dtype}) is not a form "
                         "the probe runs (int8/int32/int32 or bfloat16/float32/float32)")

    def mm(x, w):
        return _tm.tiled_matmul(x, w)

    return mm


def make_mm(bm: int, bn: int, bk: int, acc_dtype: torch.dtype):
    """exp/pallas_int8_rate_pin.py `make_mm`: returns mm(x, w) → (M, N // bn)
    float32, each row's sum over each bn-wide column block (acc_dtype int32 for
    int8 inputs, float32 otherwise, follows from the inputs)."""
    def mm(x, w):
        if acc_dtype != _tm.out_dtype(x.dtype):
            raise ValueError(f"make_mm: acc_dtype {acc_dtype} does not fit {x.dtype} inputs")
        return _tm.tiled_matmul(x, w, bn=bn)

    return mm


def inputs(m: int = M, k: int = K, n: int = N, seed: int = 0, device="cuda") -> dict:
    """The probes' operands: normal x (m, k) and w (k, n) in float32, their bf16
    casts, and int8 (x * 10 truncated), on `device`."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    xf = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    wf = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    return {"f32": (xf, wf), "bf16": (xf.to(torch.bfloat16), wf.to(torch.bfloat16)),
            "int8": ((xf * 10).to(torch.int8), (wf * 10).to(torch.int8))}


def timeit(name: str, fn, x: torch.Tensor, w: torch.Tensor) -> float:
    """ms per call: INNER calls summed per round (the probes' loop), mean over
    ITERS rounds after one warm-up round."""
    def looped():
        acc = torch.zeros((), device=x.device)
        for _ in range(INNER):
            acc = acc + fn(x, w).sum().float()
        return acc.item()

    looped()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        looped()
    ms = (time.perf_counter() - t0) / (ITERS * INNER) * 1e3
    m, n = x.shape[0], w.shape[1]
    print(f"{name:44s} {ms:8.3f} ms   {2 * m * x.shape[1] * n / ms / 1e9:6.1f} T(FL)OP/s",
          flush=True)
    return ms


def main(device="cuda") -> dict:
    """Both probes' sweeps; returns ms per call by name."""
    out = {}
    ops = inputs(M, device=device)
    bm, bn, bk = MATMUL_TILE
    tag = f"bm{bm} bn{bn} bk{bk}"
    out[f"matmul bf16 {tag}"] = timeit(f"bf16 f32acc   {tag}", make_matmul(
        bm, bn, bk, torch.bfloat16, torch.float32, torch.float32), *ops["bf16"])
    out[f"matmul int8 {tag}"] = timeit(f"int8 i32acc   {tag}", make_matmul(
        bm, bn, bk, torch.int8, torch.int32, torch.int32), *ops["int8"])
    del ops
    ops = inputs(MM_M, device=device)
    for bm, bn, bk in MM_TILES:
        tag = f"bm{bm} bn{bn} bk{bk}"
        out[f"mm f32 {tag}"] = timeit(f"f32  {tag}", make_mm(bm, bn, bk, torch.float32), *ops["f32"])
        out[f"mm bf16 {tag}"] = timeit(f"bf16 {tag}", make_mm(bm, bn, bk, torch.float32), *ops["bf16"])
        out[f"mm int8 {tag}"] = timeit(f"int8 {tag}", make_mm(bm, bn, bk, torch.int32), *ops["int8"])
    return out


if __name__ == "__main__":
    main()
