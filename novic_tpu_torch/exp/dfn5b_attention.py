"""DFN5B-H-14-378 attention harness on the port (the counterpart of
exp/dfn5b_attention.py).

The same transformer tower at the same shapes, S=730 (27x27 patches + cls),
E=1280, H=16, hd=80, 32 layers, B=32, with the attention as the plain chain
(`attn_xla`: bf16 scores and softmax, the yardstick), as one of the
harness's three Pallas schedules, which here launch ops/attention_bf16.py's
kernel (X2) once per layer: `attn_fullseq`, `attn_allheads`, `attn_direct`,
or as its `flash` variant (`make_attn_flash`), which launches
ops/flash_attention.py's kernel (X6) once per layer. Weights are (in, out) as
the harness keeps them, random from a seed.

Nothing runs at import: `main(device=...)` times the variants ("resid16"
adds the harness's bf16-residual runs).
"""

from __future__ import annotations

import math
import sys
import time

import torch
import torch.nn.functional as F

from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.vit import tower_dense
from novic_tpu_torch.ops.attention_bf16 import attn_allheads, attn_direct, attn_fullseq
from novic_tpu_torch.ops.flash_attention import SegmentIds, flash_attention

B = 32
IMG, PATCH = 378, 14
S = (IMG // PATCH) ** 2 + 1  # 730 (cls token)
E, H, LAYERS = 1280, 16, 32
hd = E // H  # 80
FF = 4 * E
INNER, ITERS, WARMUP = 4, 3, 1
bf16 = torch.bfloat16
# Parameter names of one layer, in the order make_params draws the random ones
KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo", "n1w", "n1b", "n2w", "n2b",
        "w1", "b1", "w2", "b2")


def make_params(layers: int = LAYERS, seed: int = 0, device="cuda") -> list[dict]:
    """One dict per layer with the harness's keys and shapes: normal(0, 0.02)
    weights and biases, unit / zero norm scales, drawn on the CPU from a
    torch.Generator seeded with `seed` (so every device gets the same values)."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    params = []
    for _ in range(layers):
        p = {"wq": mk(E, E), "wk": mk(E, E), "wv": mk(E, E), "wo": mk(E, E),
             "bq": mk(E), "bk": mk(E), "bv": mk(E), "bo": mk(E),
             "n1w": torch.ones(E), "n1b": torch.zeros(E),
             "n2w": torch.ones(E), "n2b": torch.zeros(E),
             "w1": mk(E, FF), "b1": mk(FF), "w2": mk(FF, E), "b2": mk(E)}
        params.append({k: p[k].to(dev) for k in KEYS})
    return params


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x @ w + b with w (in, out): bf16 operands, float32 accumulation, the
    product and b in out_dtype."""
    return tower_dense(x, w.t(), None, "bfloat16").to(out_dtype) + b.to(out_dtype)


def ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * w + b


def attn_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The harness's plain chain: (B, S, H, hd) → (B, S, H, hd) float32; bf16
    scores (float32 accumulation), softmax to bf16, bf16 P·v in float32."""
    Bq, Sq, Hq, d = q.shape
    qb = (q * (1.0 / math.sqrt(d))).to(bf16).transpose(1, 2)  # (B, H, S, hd)
    kb, vb = k.to(bf16).transpose(1, 2), v.to(bf16).transpose(1, 2)
    if q.is_cuda:
        scores = torch.matmul(qb, kb.transpose(-1, -2))  # bf16 out, float32 accumulation
        attn = torch.softmax(scores, dim=-1)
        out = torch.bmm(attn.reshape(-1, Sq, Sq), vb.reshape(-1, Sq, d), out_dtype=torch.float32)
    else:
        scores = torch.matmul(qb.float(), kb.float().transpose(-1, -2)).to(bf16)
        attn = torch.softmax(scores, dim=-1)
        out = torch.matmul(attn.float(), vb.float())
    return out.reshape(Bq, Hq, Sq, d).transpose(1, 2)


def make_attn_flash(block_q: int, block_k: int, sp: int = 768):
    """exp/dfn5b_attention.py `make_attn_flash` (X6): q, k, v (B, S, H, hd) →
    (B, S, H, hd) float32. Each is padded along S to sp rows and cast to bf16
    (the (B, H, sp, hd) view of the padded projections is what the kernel
    reads; no transposed copy is made); segment ids are 1 over the S real
    tokens and 0 over the padding; sm_scale is 1/√hd; the bf16 output is
    sliced back to S and returned as float32. The block sizes set the plain
    version's blocking on the CPU (block_k as JAX's; block_q changes no
    value). The kernel's 64-key tile is fixed, so on the card they change
    nothing and the harness's block sweep has no counterpart."""
    del block_q

    def attn(q, k, v):
        Bq, Sq = q.shape[:2]
        seg = F.pad(torch.ones((Bq, Sq), dtype=torch.int32, device=q.device), (0, sp - Sq))

        def prep(x):  # (B, S, H, hd) -> (B, H, sp, hd) bf16 view
            return F.pad(x, (0, 0, 0, 0, 0, sp - Sq)).to(bf16).transpose(1, 2)

        o = flash_attention(prep(q), prep(k), prep(v), segment_ids=SegmentIds(seg, seg),
                            sm_scale=1.0 / math.sqrt(q.shape[-1]), block_k=block_k)
        return o.transpose(1, 2)[:, :Sq].float()
    return attn


VARIANTS = {"xla": attn_xla, "fullseq": attn_fullseq, "allheads": attn_allheads,
            "direct": attn_direct, "flash": make_attn_flash(256, 256)}
# The harness's bf16-residual runs (its "resid16"): name -> (attention, resid dtype)
RESID16 = {"xla + bf16 residual": (attn_xla, bf16),
           "flash768 + bf16 resid": (make_attn_flash(768, 768), bf16)}


def tower(params: list[dict], x: torch.Tensor, attn_fn, resid_dtype: torch.dtype = torch.float32,
          mid_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The harness's tower: x (B, S, E); resid_dtype=bf16 halves the residual
    stream's traffic, mid_dtype=bf16 the q/k/v and fc1 outputs' (the layer
    norm statistics stay float32). The gelu is tanh-approximated, as
    jax.nn.gelu's default."""
    batch, seq, width = x.shape
    x = x.to(resid_dtype)
    for p in params:
        h = ln(x, p["n1w"], p["n1b"])
        q = dense(h, p["wq"], p["bq"], mid_dtype).reshape(batch, seq, H, width // H)
        k = dense(h, p["wk"], p["bk"], mid_dtype).reshape(batch, seq, H, width // H)
        v = dense(h, p["wv"], p["bv"], mid_dtype).reshape(batch, seq, H, width // H)
        o = attn_fn(q, k, v).reshape(batch, seq, width)
        x = (x + dense(o, p["wo"], p["bo"])).to(resid_dtype)
        h = ln(x, p["n2w"], p["n2b"])
        h = dense(h, p["w1"], p["b1"], mid_dtype)
        h = F.gelu(h, approximate="tanh")
        x = (x + dense(h, p["w2"], p["b2"])).to(resid_dtype)
    return x


def bench(name: str, attn_fn, params: list[dict], x0: torch.Tensor, **kw) -> float:
    """ms per tower pass: INNER passes of x0 + i * 1e-6, each summed, as the
    harness's loop, after WARMUP rounds; mean over ITERS rounds."""
    def run():
        acc = torch.zeros((), device=x0.device)
        for i in range(INNER):
            acc = acc + tower(params, x0 + i * 1e-6, attn_fn, **kw).sum().float()
        return acc.item()

    for _ in range(WARMUP):
        run()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        run()
    ms = (time.perf_counter() - t0) / (ITERS * INNER) * 1e3
    print(f"{name:24s} {ms:8.1f} ms/batch(B={x0.shape[0]})  {x0.shape[0] / ms * 1e3:7.1f} img/s",
          flush=True)
    return ms


def main(variants=None, device="cuda") -> dict:
    """Time the tower with each variant at the harness's shapes ("resid16":
    the bf16-residual runs); returns ms per pass."""
    dev = resolve(device)
    params = make_params(device=dev)
    x0 = torch.randn((B, S, E), generator=torch.Generator().manual_seed(1)).to(dev)
    out = {}
    for v in variants or list(VARIANTS):
        if v == "resid16":
            for name, (fn, dt) in RESID16.items():
                out[name] = bench(name, fn, params, x0, resid_dtype=dt)
        else:
            out[v] = bench(v, VARIANTS[v], params, x0)
    return out


if __name__ == "__main__":
    main(sys.argv[1:] or None)
