"""ViT-B attention harness on the port (the counterpart of exp/pallas_attn_v2.py).

A 12-layer ViT-B tower (B=256, S=196, E=768, H=12) whose attention is the plain
chain (`attn_xla`: bf16 scores and softmax) or, with use_pallas, the harness's
`fused_attention2`, which here launches ops/attention_bf16.py's kernel (X1)
once per layer on the (B, S, E) projections in place. Weights are (out, in),
random from a seed. The root file runs its timing at import; this one runs
nothing until `main(device=...)`.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.vit import tower_dense
from novic_tpu_torch.exp import dfn5b_attention
from novic_tpu_torch.ops.attention_bf16 import fused_attention2

B, S, E, H, L, FF = 256, 196, 768, 12, 12, 3072
hd = E // H
INNER, ITERS = 10, 3
bf16 = torch.bfloat16


def make_params(layers: int = L, seed: int = 0, device="cuda") -> list[dict]:
    """One dict per layer with the harness's keys and shapes: normal(0, 0.02)
    q/k/v/o, fc1 (FF, E) and fc2 (E, FF) weights, zero biases, unit / zero
    norm scales, drawn on the CPU from a torch.Generator seeded with `seed`."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(seed)

    def mk(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(dev)

    def zeros(n):
        return torch.zeros(n, device=dev)

    return [dict(n1w=torch.ones(E, device=dev), n1b=zeros(E), n2w=torch.ones(E, device=dev),
                 n2b=zeros(E), wq=mk(E, E), bq=zeros(E), wk=mk(E, E), bk=zeros(E),
                 wv=mk(E, E), bv=zeros(E), wo=mk(E, E), bo=zeros(E),
                 w1=mk(FF, E), b1=zeros(FF), w2=mk(E, FF), b2=zeros(E))
            for _ in range(layers)]


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b with w (out, in): bf16 operands, float32 product."""
    return tower_dense(x, w, None, "bfloat16") + b


def ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = x.float()
    m = x.mean(dim=-1, keepdim=True)
    v = torch.square(x - m).mean(dim=-1, keepdim=True)
    return ((x - m) * torch.rsqrt(v + 1e-6) * w + b).to(bf16)


def attn_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The harness's plain chain on (B, S, E): the same chain as the DFN5B
    harness's (bf16 scores, softmax to bf16, bf16 P·v in float32), per head."""
    Bq, Sq, Eq = q.shape
    split = lambda t: t.reshape(Bq, Sq, H, Eq // H)  # noqa: E731
    return dfn5b_attention.attn_xla(split(q), split(k), split(v)).reshape(Bq, Sq, Eq)


def tower(x: torch.Tensor, params: list[dict], use_pallas: bool) -> torch.Tensor:
    """The harness's tower; use_pallas runs X1's kernel. The residual stream
    stays in x's dtype; the block outputs are rounded to bf16 before the add."""
    for p in params:
        h = ln(x, p["n1w"], p["n1b"])
        q = dense(h, p["wq"], p["bq"])
        k = dense(h, p["wk"], p["bk"])
        v = dense(h, p["wv"], p["bv"])
        if use_pallas:
            o = fused_attention2(q.to(bf16), k.to(bf16), v.to(bf16), heads=H)
        else:
            o = attn_xla(q, k, v)
        x = x + dense(o, p["wo"], p["bo"]).to(bf16)
        h = ln(x, p["n2w"], p["n2b"])
        h = F.gelu(dense(h, p["w1"], p["b1"]).to(bf16), approximate="tanh")
        x = x + dense(h, p["w2"], p["b2"]).to(bf16)
    return x


def timeit(name: str, fn, *args) -> float:
    """ms per call of fn(x + i * 1e-6, params), INNER calls summed per round,
    mean over ITERS rounds after one warm-up round."""
    x, params = args

    def looped():
        acc = torch.zeros((), device=x.device)
        for i in range(INNER):
            acc = acc + fn(x + i * 1e-6, params).sum().float()
        return acc.item()

    looped()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        looped()
    ms = (time.perf_counter() - t0) / (ITERS * INNER) * 1e3
    print(f"{name:34s} {ms:8.2f} ms/batch  {x.shape[0] / ms * 1e3:9.1f} img/s", flush=True)
    return ms


def main(device="cuda") -> dict:
    """The root harness's run: a numerical check of X1 against the plain chain
    at B=4, then the tower timed both ways."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(1)
    qs, ks, vs = (torch.randn((4, S, E), generator=gen).to(dev).to(bf16) for _ in range(3))
    got = fused_attention2(qs, ks, vs, heads=H)
    ref = attn_xla(qs.float(), ks.float(), vs.float())
    print("kernel vs plain chain max abs diff:", (got - ref).abs().max().item(), flush=True)
    params = make_params(device=dev)
    x0 = torch.randn((B, S, E), generator=gen).to(dev)
    return {"xla": timeit("plain chain (S=196)", lambda x, p: tower(x, p, False), x0, params),
            "x1": timeit("X1 kernel (fused_attention2)", lambda x, p: tower(x, p, True), x0, params)}


if __name__ == "__main__":
    main()
