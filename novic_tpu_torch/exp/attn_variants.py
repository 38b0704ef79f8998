"""ViT-B/16 tower attention variants on the port (the counterpart of
exp/attn_variants.py).

The same raw ViT-B/16 block stack (no MAP head) at the same shapes, B=256,
S=196, E=768, H=12, 12 layers, FF=3072; weights (out, in), layer norm (eps
1e-6) emitted in bf16, tanh gelu, random weights from a seed. The attention
variants of the root file:
  attn_xla_f32         bf16 q·kᵀ in float32, float32 softmax, P rounded to bf16
  attn_xla_bf16        the scores and the softmax in bf16
  attn_xla_bf16_f32sm  bf16 scores, float32 softmax, P rounded to bf16
  attn_flash           the flash-attention kernel (X6, ops/flash_attention.py)
                       over the projections padded to SP=256 with segment ids,
                       one launch per layer
and `tower_bhsd`, the head-major tower with bf16 scores and softmax. On the
card the plain chains run as bf16 cuBLAS products with float32 accumulation;
on the CPU as float32 products of the bf16 operands (the same exact products).

The root file times at import; this one runs nothing until `main(device=...)`,
which runs the root file's check (flash vs attn_xla_f32 at B=4, max abs diff)
and then times every variant.
"""

from __future__ import annotations

import math
import time

import torch
import torch.nn.functional as F

from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.vit import tower_dense
from novic_tpu_torch.exp.attn_v2 import dense, ln, make_params
from novic_tpu_torch.ops.flash_attention import SegmentIds, flash_attention

B, S, E, H, L, FF = 256, 196, 768, 12, 12, 3072
hd = E // H
INNER, ITERS = 10, 3
SP = 256  # attn_flash's padded length and block: JAX's single-step body on the CPU
SCALE = 1.0 / math.sqrt(hd)
bf16, f32 = torch.bfloat16, torch.float32


def _bmm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) over bf16 operands, float32 accumulation,
    rounded to out_dtype."""
    if a.is_cuda:
        lead = a.shape[:-2]
        y = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                      out_dtype=out_dtype) if out_dtype == f32 else torch.matmul(a, b)
        return y.reshape(*lead, a.shape[-2], b.shape[-1])
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """(B, S, H, hd) q and k → (B, H, S, S): bf16(q * scale) · bf16(k)ᵀ."""
    qb = (q * SCALE).to(bf16).transpose(1, 2)
    kb = k.to(bf16).transpose(1, 2)
    return _bmm(qb, kb.transpose(-1, -2), out_dtype)


def _pv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """bf16 P (B, H, S, S) · bf16 v (B, S, H, hd) → (B, S, H, hd) float32."""
    return _bmm(a, v.to(bf16).transpose(1, 2), f32).transpose(1, 2)


def attn_xla_f32(q, k, v):
    return _pv(torch.softmax(_scores(q, k, f32), dim=-1).to(bf16), v)


def attn_xla_bf16(q, k, v):
    return _pv(torch.softmax(_scores(q, k, bf16), dim=-1), v)


def attn_xla_bf16_f32sm(q, k, v):
    return _pv(torch.softmax(_scores(q, k, bf16).float(), dim=-1).to(bf16), v)


def attn_flash(q, k, v):
    """exp/attn_variants.py `attn_flash` (X6): q, k, v (B, S, H, hd) padded to
    SP rows and cast to bf16 (read by the kernel as (B, H, SP, hd) views),
    segment ids 1 over the S tokens and 0 over the padding, blocks of SP (so
    the plain version on the CPU takes JAX's single-step body); the bf16
    output sliced to S and returned as float32."""
    Bq, Sq = q.shape[:2]
    seg = F.pad(torch.ones((Bq, Sq), dtype=torch.int32, device=q.device), (0, SP - Sq))

    def prep(x):
        return F.pad(x.to(bf16), (0, 0, 0, 0, 0, SP - Sq)).transpose(1, 2)

    o = flash_attention(prep(q), prep(k), prep(v), segment_ids=SegmentIds(seg, seg),
                        sm_scale=SCALE, block_k=SP)
    return o.transpose(1, 2)[:, :Sq].float()


VARIANTS = {"attn_xla_f32": attn_xla_f32, "attn_xla_bf16": attn_xla_bf16,
            "attn_xla_bf16_f32sm": attn_xla_bf16_f32sm, "attn_flash": attn_flash}


def tower(x: torch.Tensor, attn, params: list[dict]) -> torch.Tensor:
    """The root file's `tower`: x (B, S, E); the block outputs are rounded to
    bf16 before each residual add."""
    batch, seq, _ = x.shape
    for p in params:
        h = ln(x, p["n1w"], p["n1b"])
        q = dense(h, p["wq"], p["bq"]).reshape(batch, seq, H, hd)
        k = dense(h, p["wk"], p["bk"]).reshape(batch, seq, H, hd)
        v = dense(h, p["wv"], p["bv"]).reshape(batch, seq, H, hd)
        o = attn(q, k, v).reshape(batch, seq, E)
        x = x + dense(o, p["wo"], p["bo"]).to(bf16)
        h = ln(x, p["n2w"], p["n2b"])
        h = F.gelu(dense(h, p["w1"], p["b1"]).to(bf16), approximate="tanh")
        x = x + dense(h, p["w2"], p["b2"]).to(bf16)
    return x


def tower_bhsd(x: torch.Tensor, params: list[dict]) -> torch.Tensor:
    """The root file's `tower_bhsd`: q, k, v projected head-major (B, H, S, hd)
    and rounded to bf16; scores bf16(bf16(q * scale)·kᵀ), softmax in bf16,
    P·v in float32; then the tower's output projection and MLP."""
    batch, seq, _ = x.shape
    for p in params:
        h = ln(x, p["n1w"], p["n1b"])

        def proj(w, b):
            y = tower_dense(h, w, None, "bfloat16").reshape(batch, seq, H, hd).transpose(1, 2)
            return (y + b.reshape(1, H, 1, hd)).to(bf16)

        q, k, v = proj(p["wq"], p["bq"]), proj(p["wk"], p["bk"]), proj(p["wv"], p["bv"])
        a = torch.softmax(_bmm(q * SCALE, k.transpose(-1, -2), bf16), dim=-1)
        o = _bmm(a, v, f32).transpose(1, 2).reshape(batch, seq, E)
        x = x + dense(o, p["wo"], p["bo"]).to(bf16)
        h = ln(x, p["n2w"], p["n2b"])
        h = F.gelu(dense(h, p["w1"], p["b1"]).to(bf16), approximate="tanh")
        x = x + dense(h, p["w2"], p["b2"]).to(bf16)
    return x


def check(device="cuda", batch: int = 4, seed: int = 1) -> float:
    """The root file's numeric sanity check: attn_flash against attn_xla_f32
    on one layer's worth of random q, k, v (std 1) at B=4; max abs diff."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((batch, S, H, hd), generator=gen).to(resolve(device)) for _ in range(3))
    diff = (attn_xla_f32(q, k, v) - attn_flash(q, k, v)).abs().max().item()
    print("flash vs xla max abs diff:", diff, flush=True)
    return diff


def timeit(name: str, fn, x: torch.Tensor, params: list[dict]) -> float:
    """ms per call of fn(x + i * 1e-6, params): INNER calls summed per round,
    mean over ITERS rounds after one warm-up round."""
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
    print(f"{name:28s} {ms:8.2f} ms/batch  {x.shape[0] / ms * 1e3:9.1f} img/s", flush=True)
    return ms


def main(device="cuda") -> dict:
    """The check, then every variant's tower and the head-major tower timed
    at B=256; returns ms per pass by name."""
    dev = resolve(device)
    check(dev)
    params = make_params(L, seed=0, device=dev)
    x0 = torch.randn((B, S, E), generator=torch.Generator().manual_seed(2)).to(dev)
    out = {name: timeit(name, lambda x, p, a=attn: tower(x, a, p), x0, params)
           for name, attn in VARIANTS.items()}
    out["tower_bhsd"] = timeit("head-major + bf16 softmax", tower_bhsd, x0, params)
    return out


if __name__ == "__main__":
    main()
