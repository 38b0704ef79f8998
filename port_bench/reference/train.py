"""Plain PyTorch reference of the FT0 recipe's optimizer step (NOVIC, WACV
2025): embedding noise, the decoder's teacher-forced forward with dropout,
the masked cross-entropy, gradient accumulation, global-norm clipping and
AdamW, from the FT0 checkpoint file's parameters.

The step draws its randomness as the recipe defines it, from two seeds
that both sides are given: the noise from a generator on the batch's device
seeded `seed + 1` (per microbatch, in the scheme's order: the angle, the
direction, the element noise, the mix), the dropout masks from Philox4x32-10
counters keyed by two 32-bit words a site, drawn in the order the sites run
from a CPU generator seeded `seed` (input; then per layer the attention
probabilities, the attention output, the feed-forward activation and its
output); an element is kept when its word is below round((1 - rate) 2^32)
and scaled by the float32 value of 1 / (1 - rate).

Arithmetic: float32 with TF32 off. `tf32=True`, the control, rounds both
operands of every forward product to TF32.

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.decoder import read_checkpoint, round_tf32, tf32_matmuls

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a * b (both < 2^32) in int64, by 16-bit halves."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    ll = bl * al
    mid = bh * al + bl * ah + (ll >> 16)
    return bh * ah + (mid >> 16), ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox_words(seed: tuple[int, int], count: int, device) -> torch.Tensor:
    """(count,) int64 random words: element i takes word i % 4 of the Philox
    block whose counter is i // 4 (high 32 bits in the second word)."""
    g = torch.arange((count + 3) // 4, dtype=torch.int64, device=device)
    c0, c1, c2, c3 = g & _M32, g >> 32, torch.zeros_like(g), torch.zeros_like(g)
    k0, k1 = seed[0] & _M32, seed[1] & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:count]


class ReferenceTrainer:
    """The FT0 decoder's parameters and AdamW state; `step` is one optimizer
    step over a batch of `accum` microbatches."""

    def __init__(self, checkpoint: str, device, recipe: dict, seed: int, *, tf32: bool = False):
        params, meta = read_checkpoint(checkpoint)
        cfg = meta["model_config"]
        self.device, self.recipe, self.tf32 = torch.device(device), recipe, tf32
        self.p = {k: torch.from_numpy(a.astype(np.float32)).to(self.device).requires_grad_()
                  for k, a in params.items()}
        self.E, self.P, self.L, self.H = (cfg["hidden_dim"], cfg["mlp_seq_len"],
                                          cfg["num_layers"], cfg["num_heads"])
        self.rates = (cfg["input_dropout"], cfg["layer_dropout"])
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        self.drop_gen = torch.Generator().manual_seed(seed)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    # -- pieces ------------------------------------------------------------------------

    def _mm(self, x, w):
        if self.tf32:
            x = x + (round_tf32(x.detach()) - x.detach())
            w = w + (round_tf32(w.detach()) - w.detach())
        return x @ w.t()

    def _drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        seed = tuple(torch.randint(0, 2 ** 32, (2,), generator=self.drop_gen,
                                   dtype=torch.int64).tolist())
        words = philox_words(seed, x.numel(), x.device).reshape(x.shape)
        keep = words < min(int(round((1.0 - rate) * 2 ** 32)), 2 ** 32 - 1)
        scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
        return torch.where(keep, x * scale, torch.zeros((), device=x.device))

    def _noise(self, e: torch.Tensor) -> torch.Tensor:
        n, g = self.recipe["noise"], self.noise_gen
        B1 = (e.shape[0], 1)
        lo, hi = math.radians(n["angle_min"]), math.radians(n["angle_max"])
        rand = lambda shape: torch.rand(shape, generator=g, device=e.device)    # noqa: E731
        randn = lambda shape: torch.randn(shape, generator=g, device=e.device)  # noqa: E731
        angle = lo + (hi - lo) * rand(B1)
        direction, elem, mix = randn(e.shape), randn(e.shape), rand(B1) < n["mix_ratio"]
        unit = lambda x: x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)       # noqa: E731
        ortho = unit(direction - e * (e * direction).sum(-1, keepdim=True))
        rotated = unit(e * torch.cos(angle) + ortho * torch.sin(angle))
        jittered = unit(e + n["vec_norm"] / math.sqrt(e.shape[-1]) * elem)
        return torch.where(mix, rotated, jittered)

    def _forward(self, embed, target, padding):
        """(loss_sum, loss_basis) of one microbatch, dropout on."""
        p, E, P, H = self.p, self.E, self.P, self.H
        hd = E // H
        B, C = target.shape
        S = P + C - 1
        e = embed / embed.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        x = self._mm(e, p["embed_mlp.linear1_weight"]).reshape(B, P, E)
        x = torch.cat([x, p["logits_weight"][target[:, :-1].long()]], dim=1)
        x = x + p["pos_embedding"][:S]
        x = self._drop(x, self.rates[0])
        i, j = torch.arange(S, device=x.device)[:, None], torch.arange(S, device=x.device)[None, :]
        bias = torch.where((j <= i) | ((i < P) & (j < P)), 0.0, -1e30)
        ln = lambda t, w: F.layer_norm(t, (E,), w, None, 1e-5)                   # noqa: E731
        for li in range(self.L):
            pre = f"transformer.layers_{li}."
            q, k, v = self._mm(ln(x, p[pre + "norm1_weight"]), p[pre + "self_attn_in_proj_weight"]
                               ).chunk(3, dim=-1)
            q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
            a = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2) + bias, dim=-1)
            o = (self._drop(a, self.rates[1]) @ v).transpose(1, 2).reshape(B, S, E)
            x = x + self._drop(self._mm(o, p[pre + "self_attn_out_proj_weight"]), self.rates[1])
            h = F.gelu(self._mm(ln(x, p[pre + "norm2_weight"]), p[pre + "linear1_weight"]))
            h = self._mm(self._drop(h, self.rates[1]), p[pre + "linear2_weight"])
            x = x + self._drop(h, self.rates[1])
        x = ln(x, p["transformer.norm_weight"])[:, P - 1:]
        logits = self._mm(x, p["logits_weight"])
        elems = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, target.long().clamp_min(0)[..., None])[..., 0]
        live = ~padding
        return torch.where(live, elems, 0.0).sum(), live.sum().float()

    # -- one optimizer step ----------------------------------------------------------

    def step(self, batch, lr: float) -> tuple[float, dict]:
        """Run one step; return its mean loss and the clipped gradients."""
        embed, target, padding, _ = batch
        A = self.recipe["accum"]
        for t in self.p.values():
            t.grad = None
        loss_sum = basis = 0.0
        with tf32_matmuls(False):
            for mb in range(A):
                rows = slice(mb * embed.shape[0] // A, (mb + 1) * embed.shape[0] // A)
                e = self._noise(embed[rows].float())
                s, b = self._forward(e, target[rows], padding[rows])
                (s / b.clamp_min(1e-12) / A).backward()
                loss_sum, basis = loss_sum + float(s.detach()), basis + float(b)
        grads = {k: t.grad for k, t in self.p.items()}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads.values()]))
        scale = (self.recipe["gradient_clip"] / norm.clamp_min(1e-12)).clamp_max(1.0)
        b1, b2, eps = self.recipe["beta1"], self.recipe["beta2"], self.recipe["eps"]
        self.t += 1
        with torch.no_grad():
            for k, t in self.p.items():
                g = grads[k] * scale
                grads[k] = g
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(eps)
                t.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.t))
        return loss_sum / basis, grads
