"""Optimizer, learning-rate schedule and gradient clipping (the counterpart of
novic_tpu.train.optim).

AdamW (torch.optim.AdamW) giving the update the JAX package's trainer gives.
That package builds an optax mask that means the reference's two groups
(reference train.py:1103-1116: decay for ndim >= 2, none for layer norms,
biases and ReZero scalars), but passes the mask callable through
inject_hyperparams, which evaluates it on the step count: the mask is then the
scalar weight_decay_1d. So with weight_decay_1d=False no parameter decays, and
with weight_decay_1d=True every parameter does; the port does the same, so a
run trains to the JAX trainer's loss curve and checkpoints. The nominal
weight_decay is kept on the group as "weight_decay_hparam", which bridge.py
writes into the optax leaf list as JAX does. torch's AdamW and optax's adamw
compute the same update: both add eps outside the square root of the
bias-corrected second moment and decay decoupled from the gradient. The
learning rate is set per step from `lr_schedule_per_chunk`.

AdamP (`AdamP`, optimizer=AdamP) is the JAX package's transcription of timm's
(novic_tpu.train.optim.adamp). There the decay mask is static, so it holds as
the reference means it: ndim >= 2 decays, unless weight_decay_1d.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch


def lr_schedule_per_chunk(init_lr: float, final_lr: float, lr_scheduler: str,
                          lr_warmup: int, max_chunks: int,
                          start_chunk: int = 1) -> Callable[[int], float]:
    """chunk_id (1-based) → learning rate: linear warmup over lr_warmup chunks
    (start factor 1/(W+1)), then const or cosine to final_lr.

    start_chunk anchors the schedule: 1 continues the original horizon, the
    resumed chunk restarts warmup AND the cosine horizon (load_lr_state=False,
    ref train.py:1132-1146)."""
    scheduler = lr_scheduler.lower()
    if scheduler not in ("const", "cosine"):
        raise ValueError(f"LR scheduler not recognised: {lr_scheduler}")
    # Cosine horizon (ref train.py:1156): +1 chunk when final_lr == 0 so the last
    # trained chunk doesn't hit exactly 0
    t_max = max((max_chunks if final_lr > 0 else max_chunks + 1) - start_chunk, 1)

    def schedule(chunk_id: int) -> float:
        t = max(chunk_id - start_chunk, 0)  # chunks completed since the anchor
        warm = min(t, lr_warmup)
        warm_factor = (1 + warm) / (lr_warmup + 1) if lr_warmup >= 1 else 1.0
        if scheduler == "const":
            return init_lr * warm_factor
        tc = min(t, t_max)
        cos = final_lr + (init_lr - final_lr) * (1 + math.cos(math.pi * tc / t_max)) / 2
        return cos * warm_factor

    return schedule


class AdamP(torch.optim.Optimizer):
    """AdamP (Heo et al. 2021): Adam whose update is projected onto the tangent
    space of scale-invariant parameters, with timm's semantics as the JAX
    package transcribes them (novic_tpu.train.optim.adamp):

    * moments mu, nu with bias correction; the Nesterov perturbation
      (b1 * mu + (1 - b1) * g) / denom when `nesterov`, else mu / denom;
    * for ndim > 1, the channel view (rows = dim 0), then the layer view (one
      row): where max |cos(g, p)| over the rows is below delta/sqrt(row size),
      the radial component of the perturbation is removed and weight decay is
      scaled by wd_ratio. torch.where picks the view, so nothing waits on the
      device;
    * decay lr * weight_decay * wd_ratio-or-1 * p from the pre-step parameter,
      only where the mask holds (ndim >= 2, or every parameter with
      weight_decay_1d).

    Scalars are float32, as inject_hyperparams holds them. State: per
    parameter "mu" and "nu"; the group's "count" (optax's {count, mu, nu}).
    """

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.0, delta: float = 0.1, wd_ratio: float = 0.1,
                 nesterov: bool = True, weight_decay_1d: bool = False):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        delta=delta, wd_ratio=wd_ratio, nesterov=nesterov,
                        weight_decay_1d=weight_decay_1d, count=0)
        super().__init__(params, defaults)

    @staticmethod
    def view_cosine(p: torch.Tensor, g: torch.Tensor, rows: int, eps: float):
        """(max over `rows` rows of p of |cos(p_row, g_row)|, a 0-d tensor; the
        rows' norms + eps)."""
        pv, gv = p.reshape(rows, -1), g.reshape(rows, -1)
        p_norm = torch.linalg.vector_norm(pv, dim=1) + eps
        g_norm = torch.linalg.vector_norm(gv, dim=1) + eps
        return ((pv * gv).sum(dim=1).abs() / p_norm / g_norm).max(), p_norm

    @staticmethod
    def threshold(delta: float, row_size: int) -> float:
        """delta / sqrt(row size), rounded as the float32 hyperparameter divides."""
        return float(np.float32(delta) / np.float32(math.sqrt(row_size)))

    @staticmethod
    def _view(p, g, pert, eps: float, delta: float, rows: int):
        """(cosine test, projected perturbation) over `rows` rows of p."""
        cos, p_norm = AdamP.view_cosine(p, g, rows, eps)
        cond = cos < AdamP.threshold(delta, p.numel() // rows)
        p_n = (p.reshape(rows, -1) / p_norm[:, None]).reshape(p.shape)
        radial = (p_n * pert).reshape(rows, -1).sum(dim=1)
        return cond, pert - p_n * radial.reshape((rows,) + (1,) * (p.dim() - 1))

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            group["count"] += 1
            b1, b2 = f32(group["betas"][0]), f32(group["betas"][1])
            eps, delta, lr = f32(group["eps"]), f32(group["delta"]), f32(group["lr"])
            bias1 = f32(1) - b1 ** f32(group["count"])
            bias2 = f32(1) - b2 ** f32(group["count"])
            sqrt_bias2, step_size = float(np.sqrt(bias2)), float(-(lr / bias1))
            decay = float(lr * f32(group["weight_decay"]))
            c1, c2 = float(f32(1) - b1), float(f32(1) - b2)
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                if not st:
                    st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                mu, nu = st["mu"], st["nu"]
                mu.mul_(float(b1)).add_(g * c1)
                nu.mul_(float(b2)).add_(g * c2 * g)
                denom = nu.sqrt() / sqrt_bias2 + float(eps)
                pert = (mu * float(b1) + g * c1) / denom if group["nesterov"] else mu / denom
                wd = None
                if p.dim() > 1:
                    c_cond, c_proj = self._view(p, g, pert, float(eps), delta, p.shape[0])
                    l_cond, l_proj = self._view(p, g, pert, float(eps), delta, 1)
                    pert = torch.where(c_cond, c_proj, torch.where(l_cond, l_proj, pert))
                    wd = torch.where(c_cond | l_cond, float(f32(group["wd_ratio"])), 1.0)
                upd = pert * step_size
                if group["weight_decay_1d"] or p.dim() >= 2:
                    upd = upd - (p * decay if wd is None else p * (wd * decay))
                p.add_(upd)
        return None


def create_optimizer(named_params: Iterable[tuple[str, torch.nn.Parameter]], *,
                     beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
                     weight_decay: float = 0.1, weight_decay_1d: bool = False,
                     optimizer: str = "AdamW",
                     nesterov: bool = True) -> torch.optim.Optimizer:
    """AdamW over `named_params`, decaying every parameter by weight_decay if
    weight_decay_1d and none otherwise (see the module docstring), or AdamP;
    lr starts at 0 and is set per step by the train step."""
    name = optimizer.lower()
    params = [p for _, p in named_params]
    if name == "adamp":
        return AdamP(params, lr=0.0, betas=(beta1, beta2), eps=eps, weight_decay=weight_decay,
                     nesterov=nesterov, weight_decay_1d=weight_decay_1d)
    if name != "adamw":
        raise ValueError(f"Unsupported optimizer: {optimizer} (AdamW | AdamP)")
    group = {"params": params,
             "weight_decay": weight_decay if weight_decay_1d else 0.0,
             "weight_decay_hparam": weight_decay}
    return torch.optim.AdamW([group], lr=0.0, betas=(beta1, beta2), eps=eps)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of all elements (a device scalar, no sync)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by min(1, max_norm / norm); return the pre-clip norm
    (the JAX package's clip_by_global_norm semantics)."""
    norm = global_norm(grads)
    scale = (max_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
    for g in grads:
        g.mul_(scale)
    return norm
