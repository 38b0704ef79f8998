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
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

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


def create_optimizer(named_params: Iterable[tuple[str, torch.nn.Parameter]], *,
                     beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
                     weight_decay: float = 0.1, weight_decay_1d: bool = False,
                     optimizer: str = "AdamW", nesterov: bool = True) -> torch.optim.AdamW:
    """AdamW over `named_params`, decaying every parameter by weight_decay if
    weight_decay_1d and none otherwise (see the module docstring); lr starts at
    0 and is set per step by the train step."""
    name = optimizer.lower()
    if name == "adamp":
        raise NotImplementedError("optimizer=AdamP is not ported yet (AdamW only)")
    if name != "adamw":
        raise ValueError(f"Unsupported optimizer: {optimizer} (AdamW | AdamP)")
    group = {"params": [p for _, p in named_params],
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
