"""The training step (the counterpart of novic_tpu.train.step).

One optimizer step per call (reference train.py:1252-1305): mean shift and
unit-sphere noise on the embeddings, the decoder forward with its loss
sum/basis decomposition, backward, gradient clipping (reporting the pre-clip
norm) and the AdamW update.

* Accumulation (accum_steps = A > 1): the batch is split into A microbatches
  and backward runs once per microbatch on mean_loss / A, so the gradients sum
  to the JAX package's lax.scan (mean of the microbatch gradients) and each
  microbatch's graph (its logits alone are B*C*V floats) is freed before the
  next one is built. The metrics are summed.
* steps_per_call = K > 1 runs K single steps in order; the JAX package pins
  its device-resident K-step scan equal to that.
* Nothing in the step waits for the device: the metrics stay device tensors,
  and `StepMetrics` copies them to pinned host memory behind an event, so the
  loop can read step t-1's numbers after launching step t without draining the
  card. The dropout sites draw their seeds from a CPU generator; the noise
  draws from a generator on the batch's device.
* Data parallelism (`mesh`, a parallel.mesh.Mesh with a 'data' axis): each
  rank holds its rows of every microbatch. The gradients equal one device's
  for the whole batch: each rank backpropagates its summed loss over the
  microbatch's global normaliser (the all-reduced loss basis, never a mean of
  per-rank means, since the ranks' mask counts differ), and the gradients are
  all-reduced (summed) before clipping, so grad_norm is the global one. The
  noise is drawn for the gathered microbatch on every rank from the same
  generator state, and each rank keeps its rows; the dropout sites draw the
  mask at this rank's element offset (FastDropout.shard_index). Both then
  equal one device's for batch-major data; with multi_first data (M, B, ...)
  the dropout masks are other draws than one device's. The metric sums are
  all-reduced too.
* Matmuls run in exact float32: TF32 stays off (torch.backends.cuda.matmul.
  allow_tf32 = False, the default), whatever the config's matmul_precision says.
  On the TPU, "default" meant one bf16 pass; a faster precision is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from novic_tpu_torch.data.noise import EmbeddingNoise, apply_mean_shift
from novic_tpu_torch.models.layers import FastDropout
from novic_tpu_torch.parallel.mesh import gather_rows, shard_rows
from novic_tpu_torch.train.optim import clip_by_global_norm, global_norm
from novic_tpu_torch.utils import trace

METRIC_KEYS = ("loss_sum", "loss_basis", "correct", "tokens", "grad_norm")


@dataclasses.dataclass
class TrainRng:
    """The step's random sources: `dropout` (CPU) gives the dropout sites' seed
    words, `noise` (on the batch's device) the embedding-noise draws."""

    dropout: torch.Generator
    noise: torch.Generator

    @staticmethod
    def create(seed: int, device: Union[str, torch.device]) -> "TrainRng":
        return TrainRng(dropout=torch.Generator().manual_seed(seed),
                        noise=torch.Generator(device=device).manual_seed(seed + 1))


@dataclasses.dataclass
class TrainState:
    """What the step updates in place: the model's parameters, the optimizer's
    state, and the optimizer step counter."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


class StepMetrics:
    """A step's metrics as device tensors ((5,), or (K, 5) for K steps), with an
    asynchronous copy to pinned host memory; `fetch` waits for that copy only."""

    def __init__(self, values: torch.Tensor):
        self.values = values
        if values.is_cuda:
            self._host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
            self._host.copy_(values, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()
        else:
            self._host, self._ready = values, None

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.values[..., METRIC_KEYS.index(key)]

    def fetch(self) -> dict[str, np.ndarray]:
        if self._ready is not None:
            self._ready.synchronize()
        arr = self._host.numpy()
        return {k: arr[..., i] for i, k in enumerate(METRIC_KEYS)}


def _split(x: Optional[torch.Tensor], parts: int) -> list:
    if x is None:
        return [None] * parts
    return list(x.reshape((parts, x.shape[0] // parts) + tuple(x.shape[1:])).unbind(0))


def make_train_step(
    state: TrainState,
    *,
    noise: Optional[EmbeddingNoise] = None,
    mean_shift=None,                 # optional (F,) array
    gradient_clip: float = 1.0,
    accum_steps: int = 1,
    multi_first: bool = False,
    steps_per_call: int = 1,
    mesh=None,                       # parallel.mesh.Mesh: data-parallel over its 'data' axis
) -> Callable:
    """Build the step: (batch, lr, rng) → StepMetrics, updating `state` in place.

    batch = (embed BxF, target, mask, weight) tensors on the model's device, with
    None members allowed (under `mesh`: this rank's rows). With steps_per_call
    = K > 1 the step takes (batches, lrs, rng) with K of each and returns (K, 5)
    metrics."""
    model, optimizer = state.model, state.optimizer
    params = list(model.parameters())
    device = params[0].device
    shift = (None if mean_shift is None
             else torch.as_tensor(np.asarray(mean_shift), dtype=torch.float32, device=device))
    dp_group = None
    if mesh is not None:
        dp_group = mesh.group("data")
        for m in model.modules():
            if isinstance(m, FastDropout):
                m.shard_index = mesh.axis_index("data")

    def all_reduce(x: torch.Tensor) -> torch.Tensor:
        if dp_group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=dp_group)
        return x

    def microbatch(batch, rng: TrainRng, scale: float) -> torch.Tensor:
        embed, target, mask, weight = batch
        embed = apply_mean_shift(embed.float(), shift)
        if noise is not None:
            if mesh is None:
                embed = noise(embed, rng.noise)
            else:  # the whole microbatch's draws, this rank's rows
                embed = shard_rows(noise(gather_rows(embed, mesh), rng.noise), mesh)
        _, padding, loss_sum, loss_basis, correct = model(
            embed, target, mask, weight, calc_loss=True, calc_correct=True, only_pred=False,
            guide_targets=None, multi_first=multi_first, deterministic=False,
            generator=rng.dropout)
        if padding is None:
            tokens = loss_sum.new_full((), float(target.numel()))
        else:
            tokens = padding.numel() - padding.sum()
        basis = all_reduce(loss_basis.detach().clone()) if dp_group is not None else loss_basis
        mean_loss = loss_sum / basis.clamp_min(1e-12)
        (mean_loss * scale).backward()
        return torch.stack([loss_sum.detach(), loss_basis.detach(), correct.sum().float(),
                            tokens.float()])

    def step_fn(batch, lr: float, rng: TrainRng) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if accum_steps <= 1:
            sums = microbatch(batch, rng, 1.0)
        else:
            parts = list(zip(*(_split(x, accum_steps) for x in batch)))
            sums = sum(microbatch(mb, rng, 1.0 / accum_steps) for mb in parts)
        for p in params:  # a parameter the loss does not reach still steps (zero grad)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if dp_group is not None:  # one all-reduce of every gradient and the metric sums
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads] + [sums.float()]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads] + [sums.numel()])):
                g.copy_(part.view_as(g))
            sums = flat[-sums.numel():].to(sums.dtype)
        if gradient_clip > 0:
            grad_norm = clip_by_global_norm(grads, gradient_clip)
        else:
            grad_norm = global_norm(grads)
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        optimizer.step()
        state.step += 1
        return torch.cat([sums, grad_norm.reshape(1)])

    def single_step_fn(batch, lr: float, rng: TrainRng) -> StepMetrics:
        with trace.span("train.step"):
            return StepMetrics(step_fn(batch, lr, rng))

    def multi_step_fn(batches, lrs, rng: TrainRng) -> StepMetrics:
        with trace.span("train.step", steps=len(batches)):
            return StepMetrics(torch.stack([step_fn(b, lr, rng) for b, lr in zip(batches, lrs)]))

    return single_step_fn if steps_per_call <= 1 else multi_step_fn


@dataclasses.dataclass
class EwaMetrics:
    """Exponentially-weighted training metrics with half-life in chunks
    (ref train.py:1051-1052,1288-1305)."""

    ewa_factor: float
    loss_sum: float = 0.0
    loss_basis: float = 0.0
    correct: float = 0.0
    tokens: float = 0.0
    top1_max: float = 0.0

    @staticmethod
    def create(halflife_chunks: float, chunk_batches: int) -> "EwaMetrics":
        # factor per batch so that the half-life equals halflife_chunks chunks
        factor = 0.5 ** (1.0 / max(halflife_chunks * chunk_batches, 1e-9))
        return EwaMetrics(ewa_factor=factor)

    def update(self, loss_sum: float, loss_basis: float, correct: float, tokens: float):
        f = self.ewa_factor
        self.loss_sum = self.loss_sum * f + loss_sum
        self.loss_basis = self.loss_basis * f + loss_basis
        self.correct = self.correct * f + correct
        self.tokens = self.tokens * f + tokens
        self.top1_max = max(self.top1_max, self.top1)

    @property
    def loss(self) -> float:
        return self.loss_sum / max(self.loss_basis, 1e-12)

    @property
    def top1(self) -> float:
        return self.correct / max(self.tokens, 1e-12)
