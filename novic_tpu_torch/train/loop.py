"""Chunked training loop with checkpoint policy and resume (the counterpart of
novic_tpu.train.loop; reference train.py:977-1479).

Training proceeds in chunks of `chunk_batches` loader batches; the LR advances
per chunk; EWA loss/top-1 are tracked with a half-life in chunks; checkpoints
are saved every save_every_max chunks, or after save_every_min chunks once EWA
top-1 reaches save_top1_min, has plateaued (< save_top1_delta gain) and is a
new max (train.py:1349-1361); resume restores the optimizer, loop counters and
chunk-based LR schedule.

The host loop does the bookkeeping: it groups `accum_size` loader batches
into one accumulated optimizer step (train/step.py) and reads each step's
metrics one step late, after the next step has been launched, so the card
always has a step queued. `profile_dir` records a torch.profiler trace of the
first trained chunk to <profile_dir>/trace.json. The trace carries the
program's spans (utils/trace.py) as user annotations beside its operators
and kernels: `train.step` around each call of the optimizer step,
`loader.wait` where the loop waits for a batch, and the producer thread's
`loader.produce`.

Data parallelism (`mesh`, parallel/mesh.py): every rank iterates the same
loader (same seed) and moves only its rows of each loader batch to its device
(the batch axis: dim 0, or dim 1 of multi_first (M, B, ...) targets); the
step (train/step.py) makes the update equal one device's. The counters count
the whole batch. Only the caller's rank-0 `metrics` and `save_fn` write.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from novic_tpu_torch.bridge import adamw_state_from_reference, opt_state_from_leaves
from novic_tpu_torch.data.noise import EmbeddingNoise
from novic_tpu_torch.parallel.mesh import shard_rows
from novic_tpu_torch.train.optim import create_optimizer, lr_schedule_per_chunk
from novic_tpu_torch.train.step import EwaMetrics, TrainRng, TrainState, make_train_step
from novic_tpu_torch.utils.logger import log
from novic_tpu_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass
class TrainLoopConfig:
    """Static loop configuration (ref train.py TrainLoopConfig)."""

    chunk_batches: int          # batches per chunk
    chunk_samples: int          # samples per chunk
    epoch_batches: int          # batches per epoch
    max_chunks: int             # total chunks to train
    accum_size: int = 1
    gradient_clip: float = 1.0
    loss_ewa_halflife: float = 4.0
    save_every_min: int = 12
    save_every_max: int = 48
    save_top1_min: float = 0.95
    save_top1_delta: float = 0.005
    # Optimizer steps per call of the step function (train/step.py steps_per_call);
    # the K steps run in order, exactly as K single calls
    steps_per_dispatch: int = 1
    init_lr: float = 1.5e-3
    final_lr: float = 0.0
    lr_scheduler: str = "cosine"
    lr_warmup: int = 0
    last_dropout_chunks: int = 0     # rescale dropout this many chunks before the end (0 = off)
    last_dropout_factor: float = 0.0  # dropout rescale factor for the final chunks
    # load_lr_state=False resume: restart warmup + cosine horizon from the
    # resumed chunk instead of continuing the original schedule
    lr_resume_fresh: bool = False


@dataclasses.dataclass
class TrainLoopState:
    """Mutable loop state (ref train.py TrainLoopState); checkpointed for resume."""

    epoch_id: int = 1
    chunk_id: int = 1
    batch_id: int = 1
    sample_id: int = 1
    epoch_batches_left: int = -1
    saved_num: int = 0
    saved_chunk_id: int = 0
    saved_ewa_train_top1_max: float = 0.0
    ewa_train_top1_last: float = 0.0
    allow_save_delta: bool = False
    rng_seed: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "TrainLoopState":
        return TrainLoopState(**d)


def _accum_concat(xs: list):
    """Concatenate one field of an accumulation group along the batch axis.

    Members may differ in trailing dims (the cache Dataset trims all-padding
    columns per batch, data/cache.py); padding them back with the format's own
    padding values (target id 0, padding-mask True, weight 0) reconstructs the
    untrimmed representation, so the combined batch is loss-identical."""
    if len(xs) == 1 or xs[0] is None:
        return xs[0]
    trailing = [max(x.shape[d] for x in xs) for d in range(1, xs[0].ndim)]
    pad_value = True if xs[0].dtype == torch.bool else 0

    def pad(x):
        if list(x.shape[1:]) == trailing:
            return x
        out = x.new_full((x.shape[0],) + tuple(trailing), pad_value)
        out[tuple(slice(0, s) for s in x.shape)] = x
        return out

    return torch.cat([pad(x) for x in xs], dim=0)


def compute_chunk_batches(num_valid_targets: int, chunk_scale: float, batch_size: int) -> int:
    """chunk_batches = ceil(num_valid_targets * chunk_scale / batch_size) (ref train.py:990)."""
    return max(int(math.ceil(num_valid_targets * chunk_scale / batch_size)), 1)


def _host(x) -> torch.Tensor:
    """A loader batch member as a tensor (numpy is copied: it may view the
    cache's read-only memory map)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None):
    """Loader batch member → tensor on the training device (device tensors pass)."""
    if x is None:
        return None
    x = _host(x).to(device, non_blocking=True)
    return x.to(dtype) if dtype is not None else x


def train(
    *,
    model: torch.nn.Module,
    loader,                      # batch loader over a loaded, configured dataset
    C: TrainLoopConfig,
    S: Optional[TrainLoopState] = None,
    noise: Optional[EmbeddingNoise] = None,
    mean_shift: Optional[np.ndarray] = None,
    multi_first: bool = False,
    beta1: float = 0.9,
    beta2: float = 0.95,
    weight_decay: float = 0.1,
    weight_decay_1d: bool = False,
    optimizer: str = "AdamW",
    nesterov: bool = True,
    opt_state_arrays: Optional[Any] = None,   # resume: optax leaf list
    opt_moments: Optional[dict] = None,       # resume: a reference checkpoint's AdamW moments
    metrics: Optional[MetricsLogger] = None,
    save_fn=None,                # callable(chunk_id, state, S) -> path, or None
    profile_dir: Optional[str] = None,
    mesh=None,                   # parallel.mesh.Mesh: data-parallel over its 'data' axis
):
    """Run the training loop on the model's device; returns (TrainState,
    TrainLoopState, EwaMetrics)."""
    S = S or TrainLoopState()
    device = next(model.parameters()).device
    opt = create_optimizer(model.named_parameters(), beta1=beta1, beta2=beta2,
                           weight_decay=weight_decay, weight_decay_1d=weight_decay_1d,
                           optimizer=optimizer, nesterov=nesterov)
    state = TrainState(model=model, optimizer=opt)
    if opt_state_arrays is not None:
        state.step = opt_state_from_leaves(model, opt, list(opt_state_arrays))
    elif opt_moments is not None:
        if isinstance(opt, torch.optim.AdamW):
            state.step = adamw_state_from_reference(model, opt, opt_moments)
        else:
            log.warning(f"The checkpoint holds AdamW moments, not {optimizer}'s => "
                        f"optimizer restarts")
    model.train()

    K = max(C.steps_per_dispatch, 1)
    step_kwargs = dict(noise=noise, mean_shift=mean_shift, gradient_clip=C.gradient_clip,
                       accum_steps=C.accum_size, multi_first=multi_first, mesh=mesh)
    step = make_train_step(state, **step_kwargs)
    step_multi = make_train_step(state, steps_per_call=K, **step_kwargs) if K > 1 else None

    def rescale_dropout(factor: float):
        """Rescale every dropout site's rate in place (ref train.py:1215-1217,1363)."""
        model.set_dropout(model.cfg.input_dropout * factor, model.cfg.layer_dropout * factor)

    dropout_trigger = (C.max_chunks - C.last_dropout_chunks + 1
                       if C.last_dropout_chunks >= 1 else None)
    if dropout_trigger is not None and S.chunk_id >= dropout_trigger:
        rescale_dropout(C.last_dropout_factor)
        dropout_trigger = None

    schedule = lr_schedule_per_chunk(C.init_lr, C.final_lr, C.lr_scheduler, C.lr_warmup,
                                     C.max_chunks,
                                     start_chunk=S.chunk_id if C.lr_resume_fresh else 1)
    A = max(C.accum_size, 1)
    if multi_first and A > 1:
        raise ValueError("accum_factor > 1 requires batch-major data (multi_first=False)")
    # EWA half-life is in chunks; updates arrive once per optimizer step
    # (= accum_size loader batches), so the per-update factor scales with A
    ewa = EwaMetrics.create(C.loss_ewa_halflife, max(C.chunk_batches / A, 1e-9))
    rng = TrainRng.create(S.rng_seed, device)

    if S.epoch_batches_left < 0:
        S.epoch_batches_left = C.epoch_batches
    elif S.epoch_batches_left == 0:
        S.epoch_batches_left = C.epoch_batches
        S.epoch_id += 1

    stop_training = S.chunk_id >= C.max_chunks + 1
    profiler = None
    if profile_dir and not stop_training:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        # profile_all_threads: the trace also follows the loader's producer,
        # a thread started during the session
        profiler = profile(activities=activities,
                           experimental_config=_ExperimentalConfig(profile_all_threads=True))
        profiler.__enter__()
        log.info(f"Profiling chunk {S.chunk_id} to {profile_dir}")
    grad_norms: list[float] = []
    chunk_sums = [0.0, 0.0]  # the chunk's loss_sum, loss_basis (its mean loss, not the EWA)
    pending = None  # one-step delayed metrics fetch: the card always has a step queued
    start_time = time.perf_counter()
    chunk_start = start_time

    def consume(pending_metrics):
        m = pending_metrics.fetch()
        for i in range(int(np.size(m["loss_sum"]))):  # (K,)-stacked from a multi-step call
            vals = [float(np.ravel(m[k])[i]) for k in ("loss_sum", "loss_basis", "correct", "tokens")]
            ewa.update(*vals)
            chunk_sums[0] += vals[0]
            chunk_sums[1] += vals[1]
            grad_norms.append(float(np.ravel(m["grad_norm"])[i]))

    accum_buf: list = []  # loader batches awaiting one accumulated optimizer step
    group_buf: list = []  # complete (batch_tuple, lr) groups awaiting a multi-step call

    def launched(m):
        nonlocal pending
        # Step t is queued; only now wait for step t-1's metrics
        if pending is not None:
            consume(pending)
        pending = m

    def dispatch_group():
        """A full K-group goes out as one multi-step call; a partial buffer
        (chunk-end flush) drains through the single step."""
        if not group_buf:
            return
        groups = list(group_buf)
        group_buf.clear()
        if len(groups) == K and K > 1:
            launched(step_multi([bt for bt, _ in groups], [lr_ for _, lr_ in groups], rng))
        else:
            for bt, lr_ in groups:
                launched(step(bt, lr_, rng))

    def dispatch_accum(lr_: float):
        """Concatenate the buffered loader batches into one meta-batch (the step
        splits it back into A microbatches) and dispatch it, now (K=1) or K at a time."""
        batch_tuple = tuple(_accum_concat([b[j] for b in accum_buf]) for j in range(4))
        accum_buf.clear()
        if K <= 1:
            launched(step(batch_tuple, lr_, rng))
            return
        group_buf.append((batch_tuple, lr_))
        if len(group_buf) == K:
            dispatch_group()

    while not stop_training:
        log.info("-" * 60)
        log.info(f"Epoch {S.epoch_id} | Batch {S.batch_id} | Sample {S.sample_id}")

        for batch in loader:
            chunk_batch_id = (S.batch_id - 1) % C.chunk_batches
            if chunk_batch_id == 0:
                log.info(f"Chunk {S.chunk_id} | Batch {S.batch_id} | Sample {S.sample_id}")
                chunk_start = time.perf_counter()

            lr = schedule(S.chunk_id)
            embed, target, mask, weight = batch
            local = batch
            if mesh is not None:  # this rank's rows, before the copy to the device
                tdim = 1 if multi_first and np.ndim(target) == 3 else 0
                local = tuple(None if x is None
                              else shard_rows(_host(x), mesh, dim=d).contiguous()
                              for x, d in zip(batch, (0, tdim, tdim, tdim)))
            accum_buf.append((_tensor(local[0], device, torch.float32), _tensor(local[1], device),
                              _tensor(local[2], device),
                              _tensor(local[3], device, torch.float32)))
            if len(accum_buf) == A:
                dispatch_accum(lr)

            S.sample_id += embed.shape[0]
            S.batch_id += 1
            S.epoch_batches_left -= 1

            if chunk_batch_id == C.chunk_batches - 1:
                dispatch_group()  # the chunk's metrics/checkpoint reflect every step
                if pending is not None:
                    consume(pending)
                    pending = None
                chunk_time = time.perf_counter() - chunk_start
                gns = np.asarray(grad_norms) if grad_norms else np.zeros(1)
                log.info(
                    f"Trained chunk {S.chunk_id} in {chunk_time:.1f}s at "
                    f"{C.chunk_samples / max(chunk_time, 1e-9):.0f} noun/s: lr={lr:.2e}, "
                    f"loss={ewa.loss:.3e}, top1={ewa.top1:.3%} "
                    f"(grad norm {gns.min():.3g}..{gns.max():.3g})")
                if metrics:
                    metrics.log(dict(chunk=S.chunk_id, batch=S.batch_id - 1,
                                     sample=S.sample_id - 1, lr=lr, loss=ewa.loss,
                                     top1=ewa.top1 * 100, top1_max=ewa.top1_max * 100,
                                     chunk_loss=chunk_sums[0] / max(chunk_sums[1], 1e-12),
                                     chunk_time=chunk_time,
                                     grad_norm_min=float(gns.min()),
                                     grad_norm_mean=float(gns.mean()),
                                     grad_norm_max=float(gns.max()),
                                     saved_num=S.saved_num))
                grad_norms.clear()
                chunk_sums[:] = [0.0, 0.0]

                S.chunk_id += 1
                if profiler is not None:
                    profiler.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                    profiler = None
                if S.chunk_id >= C.max_chunks + 1:
                    stop_training = True

                if dropout_trigger is not None and S.chunk_id >= dropout_trigger:
                    log.info(f"Rescaling dropout by x{C.last_dropout_factor} for the "
                             f"final {C.last_dropout_chunks} chunks")
                    rescale_dropout(C.last_dropout_factor)
                    dropout_trigger = None

                # Checkpoint policy (ref train.py:1349-1361)
                save_chunk_id = S.chunk_id - 1
                chunks_since_save = save_chunk_id - S.saved_chunk_id
                if ewa.top1 >= C.save_top1_min and ewa.top1 - S.ewa_train_top1_last <= C.save_top1_delta:
                    S.allow_save_delta = True
                S.ewa_train_top1_last = ewa.top1
                should_save = stop_training or chunks_since_save >= C.save_every_max or (
                    chunks_since_save >= C.save_every_min and ewa.top1 >= C.save_top1_min
                    and S.allow_save_delta and ewa.top1 >= S.saved_ewa_train_top1_max)
                if should_save and save_fn is not None:
                    S.saved_num += 1
                    S.saved_chunk_id = save_chunk_id
                    S.saved_ewa_train_top1_max = max(S.saved_ewa_train_top1_max, ewa.top1)
                    save_fn(save_chunk_id, state, S)

                if stop_training:
                    break

            if S.epoch_batches_left == 0:
                break

        if S.epoch_batches_left == 0:
            S.epoch_batches_left = C.epoch_batches
            S.epoch_id += 1

    dispatch_group()  # flush any complete groups buffered at an early exit
    if accum_buf:
        # Stopping mid-meta-batch: the reference likewise discards partially
        # accumulated meta-batches at stop/resume (ref train.py:1431,1279).
        # Roll the counters back so the final state's batch/sample ids
        # describe exactly the samples that reached the optimizer.
        n_disc = len(accum_buf)
        disc_samples = sum(b[0].shape[0] for b in accum_buf)
        log.info(f"Discarding {n_disc} loader batches ({disc_samples} samples) of a "
                 f"partial accumulation group at stop")
        S.batch_id -= n_disc
        S.sample_id -= disc_samples * (mesh.axis_size("data") if mesh is not None else 1)
        accum_buf.clear()
    if pending is not None:
        consume(pending)
    if profiler is not None:
        profiler.__exit__(None, None, None)
    elapsed = time.perf_counter() - start_time
    log.info(f"Trained {S.chunk_id - 1} chunks in {elapsed:.1f}s "
             f"({S.batch_id - 1} batches = {S.sample_id - 1} samples)")
    model.eval()
    return state, S, ewa
