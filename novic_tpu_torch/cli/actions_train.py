"""action=train (the counterpart of novic_tpu.cli.actions_train.action_train;
reference train.py:977-1479): chunk math, mean shift + noise, training on one
device, EWA metrics, the checkpoint policy, AdamW or AdamP, and resume from
a native checkpoint written by either package (a .npz, or an .orbax directory:
checkpoint_format=orbax writes those) or from a reference torch .model/.train
(params, loop state and AdamW moments); save_torch_checkpoints=true writes a
reference .model beside each checkpoint.
embedding_dataset=NounDataset trains from text: batches come from the noun
cache (noun_cache=true) or are embedded by the text tower on the card while
training. action=fix_checkpoints retrofits target_nouns into checkpoints that
lack them (ref train.py:1487-1643): the .npz files and reference .model/.train.

With data_parallel=true and more than one rank (torchrun --nproc_per_node N,
or a process group the caller initialised), training is data-parallel over
the ranks when batch_size divides by their number (else it warns and each
rank trains alone); only rank 0 writes checkpoints, metrics and logs.
"""

from __future__ import annotations

import glob
import logging
import math
import os

import torch
import torch.distributed as dist

from novic_tpu_torch.bridge import decoder_from_numpy, opt_state_to_leaves
from novic_tpu_torch.cli.common import (
    check_loaded_config,
    find_checkpoints,
    gen_data_config,
    load_embedder,
    load_embedding_dataset,
    load_mean_shift,
    load_noun_dataset,
    make_run_dir,
    model_config_from_cfg,
    resolve_path,
    wandb_init_kwargs,
)
from novic_tpu_torch.data.grad_accum import GradAccum
from novic_tpu_torch.data.noise import EmbeddingNoise
from novic_tpu_torch.device import resolve
from novic_tpu_torch.models.base import count_params, create_decoder, verify_unused
from novic_tpu_torch.parallel.mesh import create_mesh, init_from_env
from novic_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_reference_checkpoint,
    read_reference_pickle,
    save_checkpoint,
    save_checkpoint_orbax,
    save_reference_checkpoint,
)
from novic_tpu_torch.train.loop import TrainLoopConfig, TrainLoopState, compute_chunk_batches, train
from novic_tpu_torch.utils.config import config_to_flat
from novic_tpu_torch.utils.logger import log
from novic_tpu_torch.utils.metrics import MetricsLogger


def action_train(cfg, device="cuda"):
    dev = init_from_env(device) if cfg.data_parallel else resolve(device)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    if not main_rank:
        log.setLevel(logging.WARNING)
    ckpt_fmt = str(cfg.get("checkpoint_format", "npz") or "npz").lower()
    if ckpt_fmt not in ("npz", "orbax"):
        raise ValueError(f"Unsupported checkpoint_format: {ckpt_fmt}")
    save = save_checkpoint_orbax if ckpt_fmt == "orbax" else save_checkpoint
    mesh = None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if cfg.data_parallel and world > 1:
        if cfg.batch_size % world == 0:
            mesh = create_mesh(device=dev)
            log.info(f"Data-parallel training over {world} devices")
        else:
            log.warning(f"batch_size {cfg.batch_size} not divisible by {world} devices => "
                        f"falling back to single-device training")
    embedder = load_embedder(cfg, load_model=False, device=dev)
    dataset = load_embedding_dataset(cfg, embedder, training=True)
    dc = gen_data_config(cfg, dataset)
    # Data-parallel: host batches, of which the loop moves this rank's rows to the device
    loader, info = dataset.create_loader(batch_size=cfg.batch_size, training=True, seed=cfg.seed,
                                         prefetch=cfg.loader_prefetch,
                                         device=dev if mesh is None else None,
                                         num_threads=int(cfg.get("dataset_workers", 4)))
    grad_accum = GradAccum(loader, info, accum_size=cfg.accum_factor)

    # Chunk math (ref train.py:990): chunk = num_valid_targets * chunk_scale samples
    chunk_batches = compute_chunk_batches(dataset.num_valid_targets, cfg.chunk_scale,
                                          cfg.batch_size)
    epoch_batches = grad_accum.loader_batches
    if cfg.max_chunks > 0:
        max_chunks = cfg.max_chunks
    else:
        max_chunks = max(int(math.floor(cfg.max_epochs * epoch_batches / chunk_batches)), 1)
    log.info(f"Chunks of {chunk_batches} batches; training {max_chunks} chunks "
             f"(~{max_chunks * chunk_batches / max(epoch_batches, 1):.1f} epochs)")

    model_cfg = model_config_from_cfg(cfg, embedder)

    # Resume (ref train.py:1057-1101)
    S = TrainLoopState(rng_seed=cfg.seed)
    opt_arrays = opt_moments = None
    lr_params = dict(init_lr=cfg.init_lr, final_lr=cfg.final_lr,
                     lr_scheduler=cfg.lr_scheduler, lr_warmup=cfg.lr_warmup)
    lr_resume_fresh = False
    ckpts = find_checkpoints(cfg)
    if ckpts:
        if ckpts[-1].endswith((".model", ".train")):
            # Params, loop counters and the AdamW moments (by name, through the
            # params' name map); the optimizer restarts where they are absent
            ckpt = load_reference_checkpoint(ckpts[-1])
            log.info("Resuming from a REFERENCE torch checkpoint"
                     + ("" if ckpt["opt_moments"] is not None else ": optimizer state restarts"))
        else:
            ckpt = load_checkpoint(ckpts[-1])
        check_loaded_config(ckpt["cfg_flat"], config_to_flat(cfg))
        model = decoder_from_numpy(model_cfg, ckpt["params"]).to(dev)
        verify_unused(model, model_cfg)
        if cfg.load_train_state and ckpt["train_meta"].get("loop_state"):
            S = TrainLoopState.from_dict(ckpt["train_meta"]["loop_state"])
            opt_arrays, opt_moments = ckpt["opt_arrays"], ckpt.get("opt_moments")
            log.info(f"Resumed training state at chunk {S.chunk_id}")
            if cfg.load_lr_state:
                ck = ckpt["cfg_flat"]
                lr_params = {k: ck.get(k, lr_params[k]) for k in lr_params}
                log.info(f"Resuming checkpoint LR schedule: {lr_params}")
            else:
                lr_resume_fresh = True
                log.info("load_lr_state=false => restarting LR schedule at the resumed chunk")
    else:
        model = create_decoder(model_cfg, generator=torch.Generator().manual_seed(cfg.seed),
                               device=dev)
    pc = count_params(model, model_cfg)
    unused_str = f" + {pc['unused']} unused" if pc["unused"] else ""
    log.info(f"Decoder {model_cfg.model}: {pc['used']} params{unused_str} on {dev}")

    noise = EmbeddingNoise.create(cfg.noise_scheme, embed_dim=embedder.embed_dim,
                                  vec_norm=cfg.noise_vec_norm, angle_min=cfg.noise_angle_min,
                                  angle_max=cfg.noise_angle_max, angle_std=cfg.noise_angle_std,
                                  mix_ratio=cfg.noise_mix_ratio)
    mean_shift = load_mean_shift(cfg, embedder)

    run_dir = make_run_dir(cfg) if main_rank else None
    stamp = os.path.basename(run_dir)[len("ovod_"):] if main_rank else None
    metrics = (MetricsLogger(run_dir=run_dir, use_wandb=cfg.use_wandb,
                             wandb_kwargs=wandb_init_kwargs(cfg), project=cfg.wandb_project,
                             config=config_to_flat(cfg)) if main_rank else None)

    C = TrainLoopConfig(
        chunk_batches=chunk_batches, chunk_samples=chunk_batches * cfg.batch_size,
        epoch_batches=epoch_batches, max_chunks=max_chunks, accum_size=cfg.accum_factor, gradient_clip=cfg.gradient_clip,
        steps_per_dispatch=int(cfg.get("steps_per_dispatch", 1) or 1),
        loss_ewa_halflife=cfg.loss_ewa_halflife, save_every_min=cfg.save_every_min,
        save_every_max=cfg.save_every_max, save_top1_min=cfg.save_top1_min / 100.0,
        save_top1_delta=cfg.save_top1_delta / 100.0, **lr_params,
        last_dropout_chunks=cfg.last_dropout_chunks,
        last_dropout_factor=cfg.last_dropout_factor, lr_resume_fresh=lr_resume_fresh)

    def save_fn(chunk_id, state, loop_state):
        verify_unused(state.model, model_cfg)
        path = os.path.join(run_dir, f"ovod_chunk{chunk_id:04d}_{stamp}.{ckpt_fmt}")
        params = {k: v.detach().cpu().numpy() for k, v in state.model.state_dict().items()}
        save(
            path, params=params, cfg_flat=config_to_flat(cfg), model_config=model_cfg,
            target_config=embedder.target_config, data_config=dc.as_dict(),
            target_nouns=dataset.targets, num_invalid_target_nouns=dataset.num_invalid_targets,
            opt_state_arrays=opt_state_to_leaves(state.model, state.optimizer,
                                                 weight_decay_1d=cfg.weight_decay_1d),
            train_meta={"loop_state": loop_state.as_dict(), "chunk_id": chunk_id})
        if cfg.save_torch_checkpoints:
            save_reference_checkpoint(
                os.path.splitext(path)[0] + ".model", params=params, model_config=model_cfg,
                target_config=embedder.target_config, target_nouns=dataset.targets,
                num_invalid_target_nouns=dataset.num_invalid_targets,
                cfg_flat=config_to_flat(cfg), data_config=dc.as_dict())
        return path

    with dataset.loaded():
        state, S, ewa = train(
            model=model, loader=grad_accum.loader(), C=C, S=S, noise=noise, mean_shift=mean_shift,
            multi_first=dc.multi_first, beta1=cfg.beta1, beta2=cfg.beta2,
            weight_decay=cfg.weight_decay, weight_decay_1d=cfg.weight_decay_1d,
            optimizer=cfg.optimizer, nesterov=cfg.nesterov,
            opt_state_arrays=opt_arrays, opt_moments=opt_moments, metrics=metrics,
            save_fn=save_fn if main_rank else None,
            profile_dir=(cfg.get("profile_dir", "") or None) if main_rank else None, mesh=mesh)
    if metrics is not None:
        metrics.finish()
    log.info(f"Training finished: loss {ewa.loss:.4e}, top1 {ewa.top1:.3%} "
             f"(max {ewa.top1_max:.3%}); run dir {run_dir}")
    return state, S, ewa


def action_fix_checkpoints(cfg, device="cuda"):
    """Retrofit target_nouns into checkpoints missing them: the native .npz
    files and the reference's .train/.model pickles (read audited, written
    back with torch.save). Supports dry_run. The nouns come from the noun
    dataset's vocabulary; no tower runs."""
    dev = resolve(device)
    output_dir = resolve_path(cfg, cfg.output_dir)
    dry = bool(cfg.get("dry_run"))
    fixed = scanned = 0
    target_nouns = None  # computed lazily, once

    def get_target_nouns():
        nonlocal target_nouns
        if target_nouns is None:
            embedder = load_embedder(cfg, load_model=False, device=dev)
            dataset = load_noun_dataset(cfg, embedder, use_cache=False)
            # Checkpoint convention: row 0 is the invalid "" noun
            # (ref train.py:1546-1549 target_nouns_bin)
            target_nouns = (("",) + tuple(dataset.targets), 1)
        return target_nouns

    for path in sorted(glob.glob(os.path.join(output_dir, "ovod_*", "*.npz"))):
        scanned += 1
        try:
            ckpt = load_checkpoint(path)
        except Exception as e:
            log.warning(f"Skipping unreadable checkpoint {path}: {e}")
            continue
        if ckpt["target_nouns"]:
            continue
        nouns, num_invalid = get_target_nouns()
        if dry:
            log.info(f"[dry run] would fix {path} (+{len(nouns)} target nouns)")
            fixed += 1
            continue
        save_checkpoint(path, params=ckpt["params"], cfg_flat=ckpt["cfg_flat"],
                        model_config=ckpt["model_config"], target_config=ckpt["target_config"],
                        data_config=ckpt["data_config"], target_nouns=nouns,
                        num_invalid_target_nouns=num_invalid,
                        opt_state_arrays=ckpt["opt_arrays"], train_meta=ckpt["train_meta"])
        fixed += 1
        log.info(f"Fixed checkpoint: {path}")

    for pattern in ("*.train", "*.model"):
        for path in sorted(glob.glob(os.path.join(output_dir, "ovod_*", pattern))):
            scanned += 1
            try:
                ckpt = read_reference_pickle(path)
            except Exception as e:
                log.warning(f"Skipping unreadable torch checkpoint {path}: {e}")
                continue
            if "cfg_flat" not in ckpt:
                log.warning(f"Skipping {path}: not a reference checkpoint dict")
                continue
            if ckpt.get("target_nouns"):
                continue
            nouns, num_invalid = get_target_nouns()
            if dry:
                log.info(f"[dry run] would fix {path} (+{len(nouns)} target nouns)")
                fixed += 1
                continue
            ckpt["target_nouns"] = nouns
            ckpt["num_invalid_target_nouns"] = num_invalid
            torch.save(ckpt, path)
            fixed += 1
            log.info(f"Fixed torch checkpoint: {path}")
    log.info(f"fix_checkpoints: scanned {scanned}, fixed {fixed}"
             f"{' (dry run)' if dry else ''}")
    return fixed
