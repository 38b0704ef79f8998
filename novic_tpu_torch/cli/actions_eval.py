"""Evaluation, zero-shot, inference and results actions (the counterpart of
novic_tpu.cli.actions_eval).

Parity with the reference actions (reference train.py): embedder_zero_shot
(+ modality-gap measurement → JSON) :674-774, eval :1650-1868, eval_cls
:1875-2120, eval_cls_decoding :2127-2450 (+ gencfg grid :3788-3832), infer
:2457-2724 (predictions JSON schema :2699-2724), format_preds + PredictionScorer
:2731-2917 (+ extras/specificity scoring), format_wandb / format_metrics
(the results database) :2935-3336, class-name → vocab alignment :3999-4127.

Every action takes `device` (default cuda, which raises where CUDA is
missing): the towers and the decoder run there. The results actions
(format_*) run on the host; their tables are rendered here in tabulate's
"pretty" layout, without the tabulate package.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob
import json
import math
import os
import re
import shutil
import time
import unicodedata
from collections import Counter
from typing import Any, Optional, Sequence

import numpy as np
import torch

from novic_tpu_torch.cli.common import (
    find_checkpoints,
    gen_data_config,
    load_embedder,
    load_embedding_dataset,
    load_noun_dataset,
    make_run_dir,
    resolve_cache_path,
    resolve_path,
    wandb_init_kwargs,
)
from novic_tpu_torch.data.classification import (
    ClassificationLoader,
    load_image_dataset,
    load_image_dataset_prompts,
)
from novic_tpu_torch.data.cache import EmbeddingCache
from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.preprocess import load_images
from novic_tpu_torch.infer import (
    GenerationConfig,
    GenerationTask,
    GenerationTaskList,
    estimate_generation_cost,
    load_decoder_from_checkpoint,
    load_guide_targets,
)
from novic_tpu_torch.models.generate import generate_greedy
from novic_tpu_torch.utils.config import IMAGEDIR_TAG
from novic_tpu_torch.utils.config import config_to_flat as _flat_cfg
from novic_tpu_torch.utils.logger import log
from novic_tpu_torch.utils.metrics import MetricsLogger
from novic_tpu_torch.utils.misc import get_canon, json_dumps, make_indefinite

# ---------------------------------------------------------------------------
# Class-name ↔ vocab alignment (ref train.py:3999-4127)
# ---------------------------------------------------------------------------


def load_vocab_id_map(target_nouns: Sequence[str]) -> dict[str, set[int]]:
    """Canonical noun form → set of vocab indices (ref train.py:4108-4127)."""
    vocab_map: dict[str, set[int]] = {}
    for i, noun in enumerate(target_nouns):
        if not noun:
            continue
        canon = get_canon(noun, sanitize=True)
        vocab_map.setdefault(canon, set()).add(i)
    return vocab_map


def align_cls_class_targets(class_names: Sequence[str], target_nouns: Sequence[str]
                            ) -> list[list[str]]:
    """Map benchmark class names → lists of matching vocab nouns via canonical
    forms; unmatched classes align to an EMPTY list (they can never score
    correct; cache_cls rejects them) — ref train.py:4053-4106 semantics."""
    vocab_map = load_vocab_id_map(target_nouns)
    out = []
    unmatched = 0
    for name in class_names:
        canon = get_canon(name, sanitize=True)
        ids = vocab_map.get(canon)
        if ids:
            out.append([target_nouns[i] for i in sorted(ids)])
        else:
            unmatched += 1
            out.append([])
    if unmatched:
        log.warning(f"{unmatched}/{len(class_names)} class names have no vocab noun match")
    return out


# ---------------------------------------------------------------------------
# embedder_zero_shot (ref train.py:674-774)
# ---------------------------------------------------------------------------


def compute_text_embeddings(embedder, class_names: Sequence[str],
                            prompts: Sequence[tuple[str, bool]]) -> np.ndarray:
    """Per class: mean over the prompt ensemble, renormalized
    (ref train.py:3606-3628)."""
    out = np.empty((len(class_names), embedder.embed_dim), np.float32)
    for i, name in enumerate(class_names):
        texts = [p.format(noun=make_indefinite(name) if need_article else name)
                 for p, need_article in prompts]
        embeds = embedder.inference_text(texts)
        mean = embeds.mean(axis=0)
        out[i] = mean / max(np.linalg.norm(mean), 1e-12)
    return out


def action_embedder_zero_shot(cfg, device="cuda"):
    """Classic CLIP zero-shot eval; optional modality-gap measurement → JSON
    (ref train.py:674-774). The JSON's keys, 360-bin 0-180° histograms and
    mean_shift are the JAX package's; its cfg_embedder.device is the device
    the towers ran on ("cuda", "cpu", ...), where novic_tpu writes "tpu"."""
    dev = resolve(device)
    embedder = load_embedder(cfg, load_model=True, device=dev)
    names = cfg.cls_datasets or [cfg.cls_dataset]
    results = {}
    noun_prompts = None
    if not cfg.get("clip_prompts", True):
        # ref train.py:682-686: embed class names through the NOUN dataset's
        # compiled singular prompt templates instead of the CLIP ensembles
        nds = load_noun_dataset(cfg, embedder, use_cache=False)
        noun_prompts = tuple((p.template, p.need_article) for p in nds.singular_prompts)
    for ds_name in names:
        ds = load_image_dataset(ds_name, resolve_path(cfg, cfg.cls_dataset_root),
                                split=cfg.cls_split, variant="clip",
                                clean=bool(cfg.get("clip_clean", False)))
        prompts = (noun_prompts if noun_prompts is not None else
                   load_image_dataset_prompts(ds_name, cfg.zero_shot_prompts))
        text_embeds = compute_text_embeddings(embedder, ds.classes, prompts)
        loader = ClassificationLoader(ds, batch_size=cfg.batch_size_image,
                                      transform=embedder.get_image_transform(), shuffle=False)
        correct = total = 0
        # Angle stats (true-class + all-pairs) + histograms + mean-shift
        # accumulation in the reference gap-JSON schema (ref train.py:713-774)
        histc_min, histc_max, histc_bins = 0, 180, 360
        gap_n = gap_n_all = 0
        gap_mean = np.zeros(embedder.embed_dim, np.float64)
        angle_sum = angle_sq_sum = 0.0
        all_angle_sum = all_angle_sq_sum = 0.0
        angle_histc = np.zeros(histc_bins, np.int64)
        all_angle_histc = np.zeros(histc_bins, np.int64)
        edges = np.linspace(histc_min, histc_max, histc_bins + 1)
        for pixel, labels in loader:
            img_embeds = embedder.inference_image(pixel)
            logits = img_embeds @ text_embeds.T
            pred = logits.argmax(axis=1)
            correct += int((pred == labels).sum())
            total += len(labels)
            if cfg.measure_gap:
                all_ang = np.degrees(np.arccos(np.clip(logits, -1, 1)))
                all_angle_sum += all_ang.sum()
                all_angle_sq_sum += (all_ang ** 2).sum()
                all_angle_histc += np.histogram(all_ang, bins=edges)[0]
                gap_n_all += all_ang.size
                t = text_embeds[labels]
                gap_mean += (img_embeds - t).sum(axis=0)
                gap_n += len(labels)
                cos = np.clip((img_embeds * t).sum(axis=1), -1, 1)
                ang = np.degrees(np.arccos(cos))
                angle_sum += ang.sum()
                angle_sq_sum += (ang ** 2).sum()
                angle_histc += np.histogram(ang, bins=edges)[0]
        top1 = correct / max(total, 1)
        log.info(f"Zero-shot {ds_name}: top-1 {top1:.2%} ({correct}/{total})")
        results[ds_name] = top1
        if cfg.measure_gap:
            mean_shift = (gap_mean / max(gap_n, 1)).astype(np.float32)
            angle_mean = angle_sum / max(gap_n, 1)
            angle_std = float(np.sqrt(max(angle_sq_sum / max(gap_n, 1) - angle_mean ** 2, 0)))
            all_angle_mean = all_angle_sum / max(gap_n_all, 1)
            all_angle_std = float(np.sqrt(max(
                all_angle_sq_sum / max(gap_n_all, 1) - all_angle_mean ** 2, 0)))
            gap = {
                "cfg_embedder": {"device": str(dev), "allow_tf32": False,
                                 "embedder_spec": cfg.embedder,
                                 "embedder_amp": cfg.embedder_compute_dtype != "float32",
                                 "embedder_amp_bf16": cfg.embedder_compute_dtype == "bfloat16",
                                 "embedder_compile": True, "embedder_optimum": False},
                "cfg_cls": {"cls_dataset": ds_name, "cls_split": cfg.cls_split,
                            "clip_prompts": True},
                "all_angle_mean": all_angle_mean,
                "all_angle_std": all_angle_std,
                "all_angle_histc": {"min": histc_min, "max": histc_max, "bins": histc_bins,
                                    "counts": all_angle_histc.tolist()},
                "angle_mean": angle_mean,
                "angle_std": angle_std,
                "angle_histc": {"min": histc_min, "max": histc_max, "bins": histc_bins,
                                "counts": angle_histc.tolist()},
                "mean_shift": mean_shift.tolist(),
            }
            out_path = resolve_path(cfg, cfg.gap_output_path)
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with open(out_path, "w") as f:
                f.write(json_dumps(gap, indent=2))
            log.info(f"Wrote modality gap JSON (angle {angle_mean:.1f}±{angle_std:.1f}°, "
                     f"all {all_angle_mean:.1f}±{all_angle_std:.1f}°): {out_path}")
    return results


# ---------------------------------------------------------------------------
# eval: teacher-forced metrics over embedding datasets (ref train.py:1650-1868)
# ---------------------------------------------------------------------------


def _numpy(x) -> Optional[np.ndarray]:
    """A loader batch member (numpy or a tensor on any device) as numpy."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _device_tensor(x: Optional[np.ndarray], dev: torch.device, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.array(x)).to(dev)  # a copy: loader arrays may be read-only
    return t if dtype is None else t.to(dtype)


def _eval_debug_print(cfg, decoder, embed, first_target, sample_correct, guide):
    """Per-sample debug lines for the first eval batch: the teacher-forced
    target vs greedy predictions, guided (unguided) when eval_guided, colored
    by whole-noun correctness (ref train.py:1795-1811). `guide`: the guide ids
    on the decoder's device, or None."""
    tt = decoder.target_tokenizer
    n = min(len(embed), int(cfg.get("eval_debug_samples", 32) or 32))
    e = _device_tensor(np.asarray(embed[:n], np.float32), decoder.model.device)
    unguided = generate_greedy(decoder.model, e)[0].cpu().numpy()
    guided = None
    if guide is not None:
        guided = generate_greedy(decoder.model, e, guide_targets=guide)[0].cpu().numpy()
    tgts = tt.detokenize_target(first_target[:n])
    un_strs = tt.detokenize_target(unguided)
    g_strs = tt.detokenize_target(guided) if guided is not None else None
    for i in range(n):
        color = "\033[92m" if sample_correct[i] else "\033[91m"
        if g_strs is not None:
            print(f"{color}{tgts[i]} --> {g_strs[i]} ({un_strs[i]})\033[0m")
        else:
            print(f"{color}{tgts[i]} --> {un_strs[i]}\033[0m")


def action_eval(cfg, device="cuda"):
    """Teacher-forced loss + token top-1 + whole-noun top-1 per model over
    embedding datasets, at full reference fidelity (ref train.py:1650-1868):
    multi-target batches score whole-noun correctness as any-of-M, target
    weights feed the loss basis, and eval_guided applies guide-masked argmax
    inside the metric. Datasets iterate outer / models inner with per-model
    target-config translation, like the reference's eval_top1_metric.

    The decoder runs under torch.no_grad() in eval mode; with eval_train=true
    in train mode, its dropout seeds drawn from a CPU generator seeded by
    cfg.seed (the masks themselves are drawn on the decoder's device)."""
    dev = resolve(device)
    embedder = load_embedder(cfg, load_model=False, device=dev)
    ckpts = find_checkpoints(cfg)
    if not ckpts:
        raise ValueError("eval requires load_model/load_models")
    specs = cfg.embedding_datasets or [cfg.embedding_dataset]
    metrics = MetricsLogger(run_dir=make_run_dir(cfg), use_wandb=cfg.use_wandb,
                            wandb_kwargs=wandb_init_kwargs(cfg), project=cfg.wandb_project,
                            config=_flat_cfg(cfg))
    eval_train = bool(cfg.get("eval_train", False))
    results = {}
    for spec in specs:
        dataset = load_embedding_dataset(cfg, embedder, spec=spec, training=False)
        # Guide set = the DATASET's target nouns (ref train.py:1748 uses
        # dataset_embedder.target_vocab), captured before any checkpoint
        # reconfigures the embedder's target config.
        dataset_vocab = tuple(embedder.target_vocab or ())
        gen_data_config(cfg, dataset)
        dc = dataset.data_config
        for ckpt_path in ckpts:
            decoder = load_decoder_from_checkpoint(ckpt_path, embedder, device=dev)
            # Translate dataset tokens into the model's target config
            # (ref train.py:1745 dataset.set_translation)
            dataset.set_translation(embedder.target_config)
            guide = None
            if cfg.eval_guided and dataset_vocab:
                guide_ids, _ = load_guide_targets(decoder.target_tokenizer, dataset_vocab)
                guide = _device_tensor(guide_ids, dev)
            multi_first = bool(dc.multi_target and dc.multi_first)
            model = decoder.model.train(eval_train)
            generator = torch.Generator().manual_seed(cfg.seed or 0) if eval_train else None

            loss_sum = loss_basis = 0.0
            tok_correct = tok_total = 0.0
            noun_correct = 0
            num_samples = num_valid_targets = 0
            Cmax = decoder.cfg.token_length
            pos_correct = np.zeros(Cmax)
            pos_total = np.zeros(Cmax)
            batches = 0
            debug = bool(cfg.get("eval_debug", False))
            start_time = time.perf_counter()
            with dataset.loaded():
                loader, info = dataset.create_loader(batch_size=cfg.batch_size, training=False)
                for embed, target, mask, weight in loader:
                    embed = np.asarray(_numpy(embed), np.float32)
                    target = _numpy(target)
                    with torch.no_grad():
                        _, pad, ls, lb, correct = model(
                            _device_tensor(embed, dev), _device_tensor(target, dev),
                            _device_tensor(_numpy(mask), dev),
                            _device_tensor(_numpy(weight), dev, torch.float32),
                            calc_loss=True, calc_correct=True, guide_targets=guide,
                            multi_first=multi_first, deterministic=not eval_train,
                            generator=generator)
                    correct = correct.cpu().numpy()
                    pad_arr = None if pad is None else pad.cpu().numpy()
                    # Batch shape handling (ref train.py:1785-1796): target is
                    # (B,C) / (B,M,C) / (M,B,C); the last axis is the sequence.
                    multi_dim = (None if not dc.multi_target
                                 else 0 if dc.multi_first else 1)
                    batch_shape = target.shape[:-1]
                    B = embed.shape[0]
                    num_batch_targets = int(np.prod(batch_shape))
                    C = correct.shape[-1]

                    if pad_arr is not None:
                        valid_targets = ~pad_arr.all(axis=-1)  # fully-padded = invalid
                        num_valid_targets += int(valid_targets.sum())
                    else:
                        num_valid_targets += num_batch_targets

                    # Per-position token top-1 over ALL targets
                    sum_dims = tuple(range(correct.ndim - 1))
                    correct_seq = correct.sum(axis=sum_dims)
                    pos_correct[:C] += correct_seq
                    if pad_arr is None:
                        pos_total[:C] += num_batch_targets
                        batch_tokens = num_batch_targets * C
                    else:
                        padding_seq = pad_arr.sum(axis=sum_dims)
                        tokens_seq = num_batch_targets - padding_seq
                        pos_total[:C] += tokens_seq
                        batch_tokens = int(tokens_seq.sum())
                    tok_correct += float(correct_seq.sum())
                    tok_total += batch_tokens

                    # Whole-noun top-1: every non-padded token correct, target
                    # valid, and any-of-M across multi-targets
                    # (ref train.py:1788-1796)
                    ok = correct | (pad_arr if pad_arr is not None else False)
                    sample_correct = ok.all(axis=-1)
                    if pad_arr is not None:
                        sample_correct &= valid_targets
                    if multi_dim is not None:
                        sample_correct = sample_correct.any(axis=multi_dim)
                    noun_correct += int(sample_correct.sum())
                    num_samples += B

                    loss_sum += float(ls)
                    loss_basis += float(lb)

                    if debug:
                        # First-batch sample dump: target --> guided (unguided)
                        # greedy predictions, green/red by whole-noun
                        # correctness (ref train.py:1795-1811)
                        first_target = (target if multi_dim is None
                                        else target[0] if dc.multi_first
                                        else target[:, 0])
                        _eval_debug_print(cfg, decoder, embed, first_target,
                                          sample_correct, guide)
                        debug = False
                    batches += 1
                    if cfg.eval_batches and batches >= cfg.eval_batches:
                        break
            elapsed = time.perf_counter() - start_time
            pos_top1 = [float(c / t) if t > 0 else None
                        for c, t in zip(pos_correct, pos_total)]
            res = {"loss": loss_sum / max(loss_basis, 1e-9),
                   "token_top1": tok_correct / max(tok_total, 1e-9),
                   "noun_top1": noun_correct / max(num_samples, 1),
                   "pos_top1": pos_top1,
                   "tokens": int(tok_total),
                   "num_valid_targets": num_valid_targets,
                   "num_samples": num_samples, "num_batches": batches,
                   "elapsed_time": elapsed}
            pos_str = " ".join(f"{p:.1%}" if p is not None else "-" for p in pos_top1)
            log.info(f"eval[{os.path.basename(ckpt_path)} @ {spec}]: "
                     f"loss {res['loss']:.4e}, token top1 {res['token_top1']:.3%}, "
                     f"noun top1 {res['noun_top1']:.3%}, per-pos [{pos_str}] "
                     f"({num_samples} samples = {num_valid_targets} valid targets, "
                     f"{elapsed:.1f}s)")
            results[(ckpt_path, spec)] = res
            metrics.log({"model": os.path.basename(ckpt_path), "dataset": spec,
                         "loss": res["loss"], "token_top1": res["token_top1"],
                         "noun_top1": res["noun_top1"],
                         "tokens": res["tokens"],
                         "num_valid_targets": num_valid_targets,
                         "num_samples": num_samples,
                         **{f"top1_{i}": (p if p is not None else 0.0)
                            for i, p in enumerate(pos_top1, 1)}})
    metrics.finish()
    return results


# ---------------------------------------------------------------------------
# eval_cls: greedy-decode classification buckets (ref train.py:1875-2120)
# ---------------------------------------------------------------------------


def action_eval_cls(cfg, device="cuda"):
    """Per image: greedy prediction classified into Direct{Correct,Valid,Invalid}
    × Guided{Correct,Incorrect} buckets; optionally copies misclassified images
    into per-bucket result dirs (ref train.py:2006-2050)."""
    dev = resolve(device)
    save_mis = bool(cfg.get("eval_cls_save_misclassified", False))
    embedder = load_embedder(cfg, load_model=True, device=dev)
    ckpts = find_checkpoints(cfg)
    if not ckpts:
        raise ValueError("eval_cls requires load_model/load_models")
    ds = load_image_dataset(cfg.cls_dataset, resolve_path(cfg, cfg.cls_dataset_root),
                            split=cfg.cls_split, variant=cfg.class_names_variant,
                            clean=(cfg.class_names_variant == "clip"), paths=save_mis)
    loader = ClassificationLoader(ds, batch_size=cfg.batch_size_image,
                                  transform=embedder.get_image_transform(), shuffle=False)
    # Embed phase: embed dataset once, reuse per model (ref train.py:2244-2250)
    embeds_list, labels_list, paths_list = [], [], []
    for batch in loader:
        if save_mis:
            pixel, labels, batch_paths = batch
            paths_list.extend(batch_paths)
        else:
            pixel, labels = batch
        embeds_list.append(embedder.inference_image(pixel))
        labels_list.append(labels)
    all_embeds = np.concatenate(embeds_list)
    all_labels = np.concatenate(labels_list)

    metrics = MetricsLogger(run_dir=make_run_dir(cfg), use_wandb=cfg.use_wandb,
                            wandb_kwargs=wandb_init_kwargs(cfg), project=cfg.wandb_project,
                            config=_flat_cfg(cfg))
    results = {}
    for ckpt_path in ckpts:
        decoder = load_decoder_from_checkpoint(ckpt_path, embedder, device=dev)
        class_targets = align_cls_class_targets(ds.classes, ("",) + decoder.target_vocab)
        vocab_ids, vocab_strs = load_guide_targets(decoder.target_tokenizer, decoder.target_vocab)
        direct = GenerationTask(
            gencfg=GenerationConfig.from_name("greedy_k1_vnone_gn_t1_a0"), decoder=decoder,
            vocab_targets_set=set(vocab_strs), vocab_targets=vocab_ids,
            guide_targets_set=set(vocab_strs), guide_targets=None,
            class_lists=class_targets)
        guided = GenerationTask(
            gencfg=GenerationConfig.from_name("greedy_k1_vnone_gp_t1_a0"), decoder=decoder,
            vocab_targets_set=set(vocab_strs), vocab_targets=vocab_ids,
            guide_targets_set=set(vocab_strs), guide_targets=vocab_ids,
            class_lists=class_targets)
        buckets = {f"direct_{d}_guided_{g}": 0
                   for d in ("correct", "valid", "invalid") for g in ("correct", "incorrect")}
        mis_dir = None
        if save_mis:
            mis_dir = os.path.join(make_run_dir(cfg), "misclassified",
                                   os.path.basename(ckpt_path))
        B = cfg.batch_size_image
        for i in range(0, len(all_embeds), B):
            chunk = all_embeds[i:i + B]
            cls_idx = all_labels[i:i + B].tolist()
            direct.process(chunk, class_indices=cls_idx)
            guided.process(chunk, class_indices=cls_idx)
            d_res = direct.result[:, 0]
            g_corr = guided.correct[:, 0]
            for j, (dr, gc) in enumerate(zip(d_res.tolist(), g_corr.tolist())):
                d = "correct" if dr == 0 else ("valid" if dr in (1, 2) else "invalid")
                g = "correct" if gc else "incorrect"
                buckets[f"direct_{d}_guided_{g}"] += 1
                if mis_dir is not None and (d != "correct" or g != "correct"):
                    src = paths_list[i + j]
                    if src:
                        bucket_dir = os.path.join(mis_dir, f"direct_{d}_guided_{g}")
                        os.makedirs(bucket_dir, exist_ok=True)
                        pred = direct.target_str[j][0].replace(" ", "_")
                        dst = os.path.join(bucket_dir, f"{pred}__{os.path.basename(src)}")
                        shutil.copy2(src, dst)
        total = len(all_embeds)
        direct_top1 = direct.topk[0]
        guided_top1 = guided.topk[0]
        log.info(f"eval_cls[{os.path.basename(ckpt_path)} @ {cfg.cls_dataset}]: "
                 f"direct top1 {direct_top1:.2%}, guided top1 {guided_top1:.2%}, "
                 f"buckets {buckets}")
        results[ckpt_path] = {"direct_top1": float(direct_top1),
                              "guided_top1": float(guided_top1),
                              "buckets": buckets, "total": total}
        metrics.log({"model": os.path.basename(ckpt_path), "dataset": cfg.cls_dataset,
                     "direct_top1": float(direct_top1), "guided_top1": float(guided_top1),
                     "total": total, **buckets})
    metrics.finish()
    return results


# ---------------------------------------------------------------------------
# eval_cls_decoding (ref train.py:2127-2450)
# ---------------------------------------------------------------------------


def load_generation_config(cfg, **default_kwargs) -> GenerationConfig:
    """cfg.gencfg by name, else a greedy default overridden by default_kwargs
    (ref train.py:3775-3786)."""
    if cfg.gencfg:
        name = cfg.gencfg
    else:
        default = dict(method="greedy", topk=1, vocab_prior=False,
                       vocab_per_token=False, vocab_scaler=0, guided=False,
                       guide_renorm=False, temperature=1, length_alpha=0)
        name = GenerationConfig(**{**default, **default_kwargs}).name
    return GenerationConfig.from_name(name)


def load_generation_configs(cfg, **default_kwargs) -> list[GenerationConfig]:
    """Explicit gencfgs + optional grid sweep over the reference's axes
    (gencfg_method/topk/prior/guide/tau/alpha) with the greedy-irrelevant-axis
    coercions, via the value -> name -> parse round trip and ordered dedup
    (ref train.py:3788-3832). Falls back to load_generation_config."""
    specs = list(cfg.gencfgs or ())
    if cfg.gencfgs_grid:
        for method in cfg.gencfg_method:
            is_greedy = method == "greedy"
            for topk in cfg.gencfg_topk:
                if is_greedy:
                    topk = 1
                for prior in cfg.gencfg_prior:
                    if prior == "none" or is_greedy:
                        vocab_prior, vocab_per_token, vocab_scaler = False, False, 0
                    else:
                        vocab_prior = True
                        match = re.fullmatch(r"(tok|tgt)(.*)", prior)
                        try:
                            vocab_per_token = match.group(1) == "tok"
                            vocab_scaler = float(match.group(2))
                        except (AttributeError, ValueError):
                            raise ValueError(
                                f"Could not parse gencfg prior spec {prior!r}")
                    for guide in cfg.gencfg_guide:
                        if guide not in ("none", "plain", "renorm"):
                            raise ValueError(
                                f"Invalid generation configuration guiding "
                                f"specification: {guide}")
                        if is_greedy and guide == "renorm":
                            guide = "plain"  # same decoded noun, different scores
                        guided = guide != "none" or method == "all"
                        guide_renorm = guide == "renorm"
                        for tau in cfg.gencfg_tau:
                            if is_greedy:
                                tau = 1
                            for alpha in cfg.gencfg_alpha:
                                if is_greedy:
                                    alpha = 0
                                specs.append(GenerationConfig(
                                    method=method, topk=topk, vocab_prior=vocab_prior,
                                    vocab_per_token=vocab_per_token,
                                    vocab_scaler=vocab_scaler, guided=guided,
                                    guide_renorm=guide_renorm, temperature=tau,
                                    length_alpha=alpha).name)
    if specs:
        return [GenerationConfig.from_name(n) for n in dict.fromkeys(specs)]
    return [load_generation_config(cfg, **default_kwargs)]


def budget_gencfgs(cfg, gencfgs, num_images: int, num_guide_targets: int):
    """Estimate per-gencfg decode cost up front (estimate_generation_cost, the
    card's constants), log the totals, and skip members above max_gencfg_cost
    seconds (0 = log only). Guard for grids that include exhaustive-'all'
    members at FT0 scale, which otherwise commit to hours silently (the
    reference grid generator ref train.py:3788-3832 has no such guard)."""
    max_cost = float(cfg.get("max_gencfg_cost", 0) or 0)
    kept, total, skipped = [], 0.0, 0
    for g in gencfgs:
        est = estimate_generation_cost(g, num_images, num_guide_targets)
        if 0 < max_cost < est:
            log.warning(f"Skipping gencfg {g.name}: estimated decode cost "
                        f"{est:.1f}s > max_gencfg_cost {max_cost:g}s")
            skipped += 1
            continue
        kept.append((g, est))
        total += est
    log.info(f"Estimated decode cost over {num_images} images: " +
             ", ".join(f"{g.name} {est:.2f}s" for g, est in kept) +
             f" => total ~{total:.1f}s ({skipped} skipped)")
    return [g for g, _ in kept]


def action_eval_cls_decoding(cfg, device="cuda"):
    """Grid of GenerationConfigs × models × cls datasets → top-k tables."""
    dev = resolve(device)
    embedder = load_embedder(cfg, load_model=True, device=dev)
    ckpts = find_checkpoints(cfg)
    if not ckpts:
        raise ValueError("eval_cls_decoding requires load_model/load_models")
    gencfgs = load_generation_configs(cfg, guided=cfg.eval_guided)
    names = cfg.cls_datasets or [cfg.cls_dataset]
    run_dir = make_run_dir(cfg)
    metrics = MetricsLogger(run_dir=run_dir, use_wandb=cfg.use_wandb,
                            wandb_kwargs=wandb_init_kwargs(cfg), project=cfg.wandb_project)
    all_rows = []
    for ds_name in names:
        ds = load_image_dataset(ds_name, resolve_path(cfg, cfg.cls_dataset_root),
                                split=cfg.cls_split, variant=cfg.class_names_variant,
                                clean=(cfg.class_names_variant == "clip"))
        loader = ClassificationLoader(ds, batch_size=cfg.batch_size_image,
                                      transform=embedder.get_image_transform(), shuffle=False)
        # eval_samples_max: cap evaluated images (ref train.py:2233-2236)
        max_samples = int(cfg.get("eval_samples_max", 0) or 0)
        max_batches = (min(max(max_samples // cfg.batch_size_image, 1), len(loader))
                       if 0 < max_samples < len(ds) else None)
        if max_batches is not None:
            log.warning(f"Limiting evaluation to at most {max_samples} samples "
                        f"=> using {max_batches} batches")
        embeds_list, labels_list = [], []
        for b, (pixel, labels) in enumerate(loader):
            if max_batches is not None and b >= max_batches:
                break
            embeds_list.append(embedder.inference_image(pixel))
            labels_list.append(labels)
        all_embeds = np.concatenate(embeds_list)
        all_labels = np.concatenate(labels_list)

        for ckpt_path in ckpts:
            decoder = load_decoder_from_checkpoint(ckpt_path, embedder, device=dev)
            class_targets = align_cls_class_targets(ds.classes, ("",) + decoder.target_vocab)
            vocab_ids, vocab_strs = load_guide_targets(decoder.target_tokenizer,
                                                       decoder.target_vocab)
            ds_gencfgs = budget_gencfgs(cfg, gencfgs, len(all_embeds), len(vocab_strs))
            tasks = [GenerationTask(gencfg=g, decoder=decoder,
                                    vocab_targets_set=set(vocab_strs), vocab_targets=vocab_ids,
                                    guide_targets_set=set(vocab_strs),
                                    guide_targets=(vocab_ids if (g.guided or g.method == "all")
                                                   else None),
                                    class_lists=class_targets)
                     for g in ds_gencfgs]
            if cfg.get("precompute_dir"):
                for task in tasks:
                    task.precompute_dir = resolve_path(cfg, cfg.precompute_dir)
            task_list = GenerationTaskList(tasks)
            B = cfg.batch_size_image
            for i in range(0, len(all_embeds), B):
                task_list.process(all_embeds[i:i + B],
                                  class_indices=all_labels[i:i + B].tolist())
            header = ["gencfg"] + [f"top{k}" for k in range(1, cfg.eval_topk + 1)] + \
                     ["top1_guide", "top1_vocab", "top1_invalid"]
            rows = []
            for task in tasks:
                row = [task.gencfg.name] + \
                      [f"{task.topk[k]:.2%}" if k < task.gencfg.topk else "-"
                       for k in range(cfg.eval_topk)] + \
                      [f"{task.topk_guide[0]:.2%}", f"{task.topk_vocab[0]:.2%}",
                       f"{task.topk_invalid[0]:.2%}"]
                rows.append(row)
                all_rows.append([ds_name, os.path.basename(ckpt_path)] + row)
                metrics.log({"dataset": ds_name, "model": os.path.basename(ckpt_path),
                             "gencfg": task.gencfg.name, "top1": float(task.topk[0]) * 100})
            width = [max(len(str(r[c])) for r in [header] + rows) for c in range(len(header))]
            log.info(f"--- {ds_name} / {os.path.basename(ckpt_path)} ---")
            for r in [header] + rows:
                log.info("  ".join(str(v).ljust(w) for v, w in zip(r, width)))
    metrics.log_table("eval_cls_decoding",
                      ["dataset", "model", "gencfg"] +
                      [f"top{k}" for k in range(1, cfg.eval_topk + 1)] +
                      ["top1_guide", "top1_vocab", "top1_invalid"], all_rows)
    metrics.finish()
    return all_rows


# ---------------------------------------------------------------------------
# infer action + predictions JSON (ref train.py:2457-2724)
# ---------------------------------------------------------------------------

PREDICTIONS_VERSION = 1


def load_sample_annotations(cfg, ann_json: str, image_dir: Optional[str] = None,
                            update_samples: Optional[Sequence[str]] = None
                            ) -> tuple[dict[str, dict[str, set]], dict[str, None]]:
    """Load the annotation JSON ({sample_key: {category: [nouns]}}) and, when
    update_samples is given, insert missing samples as empty skeleton entries
    (every existing category -> []) and rewrite the file sorted — keeping the
    human/GPT annotation loop closed (ref train.py:4197-4230 +
    infer_ann_json_update at :2522-2553)."""
    if not ann_json:
        return {}, {}
    if image_dir is not None and ann_json.startswith(IMAGEDIR_TAG):
        ann_json = image_dir + ann_json[len(IMAGEDIR_TAG):]
    # The substituted path may still be cfg-relative (ref train.py:4209-4210
    # resolves after tag substitution too)
    ann_json = resolve_path(cfg, ann_json)

    with open(ann_json) as f:
        class_annotations = json.load(f)
    # Dict (not set): efficient 'in' while keeping first-seen category order
    categories = {category: None for annotation in class_annotations.values()
                  for category in annotation}

    if update_samples is not None:
        new_samples = {s for s in update_samples if s not in class_annotations}
        for sample in new_samples:
            class_annotations[sample] = {category: [] for category in categories}
        if new_samples:
            class_annotations = dict(sorted(class_annotations.items()))
            with open(ann_json, "w") as f:
                f.write(json_dumps(class_annotations, indent=2))
            log.info(f"Updated annotations file with {len(new_samples)} new "
                     f"samples: {ann_json}")

    annotations = {sample: {category: set(classes)
                            for category, classes in annotation.items()}
                   for sample, annotation in class_annotations.items()}
    total = sum(len(classes) for annotation in annotations.values()
                for classes in annotation.values())
    log.info(f"Loaded {total} class annotations in {len(categories)} categories "
             f"for {len(annotations)} infer samples from: {ann_json}")
    return annotations, categories


def action_infer(cfg, device="cuda"):
    """Embed texts/images, run all gencfgs, write versioned predictions JSON."""
    dev = resolve(device)
    embedder = load_embedder(cfg, load_model=True, device=dev)
    ckpts = find_checkpoints(cfg)
    if not ckpts:
        raise ValueError("infer requires load_model/load_models")
    gencfgs = load_generation_configs(cfg, guided=cfg.infer_guided)

    keys: list[str] = []
    embeds_parts = []
    if cfg.infer_texts:
        keys.extend(cfg.infer_texts)
        embeds_parts.append(embedder.inference_text(list(cfg.infer_texts)))
    image_paths = [resolve_path(cfg, p) for p in cfg.infer_images]
    if cfg.infer_all_dir:
        d = resolve_path(cfg, cfg.infer_all_dir)
        image_paths.extend(sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp", ".bmp"))))
    if image_paths:
        transform = embedder.get_image_transform()
        for i in range(0, len(image_paths), cfg.batch_size_image):
            chunk = image_paths[i:i + cfg.batch_size_image]
            embeds_parts.append(embedder.inference_image(transform(load_images(chunk))))
        keys.extend(image_paths)
    if not embeds_parts:
        raise ValueError("infer requires infer_texts, infer_images or infer_all_dir")
    all_embeds = np.concatenate(embeds_parts)

    if cfg.get("infer_ann_json_update", False) and cfg.get("infer_ann_json", ""):
        # Insert newly-inferred samples into the annotation JSON skeleton so
        # the infer -> annotate -> format_preds loop stays closed (ref
        # train.py:2522-2553). Annotation keys match format_preds' lookup:
        # raw text for texts, basename for image paths.
        ann_samples = ([t for t in cfg.infer_texts]
                       + [os.path.basename(p) for p in image_paths])
        load_sample_annotations(cfg, cfg.infer_ann_json, update_samples=ann_samples)

    # Guide-target sources, in the reference's precedence (ref train.py:
    # 2468-2476): explicit list > guiding dataset's vocabulary > file > model
    # vocabulary (None)
    guide_list = None
    if cfg.get("infer_guide_targets"):
        guide_list = list(cfg.infer_guide_targets)
    elif cfg.get("infer_guide_dataset"):
        cache = EmbeddingCache(resolve_cache_path(cfg, cfg.infer_guide_dataset),
                               strict_embedder=False)
        guide_list = list(cache.target_nouns[1:])
        log.info(f"Using {len(guide_list)} guiding target nouns from "
                 f"{cfg.infer_guide_dataset}")
    elif cfg.guide_targets_file:
        with open(resolve_path(cfg, cfg.guide_targets_file)) as f:
            guide_list = [line.strip() for line in f if line.strip()]

    output: dict[str, Any] = {"version": PREDICTIONS_VERSION, "models": {}}
    for ckpt_path in ckpts:
        decoder = load_decoder_from_checkpoint(ckpt_path, embedder, device=dev)
        vocab_ids, vocab_strs = load_guide_targets(decoder.target_tokenizer, decoder.target_vocab)
        if guide_list is not None:
            guide_ids, guide_strs = load_guide_targets(decoder.target_tokenizer, guide_list)
        else:
            guide_ids, guide_strs = vocab_ids, vocab_strs
        model_out: dict[str, Any] = {
            "checkpoint": ckpt_path, "embedder": cfg.embedder,
            "vocab_targets": len(vocab_strs), "guide_targets": len(guide_strs),
            "gencfgs": {}}
        for g in budget_gencfgs(cfg, gencfgs, len(all_embeds), len(guide_strs)):
            task = GenerationTask(gencfg=g, decoder=decoder,
                                  vocab_targets_set=set(vocab_strs),
                                  vocab_targets=vocab_ids,
                                  guide_targets_set=set(guide_strs),
                                  guide_targets=(guide_ids if (g.guided or g.method == "all")
                                                 else None))
            if cfg.get("precompute_dir"):
                task.precompute_dir = resolve_path(cfg, cfg.precompute_dir)
            preds, scores, result = [], [], []
            B = cfg.batch_size_embed
            for i in range(0, len(all_embeds), B):
                task.process(all_embeds[i:i + B])
                preds.extend(task.target_str)
                scores.extend(task.target_score)
                result.extend([["correct", "valid_guide", "valid_vocab", "invalid"][r]
                               for r in row] for row in task.result.tolist())
            model_out["gencfgs"][g.name] = {"pred": preds, "score": scores, "result": result}
            if cfg.infer_debug:
                # Full colored top-k table per sample (ref train.py:2665-2671)
                colors = {"correct": "\033[92m", "valid_guide": "\033[96m",
                          "valid_vocab": "\033[94m", "invalid": "\033[91m"}
                for key, p, s, r in zip(keys, preds, scores, result):
                    cells = "  ".join(
                        f"{colors[res]}{pred}\033[0m = {score:.3g}"
                        for pred, score, res in zip(p, s, r))
                    log.info(f"[{g.name}] {key}: {cells}")
            if cfg.infer_log:
                for key, p in zip(keys, preds):
                    log.info(f"[{g.name}] {key} --> {p[0]}")
        output["models"][os.path.basename(ckpt_path)] = model_out

    output["keys"] = keys
    out_path = resolve_path(cfg, cfg.predictions_path) if cfg.predictions_path else \
        os.path.join(make_run_dir(cfg), "predictions.json")
    with open(out_path, "w") as f:
        f.write(json_dumps(output, indent=2))
    log.info(f"Wrote predictions JSON: {out_path}")
    # Record the run in the local results database (mined by format_wandb)
    metrics = MetricsLogger(run_dir=os.path.dirname(out_path) or None,
                            use_wandb=cfg.use_wandb, wandb_kwargs=wandb_init_kwargs(cfg),
                            project=cfg.wandb_project, config=_flat_cfg(cfg))
    for model_name, model_out in output["models"].items():
        for gname in model_out["gencfgs"]:
            metrics.log({"model": model_name, "gencfg": gname, "samples": len(keys),
                         "predictions_path": out_path})
    metrics.finish()
    return output


# ---------------------------------------------------------------------------
# format_preds + PredictionScorer (ref train.py:2731-2917)
# ---------------------------------------------------------------------------

CATEGORY_WEIGHTS = {"correct_primary": 1.0, "correct_secondary": 0.8,
                    "close_primary": 0.5, "close_secondary": 0.4, "incorrect": 0.0}


@dataclasses.dataclass
class PredictionScorer:
    """Score predictions against annotation JSONs with category weights
    (ref train.py PredictionScorer :234-336). Annotation schema:
    {sample_key: {category: [nouns]}} (ref train.py:4197-4230)."""

    annotations: dict[str, dict[str, list[str]]]
    specificity: Optional[dict[str, float]] = None

    score_sum: float = 0.0
    score_count: int = 0
    missing: int = 0

    def score_prediction(self, sample_key: str, pred: str) -> Optional[float]:
        ann = self.annotations.get(sample_key)
        if ann is None:
            self.missing += 1
            return None
        # A prediction matching multiple categories counts under the
        # alphabetically-first match — the reference's exact rule
        # (ref train.py:268-271 matched_category.sort(); [0]); annotators
        # treat multi-category membership as an error to fix
        matched = sorted(c for c, nouns in ann.items() if pred in nouns)
        weight = CATEGORY_WEIGHTS.get(matched[0], 0.0) if matched else 0.0
        if self.specificity is not None:
            weight *= self.specificity.get(pred, 1.0)
        self.score_sum += weight
        self.score_count += 1
        return weight

    @property
    def score(self) -> float:
        return self.score_sum / max(self.score_count, 1)


def _categorise_topk(annotations, sample_keys, pred_rows, topk):
    """Per-rank category counters with best-so-far carry: the counter at rank k
    reflects the best category among the first k+1 predictions of each sample
    (ref train.py categorise_topk :279-309). Missing samples count as None."""
    counters = [Counter() for _ in range(topk)]
    for sk, preds in zip(sample_keys, pred_rows):
        ann = annotations.get(sk)
        if ann is None:
            for c in counters:
                c[None] += 1
            continue
        best_cat, best_w = None, -math.inf
        for c, pred in zip(counters, list(preds)[:topk] + [None] * max(0, topk - len(preds))):
            cat = None
            if pred is not None:
                # Multi-category matches count under the alphabetically-first
                # category (ref train.py:291-294 matched_category.sort(); [0])
                matched = sorted(category for category, nouns in ann.items()
                                 if pred in nouns)
                cat = matched[0] if matched else None
            w = CATEGORY_WEIGHTS.get(cat, 0.0) if cat is not None else 0.0
            # Reference carry (ref :297-303): count the best-so-far on a drop,
            # this pred's category on a tie, and update best on improvement
            if w < best_w:
                counted = best_cat
            else:
                counted = cat
                if w > best_w:
                    best_cat, best_w = cat, w
            c[counted] += 1
    scores = [sum(n * CATEGORY_WEIGHTS.get(cat, 0.0) for cat, n in c.items() if cat)
              for c in counters]
    return scores, counters


def _format_counter(counter) -> str:
    """'P/S✓ p/s~ i/o✗ = total' category summary (ref train.py:320-327)."""
    total = sum(counter.values())
    w = len(str(total))
    cp, cs = counter.get("correct_primary", 0), counter.get("correct_secondary", 0)
    lp, ls = counter.get("close_primary", 0), counter.get("close_secondary", 0)
    inc = counter.get("incorrect", 0)
    other = total - cp - cs - lp - ls - inc
    return (f"{cp:{w}d}/{cs:{w}d}✓ {lp:{w}d}/{ls:{w}d}~ "
            f"{inc:{w}d}/{other:{w}d}✗ = {total:{w}d}")


def sort_table_rows(rows, headers, sort_spec):
    """In-place table sort by '[+|-][0]<column header>' (case-insensitive):
    leading +/- sets direction, a following '0' parses the first float in
    the cell (ref sort_table_rows, train.py:4233-4266; fmt_sort/pfmt_sort,
    ref config/train.yaml:547,568). Applied AFTER each table's default
    ordering, like the reference."""
    if not sort_spec:
        return rows
    spec = str(sort_spec).lower()
    reverse = False
    if spec[:1] in ("+", "-"):
        reverse = spec[0] == "-"
        spec = spec[1:]
    numparse = spec[:1] == "0"
    if numparse:
        spec = spec[1:]
    lowered = [str(h).lower() for h in headers]
    if spec in lowered:
        col = lowered.index(spec)
    else:
        log.warning(f"Cannot sort by missing column header: {spec}")
        col = 0
    if numparse:
        float_re = re.compile(r"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")

        def key(row):
            v = row[col]
            if isinstance(v, str):
                m = float_re.search(v)
                return float(m.group(0)) if m else \
                    (-math.inf if reverse else math.inf)
            return float(v)
    else:
        def key(row):
            return str(row[col])
    rows.sort(key=key, reverse=reverse)
    return rows


def _text_width(s: str) -> int:
    """Terminal columns of a string as tabulate measures them (wcwidth): wide
    and fullwidth East Asian characters take 2, combining marks 0."""
    return sum(0 if unicodedata.combining(c) else
               2 if unicodedata.east_asian_width(c) in "WF" else 1 for c in s)


def render_table(headers, rows) -> str:
    """The table that tabulate(rows, headers, tablefmt="pretty",
    numalign="left", stralign="left") prints, without the tabulate package:
    cells as strings (None as ""), stripped and left-aligned; empty headers
    pad the front when the first row is longer, and the columns are as many
    as both the rows and the headers have."""
    rows = [list(r) for r in rows]
    headers = [str(h) for h in headers]
    if rows:
        headers = [""] * max(0, len(rows[0]) - len(headers)) + headers
        ncols = min(len(headers), max(len(r) for r in rows))
        cols = [["" if j >= len(r) or r[j] is None else str(r[j]).strip() for r in rows]
                for j in range(ncols)]
        headers = headers[:ncols]
    else:
        cols = [[] for _ in headers]
    widths = [max([_text_width(h)] + [_text_width(c) for c in col])
              for h, col in zip(headers, cols)]

    def row_line(cells):
        return "|" + "|".join(f" {c}{' ' * (w - _text_width(c))} "
                              for c, w in zip(cells, widths)) + "|"

    rule = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [rule, row_line(headers), rule]
    lines += [row_line(cells) for cells in zip(*cols)]
    lines.append(rule)
    return "\n".join(lines)


def _print_table(headers, rows, sort_spec=None):
    if sort_spec:
        rows = sort_table_rows(list(rows), headers, sort_spec)
    print(render_table(headers, rows))


def action_format_preds(cfg, device="cuda"):
    """Score predictions JSONs against annotation JSONs and tabulate.

    Format modes (ref train.py:2731-2870):
    * nouns_v1        — per-sample top-K prediction tables per model × gencfg
    * model_topk_v1   — per-gencfg tables of top-k scores per model
    * model_max_v1    — best top-1 score per model across gencfgs
    * gencfg_model_v1 — mean top-k scores per gencfg across models

    Host work only; `device` is resolved as every action's is.
    """
    resolve(device)
    annotations: dict[str, dict] = {}
    for path in cfg.annotations_paths:
        with open(resolve_path(cfg, path)) as f:
            annotations.update(json.load(f))
    if not annotations:
        raise ValueError("format_preds requires annotations_paths")
    specificity = None
    if cfg.specificity_path:
        with open(resolve_path(cfg, cfg.specificity_path)) as f:
            specificity = json.load(f)

    topk = int(cfg.get("format_topk", 3) or 3)
    mode = (cfg.format_mode or "model_topk_v1").lower()

    # Collect (label, sample_keys, gencfg -> pred rows); one label per model
    loaded: list[tuple[str, list[str], dict[str, list]]] = []
    for path in cfg.predictions_paths or ([cfg.predictions_path] if cfg.predictions_path else []):
        with open(resolve_path(cfg, path)) as f:
            predictions = json.load(f)
        sample_keys = [os.path.basename(k) for k in predictions["keys"]]
        for model_name, model_out in predictions["models"].items():
            if cfg.get("format_model_spec", True):
                # Model column from the JSON's model spec (ref pfmt_model_spec)
                label = f"{os.path.basename(path)}:{model_name}" \
                    if len(predictions["models"]) > 1 else model_name
            else:
                label = os.path.basename(path) if len(predictions["models"]) == 1 \
                    else f"{os.path.basename(path)}:{model_name}"
            loaded.append((label, sample_keys,
                           {g: out for g, out in model_out["gencfgs"].items()}))
    if not loaded:
        raise ValueError("format_preds requires predictions_path(s)")
    gencfgs = sorted({g for _, _, gc in loaded for g in gc})

    if mode == "nouns_v1":
        for label, sample_keys, gc in loaded:
            for gname, gout in gc.items():
                scorer = PredictionScorer(annotations, specificity)
                rows = []
                for sk, preds, scores in zip(sample_keys, gout["pred"], gout["score"]):
                    cells = []
                    for pred, sc in list(zip(preds, scores))[:topk]:
                        w = scorer.score_prediction(sk, pred)
                        # ✓ correct_{primary,secondary}, ~ close_{primary,secondary}
                        mark = "✓" if (w or 0) >= 0.8 else ("~" if (w or 0) > 0 else "✗")
                        cells.append(f"{pred} = {sc:.3g} {mark}")
                    rows.append((sk, *cells))
                log.info(f"Top-{topk} predictions for {label} decoded with {gname}:")
                _print_table(("Sample", *(f"Prediction {k+1}" for k in range(topk))), rows,
                             sort_spec=cfg.get("format_sort", ""))
        return loaded

    # Score grid: gencfg -> label -> (topk scores, topk counters)
    grid: dict[str, dict[str, tuple]] = {g: {} for g in gencfgs}
    totals: dict[str, int] = {}
    for label, sample_keys, gc in loaded:
        totals[label] = len(sample_keys)
        for gname, gout in gc.items():
            k = min(topk, max(len(p) for p in gout["pred"]) if gout["pred"] else topk)
            grid[gname][label] = _categorise_topk(annotations, sample_keys, gout["pred"], k)

    if mode == "model_topk_v1":
        for gname in gencfgs:
            log.info(f"Top-k (up to {topk}) prediction scores when models are decoded "
                     f"with {gname}:")
            kmax = max(len(s) for s, _ in grid[gname].values())
            rows = []
            for label, (scores, counters) in grid[gname].items():
                total = totals[label]
                rows.append((label, _format_counter(counters[0]),
                             *(f"{s:.1f}" for s in scores),
                             *(f"{100*s/total:.1f}%" if total else "nan" for s in scores)))
            _print_table(("Model", "Top-1 Details", *(f"Top-{k+1}" for k in range(kmax)),
                          *(f"Top-{k+1}%" for k in range(kmax))), rows,
                         sort_spec=cfg.get("format_sort", ""))
    elif mode == "model_max_v1":
        log.info("Best top-1 prediction score per model (max over decoding strategies):")
        rows = []
        for label, _, _ in loaded:
            best = max(((grid[g][label][0][0], grid[g][label][1][0], g)
                        for g in gencfgs if label in grid[g]), default=None)
            if best is None:
                continue
            score, counter, g = best
            total = totals[label]
            rows.append((label, _format_counter(counter), f"{score:.1f}",
                         f"{100*score/total:.1f}%" if total else "nan", g))
        rows.sort(key=lambda r: -float(r[2]))
        _print_table(("Model", "Top-1 Details", "Top-1", "Top-1%", "Gen Cfg"), rows,
                     sort_spec=cfg.get("format_sort", ""))
    elif mode == "gencfg_model_v1":
        log.info(f"Top-k (up to {topk}) prediction scores across models and decoding strategies:")
        if len(set(totals.values())) > 1:
            log.warning(f"Prediction JSONs have differing sample counts; treat means "
                        f"with caution: {sorted(set(totals.values()))}")
        labels = [label for label, _, _ in loaded]
        rows = []
        for gname in gencfgs:
            per_label = grid[gname]
            kmax = max((len(s) for s, _ in per_label.values()), default=0)
            means = []
            for k in range(kmax):
                vals = [100 * s[k] / totals[lb] for lb, (s, _) in per_label.items()
                        if len(s) > k and totals[lb]]
                means.append(f"{sum(vals)/len(vals):.1f}%" if vals else "-")
            cells = [(f"{100*per_label[lb][0][0]/totals[lb]:.1f}%"
                      if lb in per_label and totals[lb] else "-") for lb in labels]
            rows.append((gname, " ".join(means), *cells))
        _print_table(("Gen Cfg", "Mean Top-k", *labels), rows,
                     sort_spec=cfg.get("format_sort", ""))
    else:
        raise ValueError(f"Unsupported predictions format mode: {cfg.format_mode}")
    return grid


_FMT_TYPE_ACTIONS = {
    "eval_gen_cls_v1": {"eval", "eval_cls", "eval_cls_decoding"},
    "infer_v1": {"infer"},
    "all_v1": {"eval", "eval_cls", "eval_cls_decoding", "infer"},
    "all_v2": {"eval", "eval_cls", "eval_cls_decoding", "infer"},
}


def parse_duration_str(duration: str, now) -> Optional[str]:
    """'1y2w3d4h5m6s'-style ago-duration → ISO timestamp (ref train.py:3283-3296)."""
    if not duration:
        return None
    m = re.fullmatch(r"(\d+y)?(\d+w)?(\d+d)?(\d+h)?(\d+m)?(\d+s)?", duration,
                     flags=re.IGNORECASE)
    if not m or not any(m.groups()):
        raise ValueError(f"Bad duration spec {duration!r}")
    years, weeks, days, hours, minutes, seconds = m.groups()
    ago = datetime.timedelta(
        days=(365 * int(years[:-1]) if years else 0)
        + (7 * int(weeks[:-1]) if weeks else 0) + (int(days[:-1]) if days else 0),
        hours=int(hours[:-1]) if hours else 0,
        minutes=int(minutes[:-1]) if minutes else 0,
        seconds=int(seconds[:-1]) if seconds else 0)
    return (now - ago).isoformat()


def parse_datetime_str(stamp: str) -> Optional[str]:
    """'YYYYMMDD[_HHMMSS]' run-dir stamp → ISO timestamp (ref train.py:3299-3306)."""
    if not stamp:
        return None
    stamp = str(stamp)  # CLI coercion may deliver 'YYYYMMDD' as an int
    fmt = "%Y%m%d_%H%M%S" if "_" in stamp else "%Y%m%d"
    return datetime.datetime.strptime(stamp, fmt).replace(
        tzinfo=datetime.timezone.utc).isoformat()


def build_wandb_filters(cfg, wanted, now) -> dict:
    """Mongo-style wandb run filters: finished state, action set, created-at
    windows (relative durations + absolute stamps), host $in/regex filters,
    and model-path regexes over config.load_model(s) (ref train.py:2942-3046)."""
    filters = [{"state": "finished"},
               {"config.action": {"$in": sorted(wanted)}}]
    if created_min := parse_duration_str(cfg.get("fmt_max_ago", ""), now):
        filters.append({"createdAt": {"$gt": created_min}})
    if created_max := parse_duration_str(cfg.get("fmt_min_ago", ""), now):
        filters.append({"createdAt": {"$lt": created_max}})
    if created_min := parse_datetime_str(cfg.get("fmt_min_stamp", "")):
        filters.append({"createdAt": {"$gt": created_min}})
    if created_max := parse_datetime_str(cfg.get("fmt_max_stamp", "")):
        filters.append({"createdAt": {"$lt": created_max}})
    if fmt_models := set((cfg.get("fmt_models", "") or "").split()):
        models_regex = r"\b({})\b".format(
            "|".join(re.escape(m).replace("/", r"\/") for m in sorted(fmt_models)))
        filters.append({"$or": [{"config.load_model": {"$regex": models_regex}},
                                {"config.load_models": {"$regex": models_regex}}]})
    if fmt_hosts := set((cfg.get("fmt_hosts", "") or "").split()):
        exact = sorted(fmt_hosts)
        regex_hosts = sorted(h for h in fmt_hosts if not h.isidentifier())
        host_filters = [{"host": {"$in": exact}}]
        if regex_hosts:
            host_filters.append(
                {"host": {"$regex": "^(({}))$".format(")|(".join(regex_hosts))}})
        filters.append({"$or": host_filters} if len(host_filters) > 1
                       else host_filters[0])
    return {"$and": filters}


def scrape_infer_log(text: str) -> list[tuple[str, str, str]]:
    """Regex-extract past inference predictions from a run's stdout log:
    '[gencfg] key --> pred' lines (the reference's output.log scraping,
    ref train.py:3139-3182, adapted to this framework's infer log format)."""
    out = []
    for m in re.finditer(r"\[([^\]\s]+)\] (.+?) --> (.+?)\s*$", text, re.MULTILINE):
        out.append((m.group(1), m.group(2), m.group(3)))
    return out


def action_format_wandb(cfg, device="cuda"):
    """Mine past runs as a results database and tabulate per model.

    The reference mines the wandb API and scrapes run stdout logs
    (ref train.py:2935-3336). Here the primary database is the LOCAL run dirs
    (config.json + metrics.jsonl, written by every eval/eval_cls/
    eval_cls_decoding/infer run); when use_wandb=true and wandb is importable
    the same rows are pulled from the wandb API with the reference's filter
    depth (created-at windows, host regexes, model-path regexes) plus
    output.log scraping of past inference predictions. Host work only;
    `device` is resolved as every action's is."""
    resolve(device)
    fmt_type = (cfg.get("fmt_type", "all_v1") or "all_v1").lower()
    try:
        wanted = _FMT_TYPE_ACTIONS[fmt_type]
    except KeyError:
        raise ValueError(f"Wandb format type not recognised: {cfg.fmt_type}") from None
    fmt_models = set((cfg.get("fmt_models", "") or "").split())

    rows = []
    if cfg.use_wandb:
        try:
            import wandb

            api = wandb.Api()
            path = cfg.wandb_project if not cfg.get("wandb_entity") else \
                f"{cfg.wandb_entity}/{cfg.wandb_project}"
            filters = build_wandb_filters(
                cfg, wanted, datetime.datetime.now(tz=datetime.timezone.utc))
            runs = list(api.runs(path=path, filters=filters))
            log.info(f"Retrieved {len(runs)} possibly relevant wandb runs")
            for run in runs:
                action = run.config.get("action")
                for rec in run.scan_history():
                    model = rec.get("model")
                    if model is None or (fmt_models and model not in fmt_models):
                        continue
                    rows.append((run.name, action, model,
                                 rec.get("dataset") or rec.get("gencfg") or "-",
                                 {k: v for k, v in rec.items()
                                  if isinstance(v, (int, float)) and not k.startswith("_")}))
                if action == "infer":
                    # Past inference predictions live only in the run's stdout
                    # log — scrape them (ref train.py:3139-3182)
                    try:
                        text = run.file("output.log").download(
                            replace=True, exist_ok=True).read()
                        for gencfg, key, pred in scrape_infer_log(text):
                            rows.append((run.name, "infer",
                                         run.config.get("load_model", "-"),
                                         f"{gencfg} {key}", {"pred": pred}))
                    except Exception as e:  # noqa: BLE001 — log download is best-effort
                        log.warning(f"Could not scrape output.log of {run.name}: {e}")
        except ImportError:
            log.warning("use_wandb=true but wandb is not installed => mining local run dirs")
        except Exception as e:  # API/auth/network failures degrade to local mining
            log.warning(f"wandb API mining failed ({e}) => mining local run dirs")
    if not rows:
        output_dir = resolve_path(cfg, cfg.output_dir)
        for run_dir in sorted(glob.glob(os.path.join(output_dir, "ovod_*"))):
            cfg_path = os.path.join(run_dir, "config.json")
            metrics_path = os.path.join(run_dir, "metrics.jsonl")
            if not (os.path.isfile(cfg_path) and os.path.isfile(metrics_path)):
                continue
            with open(cfg_path) as f:
                run_cfg = json.load(f)
            action = run_cfg.get("action")
            if action not in wanted:
                continue
            with open(metrics_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    model = rec.get("model")
                    if model is None or "_table" in rec or \
                            (fmt_models and model not in fmt_models):
                        continue
                    rows.append((os.path.basename(run_dir), action, model,
                                 rec.get("dataset") or rec.get("gencfg") or "-",
                                 {k: v for k, v in rec.items()
                                  if isinstance(v, (int, float)) and not k.startswith("_")}))

    if not rows:
        log.warning("No matching runs found to format")
        return []
    metric_keys = sorted({k for *_, m in rows for k in m})
    table = [(run, action, model, ds,
              *((f"{m[k]:.4g}" if isinstance(m[k], (int, float)) else str(m[k]))
                if k in m else "-" for k in metric_keys))
             for run, action, model, ds, m in rows]
    log.info(f"Results database ({fmt_type}): {len(rows)} rows")
    _print_table(("Run", "Action", "Model", "Dataset/GenCfg", *metric_keys), table,
                 sort_spec=cfg.get("fmt_sort", ""))
    return rows


def action_format_metrics(cfg, device="cuda"):
    """Tabulate metrics.jsonl files from past runs (the local-logging
    equivalent of the reference's wandb-mining action_format_wandb,
    ref train.py:2935-3336; wandb API mining is used instead when wandb is
    installed and use_wandb=true). Host work only; `device` is resolved as
    every action's is."""
    resolve(device)
    output_dir = resolve_path(cfg, cfg.output_dir)
    rows = []
    for path in sorted(glob.glob(os.path.join(output_dir, "ovod_*", "metrics.jsonl"))):
        run = os.path.basename(os.path.dirname(path))
        last: dict[str, Any] = {}
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "_table" not in rec:
                    last.update(rec)
        if last:
            rows.append((run, last.get("chunk"), last.get("loss"), last.get("top1"),
                         last.get("top1_max")))
    header = ("run", "chunk", "loss", "top1", "top1_max")
    width = [max(len(str(r[c])) for r in [header] + rows) for c in range(len(header))]
    for r in [header] + rows:
        log.info("  ".join(str(v).ljust(w) for v, w in zip(r, width)))
    return rows
