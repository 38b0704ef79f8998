"""Shared CLI plumbing (the counterpart of novic_tpu.cli.common): config
paths, wandb run metadata, embedder and dataset loading, target/data-config
negotiation, checkpoint discovery and config diffs (reference
train.py:3583-3957).
embedding_dataset is a cache path or NounDataset (texts embedded by the
embedder's text tower, or read from its noun cache).
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Optional

import numpy as np

from novic_tpu_torch.data.cache import CacheExpectation, EmbeddingCache
from novic_tpu_torch.data.noun_dataset import NounDataset
from novic_tpu_torch.embedders.base import Embedder
from novic_tpu_torch.models.base import decoder_class
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.utils.config import resolve_path_tags
from novic_tpu_torch.utils.logger import log

# Flat-config keys that may differ between a loaded checkpoint and the current
# run without a warning (ref train.py:60-61 IGNORE_CFG_DIFFS / MODEL_CFGS)
IGNORE_CFG_DIFFS = {"action", "load_model", "load_models", "output_dir", "use_wandb",
                    "batch_size", "embedding_dataset", "seed"}
MODEL_CFGS = set(DecoderModelConfig.__dataclass_fields__)


def resolve_path(cfg, path: str) -> str:
    return resolve_path_tags(path, image_dir=cfg.get("infer_all_dir") or None,
                             embedder_spec=cfg.get("embedder"))


def wandb_init_kwargs(cfg) -> dict:
    """entity/group/name/tags/job_type passthrough for MetricsLogger
    (ref wandb_* keys, ref config/train.yaml:24-33)."""
    tags = cfg.get("wandb_tags", None)
    if isinstance(tags, str):
        tags = [t for t in tags.split() if t] or None
    return {"entity": cfg.get("wandb_entity", ""), "group": cfg.get("wandb_group", ""),
            "name": cfg.get("wandb_name", ""), "tags": tags,
            "job_type": cfg.get("wandb_job_type", "")}


def make_run_dir(cfg) -> str:
    stamp = time.strftime("%Y%m%d_%H%M%S")
    run_dir = os.path.join(resolve_path(cfg, cfg.output_dir), f"ovod_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def load_embedder(cfg, load_model: bool = False, device="cuda") -> Embedder:
    kwargs: dict[str, Any] = dict(
        tokenizer_batch_size=cfg.batch_size_tokenize,
        inference_batch_size=cfg.batch_size_embed,
        image_batch_size=cfg.batch_size_image,
        load_model=load_model,
    )
    is_test = cfg.embedder.split(":", 1)[0] in ("test", "test-structured")
    if not is_test:
        kwargs.update(
            weights_path=resolve_path(cfg, cfg.embedder_weights) if cfg.embedder_weights else None,
            bpe_merges_path=resolve_path(cfg, cfg.bpe_merges_path) if cfg.bpe_merges_path else None,
            compute_dtype=cfg.embedder_compute_dtype,
            device=device,
        )
    elif cfg.get("vocab_path"):
        # A word-level test tokenizer covering the target nouns, so the ids are
        # numbered as serving rebuilds them from the checkpoint's target_nouns
        from novic_tpu_torch.text.simple import make_test_tokenizer

        try:
            with open(resolve_path(cfg, cfg.vocab_path)) as f:
                vocab_json = json.load(f)
            kwargs["tokenizer"] = make_test_tokenizer([e["target_noun"] for e in vocab_json])
            if cfg.embedder.startswith("test-structured:"):
                # The structured embedder also matches the nouns' variants
                # (singulars, plurals) in texts, to place them on their class
                from novic_tpu_torch.embedders.structured import lexicon_from_vocab_json

                kwargs["lexicon"] = lexicon_from_vocab_json(vocab_json)
        except (OSError, ValueError, KeyError, TypeError) as e:
            log.warning(f"Could not build test tokenizer from vocab_path: {e}")
    return Embedder.create(cfg.embedder, **kwargs)


def gen_target_config(cfg, embedder: Embedder, targets) -> None:
    """Create + configure the target config, letting the model class adjust the
    kwargs first (ref train.py:3714-3740)."""
    cls = decoder_class(cfg.model)
    kwargs = cls.get_target_config_kwargs(
        with_start_token=cfg.with_start_token,
        with_end_token=cfg.with_end_token,
        compact_ids=cfg.compact_ids,
        fixed_token_length=cfg.fixed_token_length,
        auto_fixed_token_length=cfg.auto_fixed_token_length,
        use_masks=cfg.use_masks,
    )
    tc = embedder.create_target_config(targets, **kwargs)
    embedder.configure_target(tc, targets)


def gen_data_config(cfg, dataset):
    """Negotiate the data config between model class, cfg and dataset
    (ref train.py:3741-3772)."""
    cls = decoder_class(cfg.model)
    kwargs = cls.get_data_config_kwargs(
        use_weights=cfg.use_weights, unit_weights=cfg.unit_weights,
        multi_target=cfg.multi_target, multi_first=cfg.multi_first,
        fixed_multi_length=cfg.fixed_multi_length, multi_length=cfg.multi_length,
        full_targets=None,
    )
    dc = dataset.resolve_data_config(**kwargs)
    dataset.configure_data(dc)
    return dc


def resolve_cache_path(cfg, path: str) -> str:
    """Resolve relative cache paths against embedding_cache_dir (ref train.py:3640)."""
    path = resolve_path(cfg, path)
    if not os.path.exists(path):
        alt = os.path.join(resolve_path(cfg, cfg.embedding_cache_dir), path)
        if os.path.exists(alt):
            return alt
    return path


def save_cache_path(cfg) -> str:
    path = cfg.save_embedding_cache
    if not path:
        raise ValueError("save_embedding_cache must be specified for cache actions")
    path = resolve_path(cfg, path)
    if os.path.basename(path) == path:
        cache_dir = resolve_path(cfg, cfg.embedding_cache_dir)
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, path)
    return path


def load_noun_dataset(cfg, embedder: Embedder, use_cache: Optional[bool] = None,
                      vocab_json=None, prompt_json=None) -> NounDataset:
    use_cache = cfg.noun_cache if use_cache is None else use_cache
    return NounDataset(
        embedder,
        vocab_path=resolve_path(cfg, cfg.vocab_path) if vocab_json is None else None,
        vocab_json=vocab_json,
        prompt_path=(resolve_path(cfg, cfg.prompt_path)
                     if prompt_json is None and cfg.prompt_path else None),
        prompt_json=prompt_json,
        prompt_collection=cfg.prompt_collection,
        hypernym_collection=cfg.hypernym_collection,
        vocab_thres=cfg.vocab_thres,
        cache_dir=resolve_path(cfg, cfg.noun_cache_dir) if use_cache else None,
        force_recache=cfg.noun_recache,
        check_consistent=cfg.check_consistent,
    )


def load_embedding_dataset(cfg, embedder: Embedder, spec: Optional[str] = None,
                           training: bool = True):
    """'NounDataset' or a cache path → configured dataset (ref train.py:3631-3711)."""
    spec = spec or cfg.embedding_dataset
    if spec == "NounDataset":
        dataset = load_noun_dataset(cfg, embedder)
        gen_target_config(cfg, embedder, dataset.targets)
        dataset.configure_target()
        return dataset
    cache_path = resolve_cache_path(cfg, spec)
    cache = EmbeddingCache(cache_path, strict_embedder=False)
    # Validate strictly once the target config is known
    gen_target_config(cfg, embedder, cache.target_nouns[1:] if cache.target_nouns else ())
    if cfg.strict_embedder:
        cache = EmbeddingCache(
            cache_path,
            CacheExpectation(embed_dim=embedder.embed_dim, embed_dtype=np.float32,
                             embedder_hash=embedder.get_configuration_hash(True, False),
                             target_config=embedder.target_config),
            strict_embedder=True)
    cache.set_translation_source(embedder.target_config)
    return cache.create_dataset(batch_size=cfg.batch_size, training=training)


def find_checkpoints(cfg) -> list[str]:
    """Expand load_model/load_models (files or dirs → latest N checkpoints)
    (ref train.py:3835-3895)."""
    paths = list(cfg.load_models or [])
    if cfg.load_model:
        paths.append(cfg.load_model)
    out = []
    for path in paths:
        path = resolve_path(cfg, path)
        if os.path.isdir(path) and not os.path.exists(os.path.join(path, "novic_meta.json")):
            ckpts = sorted(glob.glob(os.path.join(path, "*.npz"))
                           + glob.glob(os.path.join(path, "*.model"))
                           + glob.glob(os.path.join(path, "*.train"))
                           + glob.glob(os.path.join(path, "*.orbax")),
                           key=os.path.getmtime)
            n = cfg.load_models_dirnum or len(ckpts)
            out.extend(ckpts[-n:])
        elif os.path.isfile(path) or os.path.isdir(path):  # file or orbax dir
            out.append(path)
        else:
            raise FileNotFoundError(f"Checkpoint path not found: {path}")
    return out


def check_loaded_config(cfg_flat_loaded: dict, cfg_flat_current: dict):
    """Log config diffs between a checkpoint and the current run (ref train.py:3912-3957)."""
    diffs = []
    for key, loaded in cfg_flat_loaded.items():
        if key in IGNORE_CFG_DIFFS or key not in cfg_flat_current:
            continue
        current = cfg_flat_current[key]
        if loaded != current:
            diffs.append((key, loaded, current))
    for key, loaded, current in diffs:
        level = log.info if key in MODEL_CFGS else log.warning
        level(f"Config diff vs checkpoint: {key} = {loaded!r} (ckpt) vs {current!r} (now)")
    return diffs


def model_config_from_cfg(cfg, embedder: Embedder) -> DecoderModelConfig:
    tc = embedder.target_config
    assert tc is not None, "Target config must be configured before building the model config"
    return DecoderModelConfig(
        embed_dim=embedder.embed_dim,
        vocab_size=tc.vocab_size,
        token_length=tc.token_length,
        model=cfg.model,
        vocab_quant=cfg.vocab_quant,
        num_end_loss=cfg.num_end_loss,
        label_smoothing=cfg.label_smoothing,
        hidden_dim=cfg.hidden_dim,
        feedfwd_scale=str(cfg.feedfwd_scale),
        mlp_seq_len=cfg.mlp_seq_len,
        mlp_hidden_layer=cfg.mlp_hidden_layer,
        mlp_hidden_bias=cfg.mlp_hidden_bias,
        mlp_hidden_norm=cfg.mlp_hidden_norm,
        mlp_hidden_activation=cfg.mlp_hidden_activation,
        input_dropout=cfg.input_dropout,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        layer_dropout=cfg.layer_dropout,
        layer_activation=cfg.layer_activation,
        layer_norm_first=cfg.layer_norm_first,
        layer_bias=cfg.layer_bias,
        logits_bias=cfg.logits_bias,
        init_bias_zero=cfg.init_bias_zero,
        init_mlp_mode=cfg.init_mlp_mode,
        init_mlp_unit_norm=cfg.init_mlp_unit_norm,
        init_tfrm_mode=cfg.init_tfrm_mode,
        init_tfrm_unit_norm=cfg.init_tfrm_unit_norm,
        init_tfrm_unit_postnorm=cfg.init_tfrm_unit_postnorm,
        init_tfrm_proj_layers=cfg.init_tfrm_proj_layers,
        init_zero_norm=cfg.init_zero_norm,
        init_rezero_mode=cfg.init_rezero_mode,
        weight_tying=cfg.weight_tying,
        strictly_causal=cfg.strictly_causal,
        matmul_precision=cfg.matmul_precision,
        compute_dtype=cfg.get("decoder_compute_dtype", "float32"),
        dropout_impl=cfg.get("dropout_impl", "auto"),
    )


def load_mean_shift(cfg, embedder: Embedder) -> Optional[np.ndarray]:
    """Load the modality-gap mean-shift vector (ref train.py:1008-1026)."""
    if not cfg.mean_shift:
        return None
    path = resolve_path(cfg, cfg.mean_shift_path)
    with open(path) as f:
        gap = json.load(f)
    shift = np.asarray(gap["mean_shift"], dtype=np.float32)
    if shift.shape != (embedder.embed_dim,):
        raise ValueError(f"Mean shift dimension mismatch: {shift.shape}")
    log.info(f"Loaded mean shift (norm {np.linalg.norm(shift):.4f}) from {path}")
    return shift
