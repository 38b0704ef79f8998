"""novic_tpu_torch train CLI: the action dispatcher (the counterpart of
novic_tpu.cli.train).

    python -m novic_tpu_torch.cli.train action=train key=value ... [--device=cpu]

All keys default from config/train.yaml (the file the JAX package reads);
nested keys are dotted; +key=value adds new keys. --config=PATH reads another
defaults file, and --device=DEVICE picks the device (default cuda, which
raises where CUDA is missing). Every action of the JAX package's CLI is
ported: train and fix_checkpoints, the cache actions, test_data_loader and
test_embed_cache, embedder_zero_shot, eval, eval_cls, eval_cls_decoding,
infer, format_preds, format_metrics, format_wandb, collect_wiki_images,
sample_images and convert_embedder.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from novic_tpu_torch.utils.config import default_config_path, load_config
from novic_tpu_torch.utils.logger import log



def build_action_registry() -> dict:
    from novic_tpu_torch.cli import actions_cache, actions_eval, actions_misc, actions_train

    return {"test_data_loader": actions_cache.action_test_data_loader,
            "test_embed_cache": actions_cache.action_test_embed_cache,
            "embedder_zero_shot": actions_eval.action_embedder_zero_shot,
            "cache_noun_dataset": actions_cache.action_cache_noun_dataset,
            "convert_noun_dataset": actions_cache.action_convert_noun_dataset,
            "cache_noun_multiset": actions_cache.action_cache_noun_multiset,
            "cache_captions": actions_cache.action_cache_captions,
            "cache_cls": actions_cache.action_cache_cls,
            "cache_images": actions_cache.action_cache_images,
            "merge_caches": actions_cache.action_merge_caches,
            "train": actions_train.action_train,
            "fix_checkpoints": actions_train.action_fix_checkpoints,
            "eval": actions_eval.action_eval,
            "eval_cls": actions_eval.action_eval_cls,
            "eval_cls_decoding": actions_eval.action_eval_cls_decoding,
            "infer": actions_eval.action_infer,
            "format_preds": actions_eval.action_format_preds,
            "format_metrics": actions_eval.action_format_metrics,
            "format_wandb": actions_eval.action_format_wandb,
            "collect_wiki_images": actions_misc.action_collect_wiki_images,
            "sample_images": actions_misc.action_sample_images,
            "convert_embedder": actions_misc.action_convert_embedder}


def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config_path = None
    device = "cuda"
    overrides = []
    for arg in argv:
        if arg.startswith("--config="):
            config_path = arg.split("=", 1)[1]
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        elif arg in ("-h", "--help"):
            print(__doc__)
            print("Actions: " + ", ".join(sorted(build_action_registry())))
            print(f"Config defaults: {default_config_path()}")
            return None
        else:
            overrides.append(arg)
    cfg = load_config(config_path, overrides)

    if cfg.seed:
        import random as _random

        import numpy as _np

        _random.seed(cfg.seed)
        _np.random.seed(cfg.seed)

    registry = build_action_registry()
    action = registry.get(cfg.action)
    if action is None:
        raise ValueError(f"Unknown action '{cfg.action}'. Available: {', '.join(sorted(registry))}")
    log.info(f"Running action: {cfg.action} on {device}")
    return action(cfg, device=device)


if __name__ == "__main__":
    main()
