"""novic_tpu_torch train CLI: the action dispatcher (the counterpart of
novic_tpu.cli.train).

    python -m novic_tpu_torch.cli.train action=train key=value ... [--device=cpu]

All keys default from config/train.yaml (the file the JAX package reads);
nested keys are dotted; +key=value adds new keys. --config=PATH reads another
defaults file, and --device=DEVICE picks the device (default cuda, which
raises where CUDA is missing). action=train, convert_embedder, fix_checkpoints,
the seven cache actions (cache_noun_dataset, convert_noun_dataset,
cache_noun_multiset, cache_captions, cache_cls, cache_images, merge_caches)
and test_data_loader / test_embed_cache are ported; the other actions of the
JAX package raise "not ported yet".
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from novic_tpu_torch.utils.config import default_config_path, load_config
from novic_tpu_torch.utils.logger import log

NOT_PORTED = (
    "embedder_zero_shot", "eval", "eval_cls", "eval_cls_decoding", "infer", "format_preds",
    "format_metrics", "format_wandb", "collect_wiki_images", "sample_images",
)


def build_action_registry() -> dict:
    from novic_tpu_torch.cli import actions_cache, actions_misc, actions_train

    return {"train": actions_train.action_train,
            "fix_checkpoints": actions_train.action_fix_checkpoints,
            "convert_embedder": actions_misc.action_convert_embedder,
            "cache_noun_dataset": actions_cache.action_cache_noun_dataset,
            "convert_noun_dataset": actions_cache.action_convert_noun_dataset,
            "cache_noun_multiset": actions_cache.action_cache_noun_multiset,
            "cache_captions": actions_cache.action_cache_captions,
            "cache_cls": actions_cache.action_cache_cls,
            "cache_images": actions_cache.action_cache_images,
            "merge_caches": actions_cache.action_merge_caches,
            "test_data_loader": actions_cache.action_test_data_loader,
            "test_embed_cache": actions_cache.action_test_embed_cache}


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
        if cfg.action in NOT_PORTED:
            raise NotImplementedError(f"action={cfg.action} is not ported yet (ported: "
                                      f"{', '.join(sorted(registry))})")
        raise ValueError(f"Unknown action '{cfg.action}'. Available: {', '.join(sorted(registry))}")
    log.info(f"Running action: {cfg.action} on {device}")
    return action(cfg, device=device)


if __name__ == "__main__":
    main()
