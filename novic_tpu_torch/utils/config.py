"""Flat key=value config system (the port's copy of novic_tpu.utils.config).

A YAML defaults file (the shared config/train.yaml, read as data), dotted-key
CLI overrides parsed as YAML scalars, flat-dict round trips for checkpoint
embedding, and $SOURCE/$IMAGEDIR/$EMBEDDER path tags ($SOURCE is the root of
the checkout).
"""

from __future__ import annotations

import os
import re
from typing import Any, Sequence

import yaml

from novic_tpu_torch.utils.misc import AttrDict, flatten_dict, unflatten_dict

SOURCE_TAG = "$SOURCE"     # Root directory of the source checkout
IMAGEDIR_TAG = "$IMAGEDIR" # Configured image directory
EMBEDDER_TAG = "$EMBEDDER" # Sanitized embedder spec (for cache/checkpoint dir naming)


def source_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_config_path(name: str = "train.yaml") -> str:
    return os.path.join(source_dir(), "config", name)


def sanitize_embedder_spec(spec: str) -> str:
    return spec.replace(":", "_").replace("/", "_")


def resolve_path_tags(path: str, *, image_dir: str | None = None, embedder_spec: str | None = None) -> str:
    """Substitute $SOURCE/$IMAGEDIR/$EMBEDDER path tags (ref train.py:4271-4280)."""
    if SOURCE_TAG in path:
        path = path.replace(SOURCE_TAG, source_dir())
    if IMAGEDIR_TAG in path:
        if image_dir is None:
            raise ValueError(f"Cannot resolve {IMAGEDIR_TAG} tag without a configured image dir: {path}")
        path = path.replace(IMAGEDIR_TAG, image_dir)
    if EMBEDDER_TAG in path:
        if embedder_spec is None:
            raise ValueError(f"Cannot resolve {EMBEDDER_TAG} tag without an embedder spec: {path}")
        path = path.replace(EMBEDDER_TAG, sanitize_embedder_spec(embedder_spec))
    return os.path.expanduser(path)


# -- overrides ----------------------------------------------------------------

_SCI_FLOAT = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)[eE][-+]?\d+$")


def _coerce_scalar(value: Any) -> Any:
    # YAML 1.1 misses dot-less scientific notation ('3e-3' → str); coerce it.
    if isinstance(value, str) and _SCI_FLOAT.match(value):
        return float(value)
    return value


def parse_override(override: str) -> tuple[str, Any]:
    """Parse a single ``dotted.key=value`` override; value is YAML-parsed."""
    if "=" not in override:
        raise ValueError(f"Config override must be of the form key=value: {override}")
    key, _, raw = override.partition("=")
    key = key.strip()
    if not key:
        raise ValueError(f"Config override has empty key: {override}")
    value = _coerce_scalar(yaml.safe_load(raw)) if raw != "" else None
    return key, value


def apply_overrides(cfg: dict, overrides: Sequence[str]) -> dict:
    """Apply ``key=value`` overrides in order. Keys must exist in the defaults,
    unless prefixed with ``+`` to add a new key (hydra's ``+key=value``)."""
    flat = flatten_dict(cfg)
    for override in overrides:
        key, value = parse_override(override)
        allow_new = key.startswith("+")
        if allow_new:
            key = key[1:]
        if not allow_new and key not in flat:
            raise KeyError(f"Unknown config key '{key}' (use +{key}=... to add a new key)")
        flat[key] = value
    return unflatten_dict(flat)


def load_config(config_path: str | None = None, overrides: Sequence[str] = ()) -> AttrDict:
    """Load the YAML defaults and apply CLI overrides."""
    with open(config_path or default_config_path(), "r") as f:
        cfg = yaml.safe_load(f) or {}
    cfg = apply_overrides(cfg, overrides)
    return AttrDict.from_dict(cfg)


def config_to_flat(cfg: dict) -> dict:
    """Nested config → flat dot-keyed dict for checkpoint embedding (ref utils_config.py:10-19)."""
    return flatten_dict(dict(cfg))
