"""Dict flatten/unflatten and float formatting (host-only helpers)."""

from __future__ import annotations


def flatten_dict(D: dict, parent_key: str | None = None) -> dict:
    """Flatten a nested string-keyed dict by dot-joining keys."""
    F = {}
    for k, v in D.items():
        if "." in k:
            raise ValueError(f"Key may not contain a dot: {k}")
        new_key = f"{parent_key}.{k}" if parent_key else k
        if isinstance(v, dict):
            F.update(flatten_dict(v, parent_key=new_key))
        else:
            F[new_key] = v
    return F


def unflatten_dict(F: dict) -> dict:
    """Invert flatten_dict."""
    D: dict = {}
    for c, v in F.items():
        parts = c.split(".")
        cursor = D
        for part in parts[:-1]:
            if part not in cursor:
                cursor[part] = {}
            cursor = cursor[part]
            if not isinstance(cursor, dict):
                raise ValueError(f"Nesting conflict at '{part}' while inserting '{c}'")
        leaf = parts[-1]
        if leaf in cursor:
            raise ValueError(f"Nesting conflict at '{leaf}' while inserting '{c}'")
        cursor[leaf] = v
    return D


def format_semifix(value: float, precision: int) -> str:
    """Fixed-precision float format without trailing zeros."""
    return f"{value:.{precision}f}".rstrip("0").rstrip(".")
