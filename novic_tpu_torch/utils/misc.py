"""Dict flatten/unflatten, AttrDict, float formatting, canonical noun forms,
a/an indefinite articles and JSON with compact lists (host-only helpers; the
port's copies of novic_tpu.utils.misc's)."""

from __future__ import annotations

import json
import re
import unicodedata
from typing import Any

from novic_tpu_torch.utils.logger import log


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


class AttrDict(dict):
    """Dict with attribute access (ref utils.py:385-402)."""

    @classmethod
    def from_dict(cls, D: dict) -> "AttrDict":
        return cls({k: cls.from_dict(v) if isinstance(v, dict) else v for k, v in D.items()})

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, AttrDict) else v for k, v in self.items()}

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any):
        self[key] = value

    def __delattr__(self, key: str):
        del self[key]


def format_semifix(value: float, precision: int) -> str:
    """Fixed-precision float format without trailing zeros."""
    return f"{value:.{precision}f}".rstrip("0").rstrip(".")


ALLOWED_CHARS_CANON = frozenset("abcdefghijklmnopqrstuvwxyz0123456789 ")


def sanitize_ascii(text: str) -> str:
    """Best-effort unicode->ascii transliteration (stand-in for unidecode)."""
    normalized = unicodedata.normalize("NFKD", text)
    return normalized.encode("ascii", "ignore").decode("ascii")


def get_canon(noun: str, sanitize: bool) -> str:
    """Canonical form of a noun for class-name alignment (ref utils.py:323-331)."""
    if sanitize:
        noun = sanitize_ascii(" ".join(noun.split()))
    canon = noun.lower()
    canon = canon.replace("'", "").replace(".", "")
    canon = " ".join(part for part in re.split(r"[\s/-]+", canon) if part)
    if set(canon) - ALLOWED_CHARS_CANON:
        log.warning(f"Canonicalization produced bad chars: {canon}")
    return canon


INDEFINITE_REGEXES = (
    (re.compile(r"^[AEFHILMNORSX][B-Z][A-Z]?\b"), "an "),
    (re.compile(r"^([aefhilmnorsx][.-]|hour)", re.IGNORECASE), "an "),
    (re.compile(r"^([a-z][.-]|e[uw]|onc?e\b|uni|u[bcfghjkqrst][aeiou])", re.IGNORECASE), "a "),
    (re.compile(r"^[aeiou]", re.IGNORECASE), "an "),
)


def make_indefinite(noun: str, suffix: str | None = None) -> str:
    """Prefix a noun with a/an (ref noun_dataset.py:952-968)."""
    for regexen, article in INDEFINITE_REGEXES:
        if regexen.match(noun):
            break
    else:
        article = "a "
    return f"{article}{noun}{suffix}" if suffix is not None else article + noun


def _json_default(o):
    """Serialize numpy scalars/arrays that leak into result dicts."""
    import numpy as np

    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} is not JSON serializable")


def json_dumps(obj: Any, *, indent: int | str | None = None, **kwargs) -> str:
    """Dump JSON without indentation inside lists (ref utils.py:405-427);
    numpy scalars/arrays serialize natively."""
    kwargs.setdefault("default", _json_default)
    lines: list[str] = []
    line_parts: list[str] = []
    open_lists = 0
    for line in json.dumps(obj, indent=indent, **kwargs).splitlines():
        line_content = line.strip()
        if not line_content:
            continue
        if line_content[0] == "]":
            open_lists -= 1
        if line_content[-1] == "[":
            open_lists += 1
        if open_lists > 0:
            part = line_content if line_parts else line
            line_parts.append(part + " " if part[-1] == "," else part)
        elif line_parts:
            line_parts.append(line_content)
            lines.append("".join(line_parts))
            line_parts.clear()
        else:
            lines.append(line)
    if open_lists != 0:
        raise ValueError("json_dumps: unbalanced list brackets")
    return "\n".join(lines)
