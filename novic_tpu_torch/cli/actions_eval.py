"""Class-name ↔ vocab alignment (the counterpart of the first part of
novic_tpu.cli.actions_eval; reference train.py:3999-4127), which cache_cls
needs. The evaluation actions themselves are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

from novic_tpu_torch.utils.logger import log
from novic_tpu_torch.utils.misc import get_canon


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
