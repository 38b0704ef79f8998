"""Captions JSON validator (parity with reference caption_generation_check.py):
checks counts vs quotas, duplicates, placeholder presence, punctuation and
non-ASCII characters.

The port's copy of novic_tpu.tools.caption_check, with the same
functions and names. It runs no kernel and touches no device.
"""

from __future__ import annotations

import json
import sys
from typing import Any


def check_captions(captions: list[dict]) -> dict[str, Any]:
    issues: list[str] = []
    total_sing = total_plur = 0
    for entry in captions:
        target = entry.get("target_noun", "?")
        sing = entry.get("singular_captions", [])
        plur = entry.get("plural_captions", [])
        total_sing += len(sing)
        total_plur += len(plur)
        if len(set(sing)) != len(sing):
            issues.append(f"{target}: duplicate singular captions")
        if len(set(plur)) != len(plur):
            issues.append(f"{target}: duplicate plural captions")
        for c in sing:
            if "{singular}" not in c:
                issues.append(f"{target}: singular caption missing placeholder: {c!r}")
            if c.count("{singular}") > 1 or "{plural}" in c:
                issues.append(f"{target}: singular caption has wrong placeholders: {c!r}")
        for c in plur:
            if "{plural}" not in c:
                issues.append(f"{target}: plural caption missing placeholder: {c!r}")
            if c.count("{plural}") > 1 or "{singular}" in c:
                issues.append(f"{target}: plural caption has wrong placeholders: {c!r}")
        for c in sing + plur:
            if c != " ".join(c.split()):
                issues.append(f"{target}: caption has bad whitespace: {c!r}")
            if not c.isascii():
                issues.append(f"{target}: caption has non-ASCII characters: {c!r}")
            if c and c[-1] in ",:;":
                issues.append(f"{target}: caption has trailing punctuation: {c!r}")
        nq_s = entry.get("num_singular_captions")
        nq_p = entry.get("num_plural_captions")
        if nq_s is not None and len(sing) > nq_s:
            issues.append(f"{target}: too many singular captions ({len(sing)} > {nq_s})")
        if nq_p is not None and len(plur) > nq_p:
            issues.append(f"{target}: too many plural captions ({len(plur)} > {nq_p})")
    return {"entries": len(captions), "singular_captions": total_sing,
            "plural_captions": total_plur, "issues": issues}


def main(path: str) -> int:
    with open(path) as f:
        captions = json.load(f)
    report = check_captions(captions)
    print(f"{report['entries']} entries, {report['singular_captions']} singular + "
          f"{report['plural_captions']} plural captions, {len(report['issues'])} issues")
    for issue in report["issues"][:100]:
        print(f"  {issue}")
    return 1 if report["issues"] else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
