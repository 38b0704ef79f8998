"""LLM caption-template dataset generation (offline tooling, L7).

Capability parity with reference caption_generation.py: for each vocab noun,
an LLM (GPT-3.5-class chat model) generates min(freq,10)×captions_per_freq
caption sentences; noun variants are regex-matched in the responses and
substituted with {singular}/{plural} placeholders; duplicates skipped, an
infinite-loop breaker aborts unproductive nouns; the captions JSON is
resumable state (nouns already completed are skipped on rerun); failed API
requests back off (10 s, then 30 min after 5 failures).

The OpenAI client is gated: the pure template-extraction logic
(templatize_caption, caption quota math) is importable and tested without
network or the openai package.

The port's copy of novic_tpu.tools.caption_generation, with the same
functions and names. It runs no kernel and touches no device.
"""

from __future__ import annotations

import json
import re
import time
from typing import Optional, Sequence

from novic_tpu_torch.utils.logger import log

SYSTEM_PROMPT = (
    "You write short, varied, realistic image captions. Each caption must mention the "
    "given object exactly once. One caption per line, no numbering.")


def caption_quota(freq_sum: int, captions_per_freq: int = 10, freq_cap: int = 10) -> int:
    """Number of captions to collect: min(freq_sum, cap) × captions_per_freq
    (ref caption_generation.py get_num_captions)."""
    return min(freq_sum, freq_cap) * captions_per_freq


def _noun_regex(noun: str) -> str:
    # Match the noun as a word, tolerating a possessive or trailing punctuation
    # (ref caption_generation.py:95)
    return r"(^|\s)(" + re.escape(noun) + r")(\.(?!$))?('s?|[,.?!:])?(\s|$)"


def templatize_caption(caption: str, nouns: Sequence[str], placeholder: str) -> Optional[str]:
    """Replace the first matching noun variant with a placeholder field; returns
    None if no variant matches (ref caption_generation.py:93-116)."""
    for noun in nouns:
        regex = _noun_regex(noun)
        if re.search(regex, caption, flags=re.IGNORECASE):
            out = re.sub(regex, r"\1{" + placeholder + r"}\4\5", caption,
                         flags=re.IGNORECASE)
            return out.rstrip(",.?!:")
    return None


def extract_templates(noun_entry: dict, response_lines: Sequence[str]) -> tuple[int, int]:
    """Feed LLM response lines into a noun entry's caption lists; returns
    (num_added, num_duplicates). Balances singular vs plural quotas the way the
    reference does (prefers the emptier list when both match,
    ref caption_generation.py:121-127)."""
    added = dups = 0
    for line in response_lines:
        caption = " ".join(line.strip().split())
        if not caption or caption[0].isdigit():
            caption = re.sub(r"^\d+[.)]\s*", "", caption)
        if not caption:
            continue
        duplicate = False
        sing = templatize_caption(caption, noun_entry.get("singulars", []), "singular")
        if sing is not None and sing in noun_entry["singular_captions"]:
            duplicate = True
            sing = None
        plur = templatize_caption(caption, noun_entry.get("plurals", []), "plural")
        if plur is not None and plur in noun_entry["plural_captions"]:
            duplicate = True
            plur = None
        if sing and plur:
            missing_sing = noun_entry["num_singular_captions"] - len(noun_entry["singular_captions"])
            missing_plur = noun_entry["num_plural_captions"] - len(noun_entry["plural_captions"])
            if missing_sing <= missing_plur:
                sing = None
            else:
                plur = None
        if sing and len(noun_entry["singular_captions"]) < noun_entry["num_singular_captions"]:
            noun_entry["singular_captions"].append(sing)
            added += 1
        elif plur and len(noun_entry["plural_captions"]) < noun_entry["num_plural_captions"]:
            noun_entry["plural_captions"].append(plur)
            added += 1
        elif duplicate:
            dups += 1
    return added, dups


def noun_complete(noun_entry: dict) -> bool:
    return (len(noun_entry["singular_captions"]) >= noun_entry["num_singular_captions"]
            and len(noun_entry["plural_captions"]) >= noun_entry["num_plural_captions"])


def prepare_state(vocab: list[dict], captions_per_freq: int = 10) -> list[dict]:
    """Initialize / resume captions state from a vocab list (resumable JSON,
    ref caption_generation.py:169-199)."""
    for entry in vocab:
        entry.setdefault("singular_captions", [])
        entry.setdefault("plural_captions", [])
        entry["num_singular_captions"] = (
            caption_quota(sum(entry.get("singulars_freq", [])), captions_per_freq)
            if entry.get("singulars_freq") else 0)
        entry["num_plural_captions"] = (
            caption_quota(sum(entry.get("plurals_freq", [])), captions_per_freq)
            if entry.get("plurals_freq") else 0)
    return vocab


def generate_captions(vocab_path: str, captions_path: str, *, model: str = "gpt-3.5-turbo",
                      captions_per_freq: int = 10, max_loop: int = 3):
    """Main driver (requires the openai package + OPENAI_API_KEY)."""
    try:
        import openai
    except ImportError:
        raise RuntimeError("caption generation requires the openai package "
                           "(offline tooling; not available in this environment)")

    with open(vocab_path) as f:
        vocab = json.load(f)
    try:
        with open(captions_path) as f:
            state = json.load(f)
        ids = {n["id"] for n in state}
        for n in vocab:
            if n["id"] not in ids:
                state.append(n)
    except FileNotFoundError:
        state = vocab
    state = prepare_state(state, captions_per_freq)

    client = openai.OpenAI()
    failed = 0
    for entry in state:
        if noun_complete(entry):
            continue
        loop_count = 0
        while not noun_complete(entry) and loop_count <= max_loop:
            need = (entry["num_singular_captions"] - len(entry["singular_captions"])
                    + entry["num_plural_captions"] - len(entry["plural_captions"]))
            user = (f"Write {min(need + 2, 20)} distinct short image captions about "
                    f"'{entry['pretty_noun']}'. Use the exact word(s) "
                    f"{entry.get('singulars', [])} or {entry.get('plurals', [])}.")
            try:
                resp = client.chat.completions.create(
                    model=model, messages=[{"role": "system", "content": SYSTEM_PROMPT},
                                           {"role": "user", "content": user}])
                lines = resp.choices[0].message.content.splitlines()
                added, _ = extract_templates(entry, lines)
                loop_count = 0 if added else loop_count + 1
                failed = 0
            except Exception as e:  # noqa: BLE001 — API errors back off (ref :148-161)
                log.warning(f"[{entry['pretty_noun']}] API error: {e}")
                failed += 1
                time.sleep(1800 if failed > 5 else 10)
        with open(captions_path, "w") as f:
            json.dump(state, f)
    log.info(f"Caption generation complete: {captions_path}")


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Generate LLM caption templates per vocab noun")
    p.add_argument("--vocab", required=True)
    p.add_argument("--captions", required=True)
    p.add_argument("--model", default="gpt-3.5-turbo")
    p.add_argument("--captions_per_freq", type=int, default=10)
    a = p.parse_args()
    generate_captions(a.vocab, a.captions, model=a.model, captions_per_freq=a.captions_per_freq)
