"""Deterministic test tokenizer — no vocabulary files required.

Used throughout the test suite (and for synthetic benchmarks) in place of a
real CLIP BPE tokenizer, exercising the exact same TargetConfig compact-ID
machinery. Word-level vocabulary with per-character fallback, CLIP-like
special-token layout (start/end at the top of the vocab, pad = end), matching
the structure the reference relies on (reference embedders.py:477-497).
"""

from __future__ import annotations

from typing import Optional, Sequence

from novic_tpu_torch.text.tokenizer import TextTokenizer

_DEFAULT_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789-' "


class SimpleWordTokenizer(TextTokenizer):
    """Word tokenizer with char fallback. Token layout:
    [0..n_chars) per-char tokens, [n_chars..n_chars+n_words) word tokens,
    then <start>, <end|pad>.
    """

    def __init__(self, words: Sequence[str] = (), context_length: int = 77,
                 chars: str = _DEFAULT_CHARS, with_start: bool = True):
        self.chars = chars
        self.char_to_id = {c: i for i, c in enumerate(chars)}
        vocab_words = sorted(set(w.lower() for w in words))
        base = len(chars)
        self.word_to_id = {w: base + i for i, w in enumerate(vocab_words)}
        self.id_to_word = {i: w for w, i in self.word_to_id.items()}
        n = base + len(vocab_words)
        start_id = n if with_start else None
        end_id = n + 1 if with_start else n
        super().__init__(
            context_length=context_length,
            vocab_size=end_id + 1,
            cased=False,
            start_token_id=start_id,
            end_token_id=end_id,
            pad_token_id=end_id,
        )

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        text = text.lower().strip()
        for wi, word in enumerate(text.split(" ")):
            if wi > 0:
                ids.append(self.char_to_id[" "])
            if word in self.word_to_id:
                ids.append(self.word_to_id[word])
            else:
                for ch in word:
                    ids.append(self.char_to_id.get(ch, self.char_to_id["-"]))
        return ids

    def decode(self, token_ids) -> str:
        parts: list[str] = []
        for tid in token_ids:
            tid = int(tid)
            if tid < len(self.chars):
                parts.append(self.chars[tid])
            elif tid in self.id_to_word:
                parts.append(self.id_to_word[tid])
        return "".join(parts)


def make_test_tokenizer(nouns: Optional[Sequence[str]] = None, **kwargs) -> SimpleWordTokenizer:
    """Tokenizer whose word vocab covers a given noun list's words (multi-token nouns)."""
    words = set()
    for noun in nouns or ():
        words.update(noun.lower().split(" "))
    return SimpleWordTokenizer(words=sorted(words), **kwargs)
