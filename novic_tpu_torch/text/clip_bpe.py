"""CLIP byte-pair-encoding tokenizer, implemented from scratch.

Provides the tokenization semantics of the OpenAI CLIP tokenizer that the
reference consumes through the `clip` pip package (reference
embedders.py:438-555): lowercasing BPE over a byte↔unicode table, the
standard CLIP split pattern, `</w>` word-end markers, start token
`<|startoftext|>`, end = pad token `<|endoftext|>`.

Vocabulary is loaded from either the classic gzip merges file
(bpe_simple_vocab_16e6.txt.gz) or an HF-style merges.txt. Zero third-party
tokenizer dependencies; the algorithm itself is public and reimplemented
here against the published spec. A copy of novic_tpu/text/clip_bpe.py for the
port; `regex` (for \\p{L} and \\p{N}) is imported when a tokenizer is built,
not with the module.
"""

from __future__ import annotations

import gzip
import html
import os
from typing import Optional

from novic_tpu_torch.text.tokenizer import TextTokenizer

_SPLIT_PATTERN = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")


def bytes_to_unicode() -> dict[int, str]:
    """Bijective byte → printable-unicode map (standard GPT-2/CLIP table)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    # The reference pipeline runs ftfy.fix_text; vocab/prompt text in this
    # framework is guaranteed clean ASCII/UTF-8 so html-unescape suffices.
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str, whitespace) -> str:
    """`whitespace` is the compiled regex.compile(r"\\s+")."""
    return whitespace.sub(" ", text).strip()


class CLIPBPETokenizer(TextTokenizer):
    """OpenAI-CLIP-compatible BPE tokenizer.

    merges_path: path to bpe_simple_vocab_16e6.txt.gz (or plain/HF merges.txt).
    The canonical file yields vocab_size 49408 with start=49406, end=pad=49407
    (ref embedders.py:477-497: pad is intentionally aliased to the end token).
    """

    DEFAULT_CONTEXT_LENGTH = 77
    DEFAULT_NUM_MERGES = 48894  # canonical CLIP merge count: 49152 - 256 - 2

    def __init__(self, merges_path: str, context_length: int = DEFAULT_CONTEXT_LENGTH,
                 num_merges: Optional[int] = None):
        import regex

        self._split = regex.compile(_SPLIT_PATTERN, regex.IGNORECASE)
        self._whitespace = regex.compile(r"\s+")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        merges = self._load_merges(merges_path, num_merges)
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])

        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache: dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

        super().__init__(
            context_length=context_length,
            vocab_size=len(self.encoder),
            cased=False,
            start_token_id=self.encoder["<|startoftext|>"],
            end_token_id=self.encoder["<|endoftext|>"],
            pad_token_id=self.encoder["<|endoftext|>"],
        )

    @staticmethod
    def _load_merges(merges_path: str, num_merges: Optional[int]) -> list[tuple[str, str]]:
        if not os.path.isfile(merges_path):
            raise FileNotFoundError(f"BPE merges file not found: {merges_path}")
        if merges_path.endswith(".gz"):
            with gzip.open(merges_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # Canonical gzip layout: header line, then merges (ref clip package format)
            lines = lines[1:num_merges + 1 if num_merges else CLIPBPETokenizer.DEFAULT_NUM_MERGES + 1]
        else:
            with open(merges_path, "r", encoding="utf-8") as f:
                lines = [ln for ln in f.read().split("\n") if ln and not ln.startswith("#version")]
            if num_merges:
                lines = lines[:num_merges]
        merges = []
        for line in lines:
            parts = tuple(line.split())
            if len(parts) == 2:
                merges.append(parts)
        return merges

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda pair: self.bpe_ranks.get(pair, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)

        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text), self._whitespace).lower()
        for token in self._split.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, token_ids) -> str:
        text = "".join(self.decoder[int(t)] for t in token_ids)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )
