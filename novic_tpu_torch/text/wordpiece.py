"""Native BERT WordPiece tokenizer (for CLIPA-family text towers).

The reference reaches CLIPA models through open_clip's HFTokenizer wrapping
`bert-base-uncased` with tokenizer_kwargs {strip_sep_token: true} (reference
embedders.py:617-645, :674-679): ids are [CLS] + wordpieces + [SEP], padded
with [PAD]=0 to the context length, and every [SEP] is then overwritten with
0 — so the effective end token IS the pad token (ref embedders.py:644-645).

This is a from-scratch reimplementation of the BERT basic+WordPiece algorithm
(lowercase, NFD accent stripping, punctuation/CJK splitting, greedy
longest-match with '##' continuations) over a vocab.txt asset; no torch or
tokenizers dependency. Parity vs transformers.BertTokenizerFast is pinned in
tests/test_wordpiece.py on a synthetic vocab.
"""

from __future__ import annotations

import unicodedata
from typing import Optional, Sequence

from novic_tpu_torch.text.tokenizer import TextTokenizer

MAX_INPUT_CHARS_PER_WORD = 100  # BERT WordPiece default


def _is_punctuation(ch: str) -> bool:
    """BERT treats all non-letter/number ASCII as punctuation, plus unicode P*."""
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def basic_tokenize(text: str, lower: bool = True) -> list[str]:
    """BERT BasicTokenizer: clean, CJK-space, lowercase+strip accents,
    punctuation split, whitespace split."""
    # Clean: drop control chars / U+FFFD, normalize whitespace to ' '
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        cleaned.append(" " if _is_whitespace(ch) else ch)
    text = "".join(cleaned)
    # Surround CJK codepoints with spaces
    text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)

    tokens = []
    for tok in text.split():
        if lower:
            tok = tok.lower()
            # strip accents: NFD then drop Mn marks
            tok = "".join(ch for ch in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(ch) != "Mn")
        # split on punctuation (each punctuation char its own token)
        current: list[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


def wordpiece_tokenize(word: str, vocab: dict[str, int], unk: str) -> list[str]:
    """Greedy longest-match-first WordPiece over a single basic token."""
    if len(word) > MAX_INPUT_CHARS_PER_WORD:
        return [unk]
    pieces: list[str] = []
    start = 0
    while start < len(word):
        end = len(word)
        cur = None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return [unk]
        pieces.append(cur)
        start = end
    return pieces


class BertWordPieceTokenizer(TextTokenizer):
    """vocab.txt-backed BERT tokenizer with CLIPA's strip-SEP convention.

    encode() emits content wordpiece ids only; the TextTokenizer batch
    interface prepends [CLS] (start) and appends the end token, which here is
    the PAD id (= the stripped SEP convention, ref embedders.py:644-645), and
    the embedder pads to full context — reproducing open_clip HFTokenizer's
    max_length padding + sep-zeroing byte-for-byte.
    """

    def __init__(self, vocab_path_or_tokens, context_length: int = 32,
                 lower: bool = True, keep_sep: bool = False):
        if isinstance(vocab_path_or_tokens, (list, tuple)):
            tokens = list(vocab_path_or_tokens)
        else:
            with open(vocab_path_or_tokens, encoding="utf-8") as f:
                tokens = [line.rstrip("\n") for line in f]
            while tokens and tokens[-1] == "":
                tokens.pop()
        self.vocab = {tok: i for i, tok in enumerate(tokens)}
        self.ids_to_tokens = tokens
        if len(self.vocab) != len(tokens):
            raise ValueError("WordPiece vocab contains duplicate tokens")
        for special in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
            if special not in self.vocab:
                raise ValueError(f"WordPiece vocab is missing {special}")
        self.lower = lower
        self.unk_token = "[UNK]"
        self.sep_token_id = self.vocab["[SEP]"]
        pad_id = self.vocab["[PAD]"]
        super().__init__(context_length=context_length, vocab_size=len(tokens),
                         cased=not lower, start_token_id=self.vocab["[CLS]"],
                         # keep_sep (ALIGN, standard BERT): end token is [SEP];
                         # default (CLIPA strip_sep_token): end token is PAD
                         end_token_id=self.sep_token_id if keep_sep else pad_id,
                         pad_token_id=pad_id)

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in basic_tokenize(text, lower=self.lower):
            for piece in wordpiece_tokenize(word, self.vocab, self.unk_token):
                ids.append(self.vocab[piece])
        return ids

    def decode(self, token_ids: Sequence[int]) -> str:
        out: list[str] = []
        for tid in token_ids:
            tok = self.ids_to_tokens[int(tid)]
            if tok.startswith("##") and out:
                out[-1] += tok[2:]
            else:
                out.append(tok)
        return " ".join(out)
