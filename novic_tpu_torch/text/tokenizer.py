"""Text tokenizer abstraction (numpy-based, framework-neutral).

Mirrors the tokenizer contract that the reference embeds inside its Embedder
base class (reference embedders.py:320-416): batch tokenize to minimally
padded int token-ID arrays plus attention masks, detokenize robustly to
missing start tokens and interchangeable end/pad tokens, and report tokenizer
metadata (context length, vocab size, special token IDs, case sensitivity).

All tokenization runs on host in numpy; device code only ever sees the
resulting fixed-shape integer arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np


class TextTokenizer:
    """Abstract tokenizer. Subclasses: CLIPBPETokenizer, SimpleWordTokenizer, HFTokenizer."""

    context_length: int          # Maximum token sequence length for the text tower
    vocab_size: int              # Token IDs range over [0, vocab_size)
    cased: bool                  # Whether tokenization is case-sensitive
    start_token_id: Optional[int]  # Start/BOS token ID (None = no start token emitted)
    end_token_id: int            # End/EOS token ID (always present)
    pad_token_id: int            # Padding token ID (may equal end token, never any other token)
    token_dtype: np.dtype        # Dtype of produced token arrays (int32)

    def __init__(self, *, context_length: int, vocab_size: int, cased: bool,
                 start_token_id: Optional[int], end_token_id: int, pad_token_id: int,
                 token_dtype=np.int32):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.cased = cased
        self.start_token_id = start_token_id
        self.end_token_id = end_token_id
        self.pad_token_id = pad_token_id
        self.token_dtype = np.dtype(token_dtype)

    # -- Required interface ------------------------------------------------

    def encode(self, text: str) -> list[int]:
        """Tokenize a single text to raw content token IDs (no start/end/pad)."""
        raise NotImplementedError

    def decode(self, token_ids: Sequence[int]) -> str:
        """Detokenize raw content token IDs back to text."""
        raise NotImplementedError

    # -- Provided batch interface (ref embedders.py:524-555) ----------------

    def tokenize(self, text: Union[str, Sequence[str]], max_tokens: Optional[int] = None,
                 output_dict: bool = False):
        """Tokenize text(s) to a minimally padded BxS int array of token IDs.

        Output includes start token (if the tokenizer has one) and end token,
        truncated to max_tokens, padded with pad_token_id only as far as the
        longest sequence in the batch (ref embedders.py:320-324). With
        output_dict, also returns an attention_mask (1 = real token incl. end,
        0 = padding).
        """
        if max_tokens is None:
            max_tokens = self.context_length
        texts = (text,) if isinstance(text, str) else tuple(text)
        assert len(texts) > 0

        rows: list[list[int]] = []
        has_start = self.start_token_id is not None
        for txt in texts:
            token_list = ([self.start_token_id] if has_start else []) + self.encode(txt)
            if len(token_list) >= max_tokens:
                del token_list[max_tokens - 1:]
            token_list.append(self.end_token_id)
            rows.append(token_list)

        S = max(len(r) for r in rows)
        token_ids = np.full((len(rows), S), fill_value=self.pad_token_id, dtype=self.token_dtype)
        attention_mask = np.zeros((len(rows), S), dtype=self.token_dtype)
        for i, r in enumerate(rows):
            token_ids[i, :len(r)] = r
            attention_mask[i, :len(r)] = 1

        if output_dict:
            return {"input_ids": token_ids, "attention_mask": attention_mask}
        return token_ids

    def detokenize(self, token_ids: np.ndarray) -> Union[str, list[str]]:
        """Detokenize (a batch of) token ID sequences (ref embedders.py:326-329,550-555).

        Robust to missing start tokens; end/pad tokens terminate the sequence.
        """
        token_ids = np.asarray(token_ids)
        if token_ids.ndim <= 1:
            return self._decode_row(token_ids.reshape(-1))
        return [self._decode_row(row) for row in token_ids]

    def _decode_row(self, row: np.ndarray) -> str:
        ids = []
        for tid in row.tolist():
            if tid == self.start_token_id:
                continue
            if tid == self.end_token_id or tid == self.pad_token_id:
                continue
            ids.append(tid)
        return self.decode(ids).rstrip()
