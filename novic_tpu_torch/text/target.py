"""Target-noun tokenization: TargetConfig + compact-ID remapping.

Faithful reimplementation of the reference's target tokenization semantics
(reference embedders.py:42-65 TargetConfig, :169-254 create_target_config,
:331-385 tokenize_target, :387-406 detokenize_target) in numpy:

* Target nouns are tokenized with the text tokenizer, then remapped to a
  *compact* token-ID space covering only the token IDs actually used by the
  target vocabulary, with pad = end = 0 and (optional) start = 1. This is what
  lets the object decoder have a small output vocab (~a few thousand IDs).
* compact_map  (sparse, len = tokenizer vocab, fill -1): tokenizer ID → compact ID
* compact_unmap (dense, len = compact vocab): compact ID → tokenizer ID
* fixed vs dynamic token length, and optional padding masks.

These arrays double as the checkpoint-compatibility lynchpin: the reference
stores them (as lists) in its config hashes and checkpoints.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Optional, Sequence, Union

import numpy as np

from novic_tpu_torch.text.tokenizer import TextTokenizer

TOKEN_DTYPE = np.int32
MASK_DTYPE = np.bool_


@dataclasses.dataclass(frozen=True)
class TargetConfig:
    """Specification of target-noun tokenization (ref embedders.py:42-65)."""

    vocab_size: int                        # Number of compact token IDs if compact, else tokenizer vocab size
    token_dtype: str                       # Canonical dtype name of token arrays ('int32')
    mask_dtype: str                        # Canonical dtype name of mask arrays ('bool')
    start_token_id: Optional[int]          # None = no start tokens (MUST be None or 1 if compact)
    end_token_id: Optional[int]            # None = no end tokens (MUST be None or 0 if compact)
    pad_token_id: int                      # MUST be 0 if compact
    compact_ids: bool                      # Whether compact sequential renumbering is in effect
    compact_map: Optional[np.ndarray]      # tokenizer ID → compact ID (fill -1), 1D len = tokenizer vocab
    compact_unmap: Optional[np.ndarray]    # compact ID → tokenizer ID, 1D len = vocab_size
    fixed_token_length: bool               # All batches use the same fixed token length
    token_length: int                      # Fixed length, or nominal never-exceeded length
    use_masks: bool                        # Whether tokenize_target also computes padding masks

    def __eq__(self, other):
        if other.__class__ is not self.__class__:
            return NotImplemented
        scalars = lambda c: (c.vocab_size, c.token_dtype, c.mask_dtype, c.start_token_id,
                             c.end_token_id, c.pad_token_id, c.compact_ids,
                             c.fixed_token_length, c.token_length, c.use_masks)
        if scalars(self) != scalars(other):
            return False
        for a, b in ((self.compact_map, other.compact_map), (self.compact_unmap, other.compact_unmap)):
            if a is b:
                continue
            if a is None or b is None or a.dtype != b.dtype or not np.array_equal(a, b):
                return False
        return True

    def __hash__(self):
        return hash((self.vocab_size, self.start_token_id, self.end_token_id, self.pad_token_id,
                     self.compact_ids, self.fixed_token_length, self.token_length, self.use_masks))

    def replace(self, **kwargs) -> "TargetConfig":
        return dataclasses.replace(self, **kwargs)

    def as_jsonable(self) -> dict[str, Any]:
        """JSON-canonical dict (tensors → lists) for config hashing and checkpoints
        (matches ref embedders.py:260 target_configuration layout)."""
        d = dataclasses.asdict(self)
        d["compact_map"] = self.compact_map.tolist() if self.compact_map is not None else None
        d["compact_unmap"] = self.compact_unmap.tolist() if self.compact_unmap is not None else None
        # Reference serializes torch dtypes as e.g. 'torch.int32'; we use numpy names.
        return d

    def config_hash(self, hexdigest: bool = True) -> Union[str, bytes]:
        h = hashlib.sha256(json.dumps(self.as_jsonable(), separators=(",", ":"), sort_keys=True).encode())
        return h.hexdigest() if hexdigest else h.digest()

    @staticmethod
    def from_jsonable(d: dict[str, Any]) -> "TargetConfig":
        d = dict(d)
        for key in ("compact_map", "compact_unmap"):
            if d.get(key) is not None:
                d[key] = np.asarray(d[key], dtype=TOKEN_DTYPE)
        d.setdefault("token_dtype", "int32")
        d.setdefault("mask_dtype", "bool")
        # Accept reference-style torch dtype strings
        d["token_dtype"] = str(d["token_dtype"]).replace("torch.", "")
        d["mask_dtype"] = str(d["mask_dtype"]).replace("torch.", "")
        return TargetConfig(**d)


class TargetTokenizer:
    """Pairs a TextTokenizer with a TargetConfig (ref embedders.py:331-406).

    The reference folds this into Embedder.tokenize_target/detokenize_target;
    here it is a standalone composable so data pipelines don't need a full
    embedder in scope.
    """

    def __init__(self, tokenizer: TextTokenizer, target_config: TargetConfig, check: bool = False):
        self.tokenizer = tokenizer
        self.target_config = target_config
        self.check = check

    def tokenize_target(self, text: Union[str, Sequence[str]], max_tokens: Optional[int] = None
                        ) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Tokenize + apply target config → (token_ids BxC, padding_mask BxC or None).

        Unencodable texts (using token IDs outside the compact set) yield
        negative IDs; callers drop or reject those (ref infer.py:687-710).
        """
        tc = self.target_config
        tok = self.tokenizer

        tokens_dict = tok.tokenize(text=text, max_tokens=max_tokens, output_dict=True)
        token_ids = tokens_dict["input_ids"]
        skip_start = 1 if tok.start_token_id is not None and tc.start_token_id is None else 0
        skip_end = token_ids.shape[1] - 1 if tc.end_token_id is None else token_ids.shape[1]
        token_ids = token_ids[:, skip_start:skip_end]
        padding_mask = (
            np.logical_not(tokens_dict["attention_mask"][:, skip_start:skip_end].astype(bool))
            if tc.use_masks else None
        )

        if tc.compact_ids:
            if tc.end_token_id is None and padding_mask is not None:
                padding_mask = padding_mask.copy()
                padding_mask[np.equal(token_ids, tok.end_token_id)] = True
            token_ids = tc.compact_map[token_ids]  # maps end → pad if end_token_id is None
            if tok.start_token_id is None and tc.start_token_id is not None:
                assert tc.start_token_id == 1
                ones = np.ones((token_ids.shape[0], 1), dtype=token_ids.dtype)
                token_ids = np.concatenate((ones, token_ids), axis=1)
                if padding_mask is not None:
                    zeros = np.zeros((padding_mask.shape[0], 1), dtype=padding_mask.dtype)
                    padding_mask = np.concatenate((zeros, padding_mask), axis=1)
        elif tc.end_token_id is None:
            end_token_mask = np.equal(token_ids, tok.end_token_id)
            token_ids = token_ids.copy()
            token_ids[end_token_mask] = tc.pad_token_id
            if padding_mask is not None:
                padding_mask = padding_mask.copy()
                padding_mask[end_token_mask] = True

        if tc.fixed_token_length:
            seq_len = token_ids.shape[1]
            if seq_len > tc.token_length:
                raise ValueError(
                    f"Sequence length {seq_len} is larger than the configured target "
                    f"tokenization fixed length {tc.token_length}")
            if seq_len < tc.token_length:
                padded = np.full((token_ids.shape[0], tc.token_length), tc.pad_token_id,
                                 dtype=token_ids.dtype)
                padded[:, :seq_len] = token_ids
                token_ids = padded
                if padding_mask is not None:
                    padded_mask = np.ones((token_ids.shape[0], tc.token_length), dtype=padding_mask.dtype)
                    padded_mask[:, :seq_len] = padding_mask
                    padding_mask = padded_mask

        if self.check:
            assert token_ids.min() >= 0 and token_ids.max() < tc.vocab_size
            detok = self.detokenize_target(token_ids[0] if isinstance(text, str) else token_ids)
            originals = [text] if isinstance(text, str) else list(text)
            decoded = [detok] if isinstance(text, str) else detok
            for orig, dec in zip(originals, decoded):
                if dec != orig:
                    raise ValueError(f"Detokenized target '{dec}' != original '{orig}'")

        return token_ids, padding_mask

    def detokenize_target(self, token_ids: np.ndarray) -> Union[str, list[str], list[list[str]]]:
        """Invert tokenize_target for 1D/2D/3D batches (ref embedders.py:387-406)."""
        tc = self.target_config
        token_ids = np.asarray(token_ids)
        if tc.compact_ids:
            if self.tokenizer.start_token_id is None and tc.start_token_id is not None:
                token_ids = token_ids[..., 1:]
            token_ids = tc.compact_unmap[token_ids]
        if token_ids.ndim == 3:
            return [self.tokenizer.detokenize(tids) for tids in token_ids]
        return self.tokenizer.detokenize(token_ids)

    def tokenize_targets_batched(self, texts: Sequence[str], batch_size: int = 1024
                                 ) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Batch tokenize_target over a long list, padded to token_length columns
        (ref infer.py:687-710 load_guide_targets)."""
        tc = self.target_config
        all_ids = np.full((len(texts), tc.token_length), tc.pad_token_id, dtype=TOKEN_DTYPE)
        all_masks = np.ones((len(texts), tc.token_length), dtype=MASK_DTYPE) if tc.use_masks else None
        for i in range(0, len(texts), batch_size):
            chunk = list(texts[i:i + batch_size])
            ids, mask = self.tokenize_target(chunk)
            if ids.shape[1] > tc.token_length:
                # Loud error like the reference (ref infer.py:698-699), not a
                # broadcast crash: the model cannot decode targets longer than
                # its configured token length.
                raise ValueError(
                    "Some guide target noun(s) have tokenizations that are longer "
                    f"than supported by the model target configuration "
                    f"({ids.shape[1]} > {tc.token_length})")
            all_ids[i:i + len(chunk), :ids.shape[1]] = ids
            if ids.shape[1] < tc.token_length:
                all_ids[i:i + len(chunk), ids.shape[1]:] = tc.pad_token_id
            if all_masks is not None and mask is not None:
                all_masks[i:i + len(chunk), :mask.shape[1]] = mask
        return all_ids, all_masks
