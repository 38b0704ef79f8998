"""Native SentencePiece unigram tokenizer (no `sentencepiece` package needed).

The reference tokenizes SigLIP text through open_clip's SigLipTokenizer
(reference embedders.py:640-652 tokenizer selection), which wraps a
SentencePiece unigram model. This module implements the three pieces natively:

* a minimal protobuf wire-format parser for the serialized ``ModelProto``
  (.model file) — pieces with scores/types, special-token ids, AND the
  NormalizerSpec's precompiled charsmap,
* a :class:`PrecompiledCharsmap` reader (darts-clone double-array trie +
  replacement pool) implementing the exact normalization real .model assets
  carry (nmt_nfkc etc.), with sentencepiece C++ longest-match semantics,
* unigram Viterbi segmentation with unknown-token fusing and byte-fallback,
* a :class:`SentencePieceTokenizer` adapter to the framework's TextTokenizer
  interface (SigLIP canonicalization: lowercase, strip punctuation, collapse
  whitespace — matching open_clip's ``canonicalize_text``).

Parity is CI-enforced against the production Rust implementation (HF
``tokenizers``: normalizers.Precompiled + models.Unigram — the same code HF
uses to replicate sentencepiece) in tests/test_sentencepiece.py, and against
the official ``sentencepiece`` package when importable.
"""

from __future__ import annotations

import re
import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from novic_tpu_torch.text.tokenizer import TextTokenizer

WS = "▁"  # ▁ sentencepiece whitespace escape

# SentencePiece.Type enum values (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_UNK_PENALTY = 10.0  # sentencepiece's kUnkPenalty


# ---------------------------------------------------------------------------
# Protobuf wire-format (de)serialization for ModelProto
# ---------------------------------------------------------------------------


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 63:
            raise ValueError("Malformed varint in sentencepiece model")


def _scan_fields(data: bytes) -> Iterable[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    i, n = 0, len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:      # varint
            val, i = _read_varint(data, i)
        elif wtype == 1:    # 64-bit
            val = data[i:i + 8]
            i += 8
        elif wtype == 2:    # length-delimited
            ln, i = _read_varint(data, i)
            val = data[i:i + ln]
            i += ln
        elif wtype == 5:    # 32-bit
            val = data[i:i + 4]
            i += 4
        else:
            raise ValueError(f"Unsupported protobuf wire type {wtype}")
        yield fnum, wtype, val


@dataclass
class SentencePieceModel:
    pieces: list[str]
    scores: np.ndarray                    # float32 per piece
    types: np.ndarray                     # int per piece (NORMAL/UNKNOWN/...)
    unk_id: int = 0
    bos_id: int = -1
    eos_id: int = 1
    pad_id: int = -1
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    precompiled_charsmap: bytes = b""     # NormalizerSpec.precompiled_charsmap
    piece_to_id: dict = field(default_factory=dict)
    max_piece_len: int = 1
    byte_fallback: bool = False

    def __post_init__(self):
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self.max_piece_len = max((len(p) for p in self.pieces), default=1)
        self.byte_fallback = bool((self.types == BYTE).any())
        # UNKNOWN piece overrides unk_id if present
        unk = np.nonzero(self.types == UNKNOWN)[0]
        if unk.size:
            self.unk_id = int(unk[0])


def parse_model_proto(data: bytes) -> SentencePieceModel:
    """Parse a serialized sentencepiece ModelProto (.model file contents)."""
    pieces: list[str] = []
    scores: list[float] = []
    types: list[int] = []
    kw: dict = {}
    for fnum, wtype, val in _scan_fields(data):
        if fnum == 1 and wtype == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _scan_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
        elif fnum == 2 and wtype == 2:  # TrainerSpec
            for f2, w2, v2 in _scan_fields(val):
                if w2 != 0:
                    continue
                if f2 == 40:
                    kw["unk_id"] = _zigzag_signed(v2)
                elif f2 == 41:
                    kw["bos_id"] = _zigzag_signed(v2)
                elif f2 == 42:
                    kw["eos_id"] = _zigzag_signed(v2)
                elif f2 == 43:
                    kw["pad_id"] = _zigzag_signed(v2)
        elif fnum == 3 and wtype == 2:  # NormalizerSpec
            for f2, w2, v2 in _scan_fields(val):
                if f2 == 2 and w2 == 2:
                    kw["precompiled_charsmap"] = v2
                elif w2 != 0:
                    continue
                elif f2 == 3:
                    kw["add_dummy_prefix"] = bool(v2)
                elif f2 == 4:
                    kw["remove_extra_whitespaces"] = bool(v2)
                elif f2 == 5:
                    kw["escape_whitespaces"] = bool(v2)
    return SentencePieceModel(pieces=pieces, scores=np.asarray(scores, np.float32),
                              types=np.asarray(types, np.int64), **kw)


def _zigzag_signed(v: int) -> int:
    """TrainerSpec ids are plain int32 varints; map 2^64-complement to signed."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _emit_varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def build_model_proto(pieces: list[tuple[str, float, int]], *, unk_id: int = 0,
                      bos_id: int = -1, eos_id: int = 1, pad_id: int = -1,
                      add_dummy_prefix: bool = True,
                      precompiled_charsmap: bytes = b"") -> bytes:
    """Serialize a minimal ModelProto — for tests and asset-free setups."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += _emit_varint((1 << 3) | 2) + _emit_varint(len(pb)) + pb
        body += _emit_varint((2 << 3) | 5) + struct.pack("<f", score)
        body += _emit_varint((3 << 3) | 0) + _emit_varint(ptype)
        out += _emit_varint((1 << 3) | 2) + _emit_varint(len(body)) + bytes(body)
    ts = bytearray()
    for fnum, v in ((40, unk_id), (41, bos_id), (42, eos_id), (43, pad_id)):
        ts += _emit_varint((fnum << 3) | 0) + _emit_varint(v)
    out += _emit_varint((2 << 3) | 2) + _emit_varint(len(ts)) + bytes(ts)
    ns = bytearray()
    if precompiled_charsmap:
        ns += (_emit_varint((2 << 3) | 2) + _emit_varint(len(precompiled_charsmap))
               + precompiled_charsmap)
    ns += _emit_varint((3 << 3) | 0) + _emit_varint(int(add_dummy_prefix))
    out += _emit_varint((3 << 3) | 2) + _emit_varint(len(ns)) + bytes(ns)
    return bytes(out)


# ---------------------------------------------------------------------------
# Precompiled charsmap (NormalizerSpec.precompiled_charsmap)
# ---------------------------------------------------------------------------
#
# Layout (sentencepiece normalizer.cc DecodePrecompiledCharsMap):
#   [trie_size: u32 LE][darts-clone double-array: trie_size bytes][pool bytes]
# Each trie key is a source byte sequence; its value is a byte offset into the
# pool where the NUL-terminated replacement lives. darts-clone unit packing:
#   label   = unit & 0x800000FF  (low 8 bits; bit31 marks leaf-value units)
#   hasLeaf = (unit >> 8) & 1
#   offset  = (unit >> 10) << ((unit & 0x200) >> 6)


def _utf8_char_len(first_byte: int) -> int:
    if first_byte < 0x80:
        return 1
    if first_byte < 0xE0:
        return 2
    if first_byte < 0xF0:
        return 3
    return 4


class PrecompiledCharsmap:
    """Reader for the precompiled normalization trie inside .model assets.

    Implements the sentencepiece C++ semantics (normalizer.cc
    NormalizePrefix/Normalize): greedy longest trie match from each position,
    unmatched UTF-8 chars copied through unchanged. Parity vs the production
    Rust implementation (HF tokenizers' normalizers.Precompiled, the same
    spm_precompiled format) is pinned in tests/test_sentencepiece.py.
    """

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("Precompiled charsmap blob too short")
        (trie_size,) = struct.unpack("<I", blob[:4])
        if 4 + trie_size > len(blob) or trie_size % 4:
            raise ValueError("Precompiled charsmap trie size is inconsistent")
        self.units = np.frombuffer(blob[4:4 + trie_size], dtype="<u4")
        self.pool = blob[4 + trie_size:]

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def common_prefix_search(self, key: bytes) -> list[tuple[int, int]]:
        """darts-clone commonPrefixSearch → [(matched_len, value)] ascending."""
        results: list[tuple[int, int]] = []
        units = self.units
        n = len(units)
        if n == 0:
            return results
        pos = self._offset(int(units[0]))
        for i, c in enumerate(key):
            pos ^= c
            if pos >= n:
                break
            unit = int(units[pos])
            if (unit & 0x800000FF) != c:
                break
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:  # hasLeaf
                results.append((i + 1, int(units[pos]) & 0x7FFFFFFF))
        return results

    def normalize_prefix(self, data: bytes) -> tuple[Optional[bytes], int]:
        """Longest-match replacement for a prefix of data (None = no match)."""
        results = self.common_prefix_search(data)
        if not results:
            return None, 0
        length, value = results[-1]  # longest match (ref normalizer.cc)
        end = self.pool.find(b"\0", value)
        if end < 0:
            raise ValueError("Charsmap pool entry is not NUL-terminated")
        return self.pool[value:end], length

    def transform(self, text: str) -> str:
        data = text.encode("utf-8")
        out = bytearray()
        i = 0
        while i < len(data):
            rep, ln = self.normalize_prefix(data[i:])
            if rep is None:
                ln = min(_utf8_char_len(data[i]), len(data) - i)
                out += data[i:i + ln]
            else:
                out += rep
            i += ln
        return out.decode("utf-8", errors="replace")


def build_precompiled_charsmap(mapping: dict[str, str]) -> bytes:
    """Serialize {source: replacement} into the precompiled charsmap format
    (a darts-clone double-array + NUL-terminated replacement pool) — for
    tests and asset-free setups; real assets ship their own blob."""
    pool = bytearray()
    keys: list[tuple[bytes, int]] = []
    for src, dst in mapping.items():
        sb = src.encode("utf-8")
        if not sb or 0 in sb:
            raise ValueError(f"Invalid charsmap source: {src!r}")
        keys.append((sb, len(pool)))
        pool += dst.encode("utf-8") + b"\0"

    TERM = -1
    root: dict = {}
    for key, value in keys:
        node = root
        for b in key:
            node = node.setdefault(b, {})
        node[TERM] = value

    units: dict[int, int] = {}
    used = {0}

    def place(node: dict, pos: int) -> None:
        labels = sorted(c for c in node if c != TERM)
        has_term = TERM in node
        o = 1
        while True:
            r = pos ^ o
            ok = not (has_term and r in used)
            if ok:
                ok = all((r ^ c) not in used for c in labels)
            if ok:
                break
            o += 1
        if o >= 1 << 21:
            raise ValueError("Charsmap trie too large for the simple builder")
        r = pos ^ o
        if has_term:
            used.add(r)
            units[r] = 0x80000000 | node[TERM]
        for c in labels:
            used.add(r ^ c)
            units[r ^ c] = c
        units[pos] = units.get(pos, 0) | (o << 10) | ((1 << 8) if has_term else 0)
        for c in labels:
            place(node[c], r ^ c)

    place(root, 0)
    size = max(units) + 1 if units else 1
    arr = np.zeros(size, dtype="<u4")
    for p, u in units.items():
        arr[p] = u
    trie = arr.tobytes()
    return struct.pack("<I", len(trie)) + trie + bytes(pool)


# ---------------------------------------------------------------------------
# Unigram Viterbi segmentation
# ---------------------------------------------------------------------------


class SentencePieceProcessor:
    """Unigram encode/decode against a parsed model."""

    def __init__(self, model: SentencePieceModel):
        self.m = model
        finite = model.scores[np.isfinite(model.scores)]
        min_score = float(finite.min()) if finite.size else 0.0
        self.unk_score = min_score - _UNK_PENALTY
        # Pieces not eligible for segmentation: control/unused
        self._segmentable = {
            p: (i, float(model.scores[i])) for i, p in enumerate(model.pieces)
            if model.types[i] in (NORMAL, USER_DEFINED, BYTE)
        }
        # Exact normalization from the model's own precompiled charsmap when
        # present (real assets always carry one); NFKC approximation otherwise
        self.charsmap = (PrecompiledCharsmap(model.precompiled_charsmap)
                         if model.precompiled_charsmap else None)

    # -- normalization ------------------------------------------------------

    def normalize(self, text: str) -> str:
        if self.charsmap is not None:
            text = self.charsmap.transform(text)
        else:
            text = unicodedata.normalize("NFKC", text)
        if self.m.remove_extra_whitespaces:
            text = re.sub(r"\s+", " ", text).strip()
        if not text:
            # sentencepiece short-circuits empty (post-normalization) input:
            # no dummy prefix, EncodeAsIds('') == []
            return ""
        if self.m.add_dummy_prefix:
            text = " " + text
        if self.m.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    # -- encoding -----------------------------------------------------------

    def encode(self, text: str, out_pieces: bool = False):
        """Viterbi-optimal unigram segmentation → ids (or piece strings)."""
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        best = np.full(n + 1, -np.inf)
        best[0] = 0.0
        back: list[Optional[tuple[int, int]]] = [None] * (n + 1)  # (start, piece_id)
        maxlen = self.m.max_piece_len
        seg = self._segmentable
        for i in range(n):
            if not np.isfinite(best[i]):
                continue
            for ln in range(1, min(maxlen, n - i) + 1):
                sub = s[i:i + ln]
                hit = seg.get(sub)
                if hit is not None and best[i] + hit[1] > best[i + ln]:
                    best[i + ln] = best[i] + hit[1]
                    back[i + ln] = (i, hit[0])
            # Unknown: one char (or its UTF-8 bytes under byte-fallback);
            # competes in the lattice like any piece, at min_score - penalty
            j = i + 1
            unk_cost = best[i] + self.unk_score
            if unk_cost > best[j]:
                best[j] = unk_cost
                back[j] = (i, -1)
        ids: list[int] = []
        pos = n
        rev: list[tuple[object, bool]] = []  # (ids | id, is_unknown)
        while pos > 0:
            prev, pid = back[pos]
            if pid >= 0:
                rev.append((pid, False))
            else:
                fallback = self._unk_or_bytes(s[prev:pos])
                rev.append((fallback, not isinstance(fallback, list)))
            pos = prev
        prev_unk = False
        for pid, is_unk in reversed(rev):
            if isinstance(pid, list):
                ids.extend(pid)
            elif is_unk and prev_unk:
                # sentencepiece fuses consecutive unknown chars into ONE <unk>
                # (the behavior HF tokenizers replicates with fuse_unk=True)
                pass
            else:
                ids.append(pid)
            prev_unk = is_unk
        if out_pieces:
            return [self.m.pieces[i] for i in ids]
        return ids

    def _unk_or_bytes(self, ch: str):
        if self.m.byte_fallback:
            byte_ids = []
            ok = True
            for b in ch.encode("utf-8"):
                pid = self.m.piece_to_id.get(f"<0x{b:02X}>")
                if pid is None:
                    ok = False
                    break
                byte_ids.append(pid)
            if ok:
                return byte_ids
        return self.m.unk_id

    # -- decoding -----------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        out = []
        pending_bytes = bytearray()

        def flush():
            if pending_bytes:
                out.append(pending_bytes.decode("utf-8", errors="replace"))
                pending_bytes.clear()

        for i in ids:
            if i < 0 or i >= len(self.m.pieces):
                continue
            t = self.m.types[i]
            p = self.m.pieces[i]
            if t == BYTE:
                pending_bytes.append(int(p[1:-1], 16))
                continue
            flush()
            if t in (CONTROL, UNUSED):
                continue
            out.append("⁇" if t == UNKNOWN else p)
        flush()
        return "".join(out).replace(WS, " ").strip()


# ---------------------------------------------------------------------------
# TextTokenizer adapter (SigLIP-style)
# ---------------------------------------------------------------------------

_PUNCT_RE = re.compile(r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~]")


def canonicalize_text(text: str, keep_punctuation_exact_string: Optional[str] = None) -> str:
    """SigLIP text canonicalization: strip punctuation, lowercase, collapse
    whitespace (mirrors open_clip tokenizer canonicalize_text semantics)."""
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            _PUNCT_RE.sub("", part) for part in text.split(keep_punctuation_exact_string))
    else:
        text = _PUNCT_RE.sub("", text)
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


class SentencePieceTokenizer(TextTokenizer):
    """SigLIP-style tokenizer: canonicalize → unigram encode; the base class
    appends the end token and pads with pad_id (ref embedders.py:320-329 batch
    tokenization contract)."""

    def __init__(self, model_path_or_bytes, context_length: int = 64,
                 canonicalize: bool = True, prefer_native: bool = False):
        data = (model_path_or_bytes if isinstance(model_path_or_bytes, bytes)
                else open(model_path_or_bytes, "rb").read())
        self.model = parse_model_proto(data)
        self.sp = SentencePieceProcessor(self.model)
        # The native processor normalizes with NFKC + whitespace collapsing,
        # not the model's precompiled nmt_nfkc charsmap; when the official
        # sentencepiece package is importable, use it for encoding so real
        # SigLIP .model assets tokenize exactly (exotic normalization cases).
        self._pkg_sp = None
        if not prefer_native:
            try:
                import sentencepiece as _spm

                pkg = _spm.SentencePieceProcessor()
                pkg.LoadFromSerializedProto(data)
                self._pkg_sp = pkg
            except Exception:
                self._pkg_sp = None
        self.canonicalize = canonicalize
        eos = self.model.eos_id if self.model.eos_id >= 0 else self.model.unk_id
        pad = self.model.pad_id if self.model.pad_id >= 0 else eos
        bos = self.model.bos_id if self.model.bos_id >= 0 else None
        super().__init__(context_length=context_length, vocab_size=len(self.model.pieces),
                         cased=not canonicalize, start_token_id=bos,
                         end_token_id=eos, pad_token_id=pad)

    def encode(self, text: str) -> list[int]:
        if self.canonicalize:
            text = canonicalize_text(text)
        if self._pkg_sp is not None:
            return list(self._pkg_sp.EncodeAsIds(text))
        return self.sp.encode(text)

    def decode(self, token_ids) -> str:
        return self.sp.decode(token_ids)
