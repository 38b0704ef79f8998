"""Memory-mapped binary embedding cache: precompute embeddings once, train at
RAM speed.

Bit-compatible with the reference cache file format v1 (reference
embedding_cache.py:24-31 layout, :34-75 header struct) so caches written by
either implementation interoperate:

  128-byte packed header (magic bytes written LAST as commit marker)
  → null-separated UTF-8 target noun strings (row 0 = '' = invalid)
  → RxC target token IDs → RxC bool padding masks
  → NxM per-embedding target-noun IDs (int32, 0 = unknown, non-zeros first)
  → NxM descending non-negative weights (embed dtype)
  → NxF unit-norm embeddings

The port's copy of novic_tpu.data.cache: it writes byte-identical files and
reads the same batches for the same seed. The writer scatters each batch's
rows into their shuffled positions through a writable memory map of the file
(the JAX package uses a native pwrite loop); the bytes are the same.

Reader design: numpy views of a read-only memory map with
MADV_RANDOM|WILLNEED, zero-copy slice reads, whole-batch items (no per-sample
collate), per-epoch circular offset instead of per-sample shuffling (valid
because the writer already globally shuffled the on-disk order, ref
embedding_cache.py:272,832-841). Batches flow to the device via the prefetch
loader (novic_tpu_torch.data.loader), not forked worker processes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import mmap as mmap_mod
import os
import random
import struct
from typing import Optional, Sequence, Union

import numpy as np

try:
    import ml_dtypes
    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover  (the same fallback as the JAX package's)
    _BFLOAT16 = np.dtype(np.float32)

from novic_tpu_torch.data.config import DataConfig, LoaderInfo
from novic_tpu_torch.data.dataset import EmbeddingDataset
from novic_tpu_torch.text.target import TargetConfig, TargetTokenizer, translate_target_tokens
from novic_tpu_torch.utils.logger import log

MAGIC_SIZE = 32
MAGIC_BYTES = b"\xa9\xfdK\x14*\x9a\xb8\x13m\x157\xca\xe8+\xef\x82B\x19\xdbJ\xb8\x93\xb2&\xa0\x1a=\xe4\xadR\xb1\x99"
INIT_MAGIC_BYTES = b"\x00" * MAGIC_SIZE
STRUCT_FORMAT = f"<{MAGIC_SIZE}sB?????32s32sLLHHHLHHHH"
STRUCT_FACTORY = struct.Struct(STRUCT_FORMAT)
VERSION = 1
assert STRUCT_FACTORY.size == 128

INT_DTYPES = (np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32), np.dtype(np.int64))
BOOL_DTYPES = (np.dtype(np.bool_),)
FLOAT_DTYPES = (np.dtype(np.float16), _BFLOAT16, np.dtype(np.float32), np.dtype(np.float64))
INT_DTYPE_ID = {dt: i for i, dt in enumerate(INT_DTYPES)}
BOOL_DTYPE_ID = {dt: i for i, dt in enumerate(BOOL_DTYPES)}
FLOAT_DTYPE_ID = {dt: i for i, dt in enumerate(FLOAT_DTYPES)}

# TargetConfig fields that do not affect cache compatibility (ref embedding_cache.py:45)
TARGET_EXCLUDE = {"fixed_token_length"}


@dataclasses.dataclass(frozen=True)
class CacheHeader:
    magic_bytes: bytes
    version: int
    use_targets: bool
    full_targets: bool
    default_weights: bool
    unit_weights: bool
    embedder_strict: bool
    embedder_hash: bytes
    target_config_hash: bytes
    target_nouns_num: int    # R
    target_nouns_size: int   # bytes of noun strings
    target_dim: int          # C
    target_dtype_id: int
    target_mask_dtype_id: int
    embed_num: int           # N
    embed_targets_dim: int   # M
    embed_targets_dtype_id: int
    embed_dim: int           # F
    embed_dtype_id: int

    def pack(self) -> bytes:
        return STRUCT_FACTORY.pack(*dataclasses.astuple(self))

    @staticmethod
    def unpack(data: bytes) -> "CacheHeader":
        return CacheHeader(*STRUCT_FACTORY.unpack(data))


@dataclasses.dataclass(frozen=True)
class CacheMeta:
    """Section sizes/offsets derived from a header (ref embedding_cache.py:77-160)."""

    target_dtype: np.dtype
    target_mask_dtype: np.dtype
    embed_targets_dtype: np.dtype
    embed_dtype: np.dtype
    embed_eps: float
    target_nouns_offset: int
    target_offset: int
    target_mask_offset: int
    embed_targets_offset: int
    embed_target_weights_offset: int
    embed_offset: int
    embed_stride: int
    embed_targets_stride: int
    embed_target_weights_stride: int
    total_size: int

    @staticmethod
    def from_header(h: CacheHeader) -> "CacheMeta":
        target_dtype = INT_DTYPES[h.target_dtype_id]
        target_mask_dtype = BOOL_DTYPES[h.target_mask_dtype_id]
        embed_targets_dtype = INT_DTYPES[h.embed_targets_dtype_id]
        embed_dtype = FLOAT_DTYPES[h.embed_dtype_id]
        target_stride = h.target_dim * target_dtype.itemsize
        target_mask_stride = h.target_dim * target_mask_dtype.itemsize
        embed_targets_stride = h.embed_targets_dim * embed_targets_dtype.itemsize
        embed_target_weights_stride = h.embed_targets_dim * embed_dtype.itemsize
        embed_stride = h.embed_dim * embed_dtype.itemsize
        target_nouns_offset = STRUCT_FACTORY.size
        target_offset = target_nouns_offset + h.target_nouns_size
        target_mask_offset = target_offset + h.target_nouns_num * target_stride
        embed_targets_offset = target_mask_offset + h.target_nouns_num * target_mask_stride
        embed_target_weights_offset = embed_targets_offset + h.embed_num * embed_targets_stride
        embed_offset = embed_target_weights_offset + h.embed_num * embed_target_weights_stride
        return CacheMeta(
            target_dtype=target_dtype,
            target_mask_dtype=target_mask_dtype,
            embed_targets_dtype=embed_targets_dtype,
            embed_dtype=embed_dtype,
            embed_eps=float(np.finfo(embed_dtype).eps),
            target_nouns_offset=target_nouns_offset,
            target_offset=target_offset,
            target_mask_offset=target_mask_offset,
            embed_targets_offset=embed_targets_offset,
            embed_target_weights_offset=embed_target_weights_offset,
            embed_offset=embed_offset,
            embed_stride=embed_stride,
            embed_targets_stride=embed_targets_stride,
            embed_target_weights_stride=embed_target_weights_stride,
            total_size=embed_offset + h.embed_num * embed_stride,
        )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class EmbeddingCacheWriter:
    """Preallocate + positional-write cache files with writer-side global
    shuffle and magic-bytes-last commit (ref embedding_cache.py:161-457)."""

    def __init__(
        self,
        cache_path: str,
        *,
        num_embed: int,                                 # N (>= 1)
        embed_dim: int,                                 # F
        embed_dtype=np.float32,
        target_tokenizer: Optional[TargetTokenizer] = None,  # required if use_targets
        target_nouns: Optional[Sequence[str]] = None,   # valid nouns (R-1); '' row prepended
        num_embed_targets: int = 1,                     # M
        shuffle: bool = True,
        use_targets: bool = True,
        full_targets: bool = True,
        default_weights: bool = False,
        unit_weights: bool = True,
        embedder_strict: bool = True,
        embedder_hash: bytes = b"\x00" * 32,
        seed: Optional[int] = None,
    ):
        self.cache_path = os.path.abspath(cache_path)
        self.use_targets = use_targets
        self.target_tokenizer = target_tokenizer
        self.num_embed = num_embed
        self.shuffle = shuffle
        self.seed = seed
        self.num_embed_targets = num_embed_targets if use_targets else 0
        self.full_targets = full_targets or not use_targets or self.num_embed_targets <= 1
        self.default_weights = default_weights or not use_targets
        self.unit_weights = unit_weights or self.default_weights
        self.embedder_strict = embedder_strict

        if not self.use_targets:
            self.target_nouns: tuple[str, ...] = ()
        elif target_nouns is None:
            raise ValueError("use_targets=True requires target nouns to be supplied")
        else:
            self.target_nouns = ("",) + tuple(target_nouns)

        self.num_target_nouns = len(self.target_nouns)  # R
        self.target_noun_map = {noun: i for i, noun in enumerate(self.target_nouns)}
        expected = self.num_target_nouns - 1 if "" in self.target_nouns[1:] else self.num_target_nouns
        if len(self.target_noun_map) != expected:
            raise ValueError("Duplicate non-empty target nouns found")
        self.target_nouns_bytes = "\x00".join(self.target_nouns).encode("utf-8")
        self.embed_targets_dtype = np.dtype(np.int32)
        self.embed_dtype = np.dtype(embed_dtype)

        tc = target_tokenizer.target_config if (use_targets and target_tokenizer) else None
        if use_targets and tc is None:
            raise ValueError("target_tokenizer must be provided if use_targets=True")
        token_dtype = np.dtype(tc.token_dtype) if tc else np.dtype(np.int32)

        target_config_hash = b"\x00" * 32
        if use_targets and embedder_strict:
            reduced = {k: v for k, v in tc.as_jsonable().items() if k not in TARGET_EXCLUDE}
            target_config_hash = hashlib.sha256(
                json.dumps(reduced, separators=(",", ":"), sort_keys=True).encode()).digest()

        self.header = CacheHeader(
            magic_bytes=INIT_MAGIC_BYTES,
            version=VERSION,
            use_targets=self.use_targets,
            full_targets=self.full_targets,
            default_weights=self.default_weights,
            unit_weights=self.unit_weights,
            embedder_strict=self.embedder_strict,
            embedder_hash=embedder_hash if self.embedder_strict else b"\x00" * 32,
            target_config_hash=target_config_hash,
            target_nouns_num=self.num_target_nouns,
            target_nouns_size=len(self.target_nouns_bytes),
            target_dim=tc.token_length if use_targets else 0,
            target_dtype_id=INT_DTYPE_ID[token_dtype],
            target_mask_dtype_id=0,
            embed_num=num_embed,
            embed_targets_dim=self.num_embed_targets,
            embed_targets_dtype_id=INT_DTYPE_ID[self.embed_targets_dtype],
            embed_dim=embed_dim,
            embed_dtype_id=FLOAT_DTYPE_ID[self.embed_dtype],
        )
        if self.header.embed_num < 1:
            raise ValueError(f"Cache file must have a positive number of embeddings: {num_embed}")
        if self.use_targets and (self.header.target_dim < 1 or self.header.embed_targets_dim < 1):
            raise ValueError("Cache file target dimensions must be positive")
        self.meta = CacheMeta.from_header(self.header)

        self.embed_written = 0
        self.bytes_written = 0
        self.shuffle_perm: Optional[np.ndarray] = None
        self.cache_fd: Optional[int] = None
        self._map: Optional[mmap_mod.mmap] = None
        self.default_weights_matrix: Optional[np.ndarray] = None

    def tensorize_embed_targets(self, embed_targets_str: Sequence[Union[str, Sequence[str]]]
                                ) -> np.ndarray:
        """Target noun strings → zero-padded BxM noun-ID array
        (ref embedding_cache.py:248-264)."""
        if not self.use_targets:
            raise ValueError("Tensorizing target noun IDs requires use_targets=True")
        out = np.zeros((len(embed_targets_str), self.header.embed_targets_dim),
                       dtype=self.embed_targets_dtype)
        for i, targets in enumerate(embed_targets_str):
            if isinstance(targets, str):
                out[i, 0] = self.target_noun_map[targets]
            else:
                for j, target in enumerate(targets):
                    out[i, j] = self.target_noun_map[target]
        return out

    def __enter__(self) -> "EmbeddingCacheWriter":
        log.info(f"Writing embedding cache {self.cache_path} ({self.meta.total_size / (1 << 30):.3f}GiB)")
        self.embed_written = 0
        self.bytes_written = 0
        rng = np.random.default_rng(self.seed)
        self.shuffle_perm = rng.permutation(self.header.embed_num).astype(np.int64) if self.shuffle else None

        try:
            if self.use_targets:
                ids, mask = self.target_tokenizer.tokenize_target(list(self.target_nouns))
                ids = np.ascontiguousarray(ids, dtype=self.meta.target_dtype)
                if mask is None:
                    mask = np.zeros_like(ids, dtype=self.meta.target_mask_dtype)
                mask = np.ascontiguousarray(mask, dtype=self.meta.target_mask_dtype)
                # Row 0 ('' = invalid) is fully padded by definition
                ids[0, :] = self.target_tokenizer.target_config.pad_token_id
                mask[0, :] = True
                if ids.shape != (self.header.target_nouns_num, self.header.target_dim):
                    raise ValueError(f"Unexpected target token IDs shape: {ids.shape}")
                self._target_token_ids = ids
                self._target_mask = mask

            self.cache_fd = os.open(self.cache_path, os.O_RDWR | os.O_CREAT)
            os.ftruncate(self.cache_fd, 0)
            os.ftruncate(self.cache_fd, self.meta.total_size)
            self._map = mmap_mod.mmap(self.cache_fd, self.meta.total_size)

            self._pwrite(self.header.pack(), 0, STRUCT_FACTORY.size)
            if self.use_targets:
                self._pwrite(self.target_nouns_bytes, self.meta.target_nouns_offset,
                             self.header.target_nouns_size)
                self._pwrite(self._target_token_ids.tobytes(), self.meta.target_offset,
                             self._target_token_ids.nbytes)
                self._pwrite(self._target_mask.tobytes(), self.meta.target_mask_offset,
                             self._target_mask.nbytes)
                if self.default_weights:
                    M = self.header.embed_targets_dim
                    if self.full_targets:
                        w = np.full((self.header.embed_num, M), 1.0 / M, dtype=self.embed_dtype)
                        self._pwrite(w.tobytes(), self.meta.embed_target_weights_offset, w.nbytes)
                    else:
                        tri = np.tril(np.ones((M, M))) / np.arange(1, M + 1)[:, None]
                        self.default_weights_matrix = tri.astype(self.embed_dtype)
        except BaseException:
            self._close_map()
            if self.cache_fd is not None:
                os.close(self.cache_fd)
                self.cache_fd = None
            self.remove()
            raise
        return self

    def write(self, embeds: np.ndarray, embed_targets: Optional[np.ndarray] = None,
              embed_target_weights: Optional[np.ndarray] = None):
        """Append a batch; writes land at globally shuffled on-disk positions
        (ref embedding_cache.py:335-424, incl. all validation invariants)."""
        embeds = np.ascontiguousarray(embeds, dtype=self.embed_dtype)
        batch_size = embeds.shape[0]
        if (embed_targets is not None) != self.use_targets:
            raise ValueError("Embedding target noun IDs provided but not expected, or vice versa")
        if (embed_target_weights is None) != self.default_weights:
            raise ValueError("Embedding target noun weights provided but not expected, or vice versa")
        if embeds.ndim != 2 or batch_size < 1 or embeds.shape[1] != self.header.embed_dim:
            raise ValueError(f"Unexpected embeddings shape: {embeds.shape}")

        embed_index = self.embed_written
        self.embed_written += batch_size
        if self.embed_written > self.header.embed_num:
            raise ValueError(
                f"Cannot write {batch_size} samples at index {embed_index}: cache holds only "
                f"{self.header.embed_num}")
        norms = np.linalg.norm(embeds.astype(np.float32), axis=1)
        if np.any(np.abs(norms - 1) > 4 * self.meta.embed_eps):
            raise ValueError("Embeddings violate the unit vectors invariant")

        indices = (self.shuffle_perm[embed_index:self.embed_written] if self.shuffle else None)
        self._scatter_write(embeds, self.meta.embed_offset, self.meta.embed_stride,
                            embed_index, indices)

        if embed_targets is not None:
            embed_targets = np.ascontiguousarray(embed_targets, dtype=self.embed_targets_dtype)
            if embed_targets.shape != (batch_size, self.header.embed_targets_dim):
                raise ValueError(f"Unexpected embedding target noun IDs shape: {embed_targets.shape}")
            if embed_targets.min() < 0 or embed_targets.max() >= self.num_target_nouns:
                raise ValueError("Target noun IDs outside the expected range")
            if self.full_targets:
                if embed_targets.min() <= 0:
                    raise ValueError("Embedding target cannot have any zeros if full targets")
            elif embed_targets[:, 0].min() <= 0:
                raise ValueError("First target must always be non-zero")
            nonzero = embed_targets.astype(bool)
            if embed_targets.shape[1] > 1 and not np.array_equal(
                    np.minimum.accumulate(nonzero, axis=1), nonzero):
                raise ValueError("Non-zero target noun IDs may not appear after a zero entry")
            self._scatter_write(embed_targets, self.meta.embed_targets_offset,
                                self.meta.embed_targets_stride, embed_index, indices)
            if embed_target_weights is None and not self.full_targets:
                embed_target_weights = self.default_weights_matrix[nonzero[:, 1:].sum(axis=1)]

        if embed_target_weights is not None:
            w = np.ascontiguousarray(embed_target_weights, dtype=self.embed_dtype)
            if w.shape != (batch_size, self.header.embed_targets_dim):
                raise ValueError(f"Unexpected embedding target noun weights shape: {w.shape}")
            wf = w.astype(np.float32)
            if np.any(wf < 0):
                raise ValueError("Target noun weights may not be negative")
            if wf[:, 0].min() <= 0:
                raise ValueError("Leading target weight cannot be zero")
            if w.shape[1] > 1 and np.any(wf[:, 1:] - wf[:, :-1] > 4 * self.meta.embed_eps):
                raise ValueError("Target noun weights must be sorted high-to-low")
            wnz = wf.astype(bool)
            if np.logical_and(embed_targets == 0, wnz).any():
                raise ValueError("A zero target noun ID cannot carry a non-zero weight")
            if w.shape[1] > 1 and not np.array_equal(np.minimum.accumulate(wnz, axis=1), wnz):
                raise ValueError("Non-zero target noun weights may not appear after a zero entry")
            if self.unit_weights and np.any(np.abs(wf.sum(axis=1) - 1) > 4 * self.meta.embed_eps):
                raise ValueError("Target noun weights are expected to sum to 1 for each embedding")
            self._scatter_write(w, self.meta.embed_target_weights_offset,
                                self.meta.embed_target_weights_stride, embed_index, indices)

    def _scatter_write(self, array: np.ndarray, section_offset: int, stride: int,
                       embed_index: int, indices: Optional[np.ndarray]):
        """Row i of `array` lands at row indices[i] (or embed_index + i) of the section."""
        rows = np.ascontiguousarray(array).view(np.uint8).reshape(array.shape[0], stride)
        section = np.frombuffer(self._map, dtype=np.uint8, count=self.header.embed_num * stride,
                                offset=section_offset).reshape(self.header.embed_num, stride)
        if indices is None:
            section[embed_index:embed_index + rows.shape[0]] = rows
        else:
            section[indices] = rows
        del section
        self.bytes_written += rows.nbytes

    def _close_map(self):
        if self._map is not None:
            self._map.flush()
            self._map.close()
            self._map = None

    def _pwrite(self, buffer, offset: int, expected_size: int):
        n = os.pwrite(self.cache_fd, buffer, offset)
        self.bytes_written += n
        if n != expected_size:
            raise OSError(f"Written buffer was not of the expected size: {n} vs {expected_size}")

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        valid = False
        try:
            expected = self.meta.total_size
            if self.default_weights and self.full_targets and self.use_targets:
                pass  # weights pre-written in __enter__, already counted
            self._close_map()
            if exc_type is None and self.embed_written == self.header.embed_num:
                self._pwrite(MAGIC_BYTES, 0, MAGIC_SIZE)
                os.fsync(self.cache_fd)
                assert os.pread(self.cache_fd, MAGIC_SIZE, 0) == MAGIC_BYTES
                assert os.fstat(self.cache_fd).st_size == expected
                valid = True
        finally:
            fd, self.cache_fd = self.cache_fd, None
            self.shuffle_perm = None
            if fd is not None:
                os.close(fd)
            if valid:
                log.info(f"Embedding cache complete ({self.meta.total_size / (1 << 30):.3f}GiB)")
            else:
                self.remove()
                if exc_type is None:
                    raise RuntimeError("Embedding cache write failed")
                # Otherwise let the original exception propagate (file removed)
        return False

    def remove(self):
        try:
            os.remove(self.cache_path)
            log.warning(f"Deleted cache file {self.cache_path}")
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheExpectation:
    """What the consumer requires of a cache (in the reference this comes from
    the live Embedder object, ref embedding_cache.py:473-549)."""
    embed_dim: Optional[int] = None
    embed_dtype: Optional[np.dtype] = None
    token_dtype: Optional[np.dtype] = None
    embedder_hash: Optional[bytes] = None       # 32-byte SHA-256, checked if strict
    target_config: Optional[TargetConfig] = None  # checked via reduced hash if strict


class EmbeddingCache:
    """Validating memory-mapped reader (ref embedding_cache.py:471-756)."""

    def __init__(self, cache_path: str, expectation: Optional[CacheExpectation] = None,
                 use_targets: Optional[bool] = None, strict_embedder: bool = True):
        self.cache_path = os.path.abspath(cache_path)
        self.use_targets = use_targets
        self.strict_embedder = strict_embedder
        log.info(f"Reading embedding cache {self.cache_path}")

        with open(self.cache_path, "rb") as file:
            self.cache_stat = os.fstat(file.fileno())
            self.header_bytes = file.read(STRUCT_FACTORY.size)
            if len(self.header_bytes) != STRUCT_FACTORY.size:
                raise ValueError("Cache file too short for header")
            self.header = CacheHeader.unpack(self.header_bytes)
            if self.header.magic_bytes != MAGIC_BYTES:
                raise ValueError("Cache file has invalid magic bytes (incomplete write?)")
            if not 1 <= self.header.version <= VERSION:
                raise ValueError(f"Cache file version is unsupported: {self.header.version}")

            exp = expectation or CacheExpectation()
            if self.strict_embedder and self.header.embedder_strict and exp.embedder_hash is not None:
                if exp.embedder_hash != self.header.embedder_hash:
                    raise ValueError("Cache file embedder hash does not match => Incompatible")

            if self.use_targets is None:
                self.use_targets = self.header.use_targets
            if self.use_targets:
                if not self.header.use_targets:
                    raise ValueError("Cache class requires targets but the cache file has none")
                if self.header.target_nouns_num < 1:
                    raise ValueError("Cache file needs at least one target noun")
                nouns_bytes = file.read(self.header.target_nouns_size)
                if len(nouns_bytes) != self.header.target_nouns_size:
                    raise ValueError("Cache file too short for target nouns")
                self.target_nouns = tuple(nouns_bytes.decode("utf-8").split("\x00"))
                if len(self.target_nouns) != self.header.target_nouns_num:
                    raise ValueError("Cache file has an inconsistent number of target nouns")
                if self.target_nouns[0] != "":
                    raise ValueError("First target noun must be the empty string (= invalid)")
            else:
                self.target_nouns = None
            file.seek(0, os.SEEK_END)
            self.cache_size = file.tell()

        self.meta = CacheMeta.from_header(self.header)
        exp = expectation or CacheExpectation()
        if self.header.embed_num < 1:
            raise ValueError("Cache file must have a positive number of embeddings")
        if exp.embed_dim is not None and self.header.embed_dim != exp.embed_dim:
            raise ValueError(f"Embedding dimension mismatch: {self.header.embed_dim} vs {exp.embed_dim}")
        if exp.embed_dtype is not None and self.meta.embed_dtype != np.dtype(exp.embed_dtype):
            raise ValueError(f"Embedding dtype mismatch: {self.meta.embed_dtype} vs {exp.embed_dtype}")
        if self.cache_size != self.meta.total_size:
            raise ValueError(f"Unexpected cache size: {self.cache_size} vs {self.meta.total_size}")
        if self.use_targets:
            if self.header.target_dim < 1 or self.header.embed_targets_dim < 1:
                raise ValueError("Cache file target dimensions must be positive")
            if self.strict_embedder and self.header.embedder_strict and exp.target_config is not None:
                reduced = {k: v for k, v in exp.target_config.as_jsonable().items()
                           if k not in TARGET_EXCLUDE}
                h = hashlib.sha256(json.dumps(reduced, separators=(",", ":"),
                                              sort_keys=True).encode()).digest()
                if h != self.header.target_config_hash:
                    raise ValueError("Cache file target config hash does not match => Incompatible")
            if self.header.target_nouns_num - 1 > np.iinfo(self.meta.embed_targets_dtype).max:
                raise ValueError("Embedding target noun IDs dtype too small for the noun count")

        self.translation: Optional[TargetConfig] = None
        self.source_target_config: Optional[TargetConfig] = (
            exp.target_config if expectation else None)
        self.enter_count = 0
        self._mmap: Optional[mmap_mod.mmap] = None
        self._file = None
        self.target_token_ids: Optional[np.ndarray] = None
        self.target_mask: Optional[np.ndarray] = None
        self.embed_targets: Optional[np.ndarray] = None
        self.embed_target_weights: Optional[np.ndarray] = None
        self._embed_view: Optional[np.ndarray] = None

    def __enter__(self) -> "EmbeddingCache":
        self.enter_count += 1
        if self._mmap is not None:
            return self
        stat = os.stat(self.cache_path)
        if (stat.st_ino, stat.st_mtime_ns) != (self.cache_stat.st_ino, self.cache_stat.st_mtime_ns):
            raise RuntimeError("Cache file changed on disk since it was opened (inode/mtime)")
        self._file = open(self.cache_path, "rb")
        if self._file.read(STRUCT_FACTORY.size) != self.header_bytes:
            raise RuntimeError("Cache file header changed on disk since it was opened")
        self._mmap = mmap_mod.mmap(self._file.fileno(), 0, prot=mmap_mod.PROT_READ)
        try:
            self._mmap.madvise(mmap_mod.MADV_RANDOM)
            self._mmap.madvise(mmap_mod.MADV_WILLNEED)
        except (AttributeError, OSError):
            pass
        h, m = self.header, self.meta
        buf = memoryview(self._mmap)
        self._embed_view = np.frombuffer(
            buf, dtype=m.embed_dtype, count=h.embed_num * h.embed_dim, offset=m.embed_offset
        ).reshape(h.embed_num, h.embed_dim)
        if self.use_targets:
            ids = np.frombuffer(buf, dtype=m.target_dtype,
                                count=h.target_nouns_num * h.target_dim,
                                offset=m.target_offset).reshape(h.target_nouns_num, h.target_dim)
            mask = np.frombuffer(buf, dtype=m.target_mask_dtype,
                                 count=h.target_nouns_num * h.target_dim,
                                 offset=m.target_mask_offset).reshape(h.target_nouns_num, h.target_dim)
            # Target-config translation on enter (ref embedding_cache.py:668-683)
            if self.translation is not None and self.source_target_config is not None:
                ids = translate_target_tokens(np.ascontiguousarray(ids),
                                              self.source_target_config, self.translation)
                ids = ids.astype(m.target_dtype)
            self.target_token_ids = ids
            self.target_mask = mask
            self.embed_targets = np.frombuffer(
                buf, dtype=m.embed_targets_dtype, count=h.embed_num * h.embed_targets_dim,
                offset=m.embed_targets_offset).reshape(h.embed_num, h.embed_targets_dim)
            self.embed_target_weights = np.frombuffer(
                buf, dtype=m.embed_dtype, count=h.embed_num * h.embed_targets_dim,
                offset=m.embed_target_weights_offset).reshape(h.embed_num, h.embed_targets_dim)
        log.info("Memory-mapped embedding cache")
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        self.enter_count -= 1
        if self.enter_count <= 0:
            self.enter_count = 0
            if self._mmap is not None:
                self._embed_view = None
                self.target_token_ids = None
                self.target_mask = None
                self.embed_targets = None
                self.embed_target_weights = None
                try:
                    self._mmap.close()
                except BufferError:
                    # Zero-copy views of the map are still alive in user code;
                    # the map is freed when the last view is garbage-collected.
                    pass
                self._file.close()
                self._mmap = None
                self._file = None
        return False

    def get_samples(self, start: int, stop: int, use_weights: bool = True):
        """Slice read → (embed BxF, target_ids BxM, target BxMxC, mask BxMxC, weight BxM)
        (ref embedding_cache.py:699-723)."""
        if self._mmap is None:
            raise RuntimeError("Enter the cache context before accessing its data")
        if start < 0 or stop < 0:
            raise IndexError("Index must be non-negative")
        stop = min(stop, self.header.embed_num)
        embed = self._embed_view[start:stop]
        if self.use_targets:
            target_ids = self.embed_targets[start:stop]
            target = self.target_token_ids[target_ids, :]
            mask = self.target_mask[target_ids, :]
            weight = self.embed_target_weights[start:stop] if use_weights else None
        else:
            target_ids = target = mask = weight = None
        return embed, target_ids, target, mask, weight

    def set_translation_source(self, source: TargetConfig):
        self.source_target_config = source

    def create_dataset(self, batch_size: int, training: bool) -> "CacheDataset":
        return CacheDataset(self, batch_size=batch_size, training=training)


class CacheDataset(EmbeddingDataset):
    """Whole-batch items over a cache with per-epoch circular offset
    (ref embedding_cache.py:758-915)."""

    def __init__(self, embed_cache: EmbeddingCache, batch_size: int, training: bool):
        self.embed_cache = embed_cache
        self.header = embed_cache.header
        self.batch_size = batch_size
        self.training = training
        if batch_size < 1:
            raise ValueError(f"Batch size must be a positive integer: {batch_size}")
        if batch_size > self.header.embed_num:
            raise ValueError(
                f"Batch size cannot exceed the number of embeddings: "
                f"{batch_size} > {self.header.embed_num}")

        num_embeds = self.header.embed_num
        complete_batches, incomplete_samples = divmod(num_embeds, batch_size)
        incomplete_batch = incomplete_samples > 0
        num_items = complete_batches
        if training:
            if incomplete_batch:
                num_embeds -= incomplete_samples
                incomplete_batch = False
                incomplete_samples = 0
        else:
            num_items += incomplete_batch

        self.epoch_index_offset = 0

        super().__init__(
            target_config=embed_cache.source_target_config,
            nominal_data_config=DataConfig(
                use_weights=not (self.header.default_weights and self.header.full_targets),
                unit_weights=self.header.unit_weights,
                multi_target=self.header.embed_targets_dim > 1,
                multi_first=False,
                full_targets=self.header.full_targets,
                fixed_multi_length=False,
                multi_length=self.header.embed_targets_dim or 1,
            ),
            strict_data_config_fields=set() if self.header.full_targets else {"full_targets"},
            num_items=num_items,
            num_embeds=num_embeds,
            targets=embed_cache.target_nouns,
            num_invalid_targets=1 if embed_cache.target_nouns else 0,
            use_targets=embed_cache.use_targets,
        )
        self.loader_info_data = dict(
            batch_size=batch_size,
            batch_size_last=incomplete_samples,
            complete_batches=complete_batches,
            incomplete_batch=incomplete_batch,
            epoch_batches=self.num_items,
            epoch_samples=self.num_embeds,
            available_samples=self.num_embeds,
        )

    def set_translation(self, target_config: Optional[TargetConfig]):
        super().set_translation(target_config)
        self.embed_cache.translation = self.translation

    def loaded(self):
        return self.embed_cache

    def new_epoch(self, rng: Optional[random.Random] = None):
        """Pick the per-epoch circular offset (ref embedding_cache.py:930-939)."""
        if self.training:
            r = rng or random
            self.epoch_index_offset = r.randrange(self.num_embeds)
        else:
            self.epoch_index_offset = 0

    def __getitem__(self, index: int):
        if index < 0 or index >= self.num_items:
            raise IndexError("Index out of range")
        dc = self.data_config
        cache = self.embed_cache
        N = self.header.embed_num

        if self.epoch_index_offset == 0 or not self.training:
            start = index * self.batch_size
            embed, target_ids, target, mask, weight = cache.get_samples(
                start, start + self.batch_size, use_weights=dc.use_weights)
        else:
            start = (index * self.batch_size + self.epoch_index_offset) % N
            stop = (start + self.batch_size - 1) % N + 1
            if start < stop:
                embed, target_ids, target, mask, weight = cache.get_samples(
                    start, stop, use_weights=dc.use_weights)
            else:
                parts = list(zip(cache.get_samples(start, N, use_weights=dc.use_weights),
                                 cache.get_samples(0, stop, use_weights=dc.use_weights)))
                embed, target_ids, target, mask, weight = (
                    None if a is None else np.concatenate((a, b), axis=0) for a, b in parts)

        if target_ids is not None:
            if dc.multi_target:
                trimmed_multi_length = dc.multi_length < target.shape[1]
                if trimmed_multi_length:
                    target = target[:, :dc.multi_length, :]
                    if mask is not None:
                        mask = mask[:, :dc.multi_length, :]
                    if weight is None:
                        target_ids = target_ids[:, :dc.multi_length]
                    else:
                        weight = weight[:, :dc.multi_length]
                if not dc.fixed_multi_length and target.shape[1] > 1:
                    cols = (target_ids if weight is None else weight).astype(bool).any(axis=0)
                    if not cols.all():
                        col_index = int(np.argmin(cols))
                        target = target[:, :col_index, :]
                        if mask is not None:
                            mask = mask[:, :col_index, :]
                        if weight is not None:
                            weight = weight[:, :col_index]
                if weight is not None and dc.unit_weights and (
                        not self.header.unit_weights or trimmed_multi_length):
                    weight = np.asarray(weight, dtype=weight.dtype).copy()
                    if weight.shape[1] == 1:
                        weight[:] = 1
                    else:
                        sums = np.abs(weight).sum(axis=1, keepdims=True)
                        weight = weight / np.maximum(sums, np.finfo(np.float32).tiny)
            else:
                target = target[:, 0, :]
                if mask is not None:
                    mask = mask[:, 0, :]
                if weight is not None:
                    weight_length = weight.shape[1]
                    weight = weight[:, 0].copy()
                    if dc.unit_weights and (not self.header.unit_weights or weight_length > 1):
                        weight[:] = 1

            # Dynamic token-length trimming (drop all-padding trailing columns)
            tc = self.target_config or self.embed_cache.source_target_config
            fixed_len = tc.fixed_token_length if tc is not None else True
            if not fixed_len and mask is not None:
                all_masked = mask.reshape(-1, mask.shape[-1]).all(axis=0)
                if all_masked.any():
                    col_index = int(np.argmax(all_masked))
                    target = target[..., :col_index]
                    mask = mask[..., :col_index]

            if dc.multi_target and dc.multi_first:
                target = np.swapaxes(target, 0, 1)
                if mask is not None:
                    mask = np.swapaxes(mask, 0, 1)
                if weight is not None:
                    weight = np.swapaxes(weight, 0, 1)
        else:
            target = mask = weight = None

        return embed, target, mask, weight

    def create_loader(self, batch_size: int, training: bool, *, num_threads: int = 1,
                      prefetch: int = 2, device=None, seed: Optional[int] = None):
        """(BatchLoader, LoaderInfo). With a device, batches arrive as tensors on it
        (pinned host memory, non-blocking copies); without, as numpy arrays."""
        from novic_tpu_torch.data.loader import BatchLoader

        if batch_size != self.batch_size or training != self.training:
            raise ValueError("Batch size and training mode must match the dataset constructor")
        loader = BatchLoader(self, prefetch=prefetch, device=device, seed=seed)
        on_device = loader.device is not None
        info = LoaderInfo(num_workers=num_threads, prefetch_factor=prefetch,
                          pin_memory=on_device and loader.device.type == "cuda",
                          on_device=on_device, **self.loader_info_data)
        return loader, info
