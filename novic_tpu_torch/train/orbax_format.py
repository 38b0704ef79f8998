"""Orbax checkpoint directories (what `orbax.checkpoint.StandardCheckpointer`
writes) read and written without orbax: zarr v2 arrays in the port's OCDBT
store, and orbax's tree metadata.

    <dir>/_CHECKPOINT_METADATA   JSON: the handler, timestamps
    <dir>/_METADATA              JSON: tree_metadata, use_ocdbt, use_zarr3, ...
    <dir>/manifest.ocdbt, d/     the OCDBT store (ocdbt.py); orbax's own root store
                                 also references per-process stores under
                                 ocdbt.process_<n>/

`_METADATA`'s tree_metadata maps each leaf's key path (the repr of a tuple of
str) to its keys, each with a key_type (1: a sequence index, 2: a dict key), and
its value metadata. A leaf is a zarr v2 array in the store under its keys joined
by ".": "<name>/.zarray" holds the array's JSON metadata and
"<name>/<i>.<j>..." each chunk ("<name>/0" for a 0-d array), zstd-compressed
where the metadata's compressor says so. Edge chunks are stored whole; a chunk
the store lacks holds the fill value (null: zeros).

Read: dtypes <f4 <f2 <f8 <i1.. <i8 <u1.. <u8 |b1 (either byte order) and
"bfloat16" (as ml_dtypes.bfloat16), C order, the compressors null and zstd.
zarr3, zarr filters, F order, other compressors and other value types raise
ValueError naming what is unsupported.

Write: one chunk per array (as orbax does for a single-device array), zstd
frames of raw blocks, one OCDBT version; the directory is written under a
temporary name beside `path` and renamed into place. Orbax restores it with no
target tree.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import secrets
import shutil
import time
from typing import Any, Optional

import numpy as np

from novic_tpu_torch.train import ocdbt, zstd

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
KEY_SEQUENCE, KEY_DICT = 1, 2
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_ARRAY_VALUE_TYPES = ("np.ndarray", "jax.Array")
# zstd's largest expansion: an RLE block, 4 bytes for 128 KiB
_ZSTD_MAX_RATIO = 1 << 15
# The most bytes of fill (chunks the store lacks) an array may hold
_MAX_FILL_BYTES = 1 << 24


def _unsupported(what: str):
    raise ValueError(f"orbax checkpoint: {what} is not supported")


def _bfloat16() -> np.dtype:
    try:
        import ml_dtypes
    except ImportError:
        _unsupported("dtype bfloat16 without ml_dtypes")
    return np.dtype(ml_dtypes.bfloat16)


def _dtype(spec) -> np.dtype:
    if spec == "bfloat16":
        return _bfloat16()
    if not isinstance(spec, str):
        _unsupported(f"zarr dtype {spec!r}")
    try:
        dt = np.dtype(spec)
    except TypeError:
        _unsupported(f"zarr dtype {spec!r}")
    if dt.kind not in "biuf" or dt.itemsize > 8:
        _unsupported(f"zarr dtype {spec!r}")
    return dt


def _dtype_spec(dt: np.dtype) -> str:
    if dt.kind == "V" and dt.itemsize == 2 and dt.name == "bfloat16":
        return "bfloat16"
    if dt.kind not in "biuf" or dt.itemsize > 8:
        _unsupported(f"dtype {dt}")
    return dt.str


def _fill(value, dt: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special or dt.kind != "f":
            _unsupported(f"fill_value {value!r} for {dt}")
        return special[value]
    return value


class ZarrArray:
    """A zarr v2 array's metadata (its `.zarray` JSON)."""

    def __init__(self, meta: dict):
        if meta.get("zarr_format") != 2:
            _unsupported(f"zarr_format {meta.get('zarr_format')!r}")
        if meta.get("order", "C") != "C":
            _unsupported(f"zarr order {meta.get('order')!r}")
        if meta.get("filters"):
            _unsupported(f"zarr filters {meta['filters']!r}")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            _unsupported(f"zarr compressor {compressor.get('id')!r}")
        self.compressed = compressor is not None
        self.dtype = _dtype(meta.get("dtype"))
        self.shape = tuple(int(n) for n in meta["shape"])
        self.chunks = tuple(int(n) for n in meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c <= 0 for c in self.chunks) \
                or any(n < 0 for n in self.shape):
            raise ValueError(f"orbax checkpoint: chunks {self.chunks} for shape {self.shape}")
        self.separator = meta.get("dimension_separator", ".")
        if self.separator not in (".", "/"):
            _unsupported(f"dimension_separator {self.separator!r}")
        self.fill_value = _fill(meta.get("fill_value"), self.dtype)

    def chunk_keys(self):
        """(key, chunk index) of every chunk of the grid."""
        if not self.shape:
            yield "0", ()
            return
        grid = [math.ceil(n / c) for n, c in zip(self.shape, self.chunks)]
        for idx in np.ndindex(*grid):
            yield self.separator.join(str(i) for i in idx), idx

    def decode_chunk(self, data: bytes, out: np.ndarray) -> None:
        """A stored chunk's bytes into `out` (the chunk's full shape)."""
        if self.compressed:
            zstd.decompress_into(data, out.reshape(-1).view(np.uint8))
        elif len(data) != out.nbytes:
            raise ValueError(f"orbax checkpoint: chunk of {len(data)} bytes, {out.nbytes} expected")
        else:
            out.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)


def _check_size(za: ZarrArray, stored: list[int], name: str) -> None:
    """Refuse, before anything is allocated, a declared shape larger than what the
    array's stored chunks (their byte lengths) can decode to plus `_MAX_FILL_BYTES`
    of fill: a corrupt or hostile `.zarray` may declare any shape."""
    chunk_bytes = math.prod(za.chunks) * za.dtype.itemsize
    n_chunks = math.prod(math.ceil(n / c) for n, c in zip(za.shape, za.chunks))
    fill = max(n_chunks - len(stored), 0) * chunk_bytes
    decodable = sum(stored) * (_ZSTD_MAX_RATIO if za.compressed else 1)
    nbytes = math.prod(za.shape) * za.dtype.itemsize
    if fill > _MAX_FILL_BYTES or nbytes > decodable + _MAX_FILL_BYTES:
        raise ValueError(f"orbax checkpoint: {name!r} declares shape {za.shape} of {za.dtype} "
                         f"({nbytes} bytes) in {len(stored)} stored chunks of {sum(stored)} bytes")


def _read_array(store: ocdbt.Reader, entries: dict, keys: list[bytes], name: str) -> np.ndarray:
    """The array `name`; `keys` are the entries' keys, sorted."""
    meta_key = f"{name}/.zarray".encode()
    meta_value = entries.get(meta_key)
    if meta_value is None:
        raise ValueError(f"orbax checkpoint: no zarr array {name!r} in the store")
    za = ZarrArray(json.loads(_value(store, meta_value)))
    prefix = f"{name}/".encode()
    # The keys that start with "<name>/" ("0" follows "/")
    lo, hi = bisect.bisect_left(keys, prefix), bisect.bisect_left(keys, prefix[:-1] + b"0")
    _check_size(za, [len(v) if isinstance(v, bytes) else v.length
                     for v in (entries[k] for k in keys[lo:hi] if k != meta_key)], name)
    out = np.empty(za.shape, za.dtype)
    if out.size == 0:
        return out
    whole = za.chunks == za.shape
    for key, idx in za.chunk_keys():
        value = entries.get(f"{name}/{key}".encode())
        if not za.shape:
            region = (Ellipsis,)
        else:
            region = tuple(slice(i * c, min((i + 1) * c, n))
                           for i, c, n in zip(idx, za.chunks, za.shape))
        if value is None:
            out[region] = za.fill_value
        elif whole:
            za.decode_chunk(_value(store, value), out)
        else:
            chunk = np.empty(za.chunks, za.dtype)
            za.decode_chunk(_value(store, value), chunk)
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _value(store: ocdbt.Reader, value) -> bytes:
    return value if isinstance(value, bytes) else store.read(value)


def _restore(leaves: list[tuple[list, Any]]):
    """Nested dicts and lists from (key metadata, value) pairs."""
    root: dict = {}
    for keys, value in leaves:
        node = root
        for i, k in enumerate(keys):
            name = (k["key_type"], str(k["key"]))
            if i == len(keys) - 1:
                node[name] = value
            else:
                node = node.setdefault(name, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        types = {t for t, _ in node}
        if types == {KEY_SEQUENCE}:
            items = sorted((int(k), v) for (_, k), v in node.items())
            if [i for i, _ in items] != list(range(len(items))):
                raise ValueError(f"orbax checkpoint: sequence indices {[i for i, _ in items]}")
            return [build(v) for _, v in items]
        if types == {KEY_DICT}:
            return {k: build(v) for (_, k), v in node.items()}
        _unsupported(f"key types {sorted(types)} in one container")

    return build(root)


def read_tree(path: str):
    """The tree of numpy arrays an orbax StandardCheckpointer directory holds."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        _unsupported("zarr3 (use_zarr3: true)")
    if not meta.get("use_ocdbt", False):
        _unsupported("a checkpoint without OCDBT (use_ocdbt: false)")
    tree_meta = meta.get("tree_metadata")
    if not isinstance(tree_meta, dict):
        raise ValueError(f"orbax checkpoint: {path}/{METADATA} has no tree_metadata")
    with ocdbt.Reader(path) as store:
        entries = dict(store.entries())
        stored_keys = list(entries)  # sorted
        leaves = []
        for entry in tree_meta.values():
            value_type = entry.get("value_metadata", {}).get("value_type")
            if value_type not in _ARRAY_VALUE_TYPES:
                _unsupported(f"value type {value_type!r}")
            keys = entry["key_metadata"]
            name = ".".join(str(k["key"]) for k in keys)
            leaves.append((keys, _read_array(store, entries, stored_keys, name)))
    return _restore(leaves)


def _flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    """((key, key_type), ...) paths of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            if not isinstance(k, str) or "." in k:
                raise ValueError(f"orbax checkpoint: dict key {k!r} (str without '.')")
            out += _flatten(v, prefix + ((k, KEY_DICT),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + ((str(i), KEY_SEQUENCE),))
        return out
    return [(prefix, np.asarray(tree))]


def write_tree(path: str, tree, extra_files: Optional[dict[str, bytes]] = None) -> None:
    """Write `tree` (nested dicts and lists of arrays) as an orbax
    StandardCheckpointer directory at `path`, replacing what is there.
    `extra_files` (name → bytes) are written into the directory too."""
    path = os.path.abspath(path.rstrip("/"))
    init_ns = time.time_ns()
    leaves = _flatten(tree)
    if not leaves or any(not keys for keys, _ in leaves):
        raise ValueError("orbax checkpoint: the tree must be a container of arrays")
    tmp = f"{path}.orbax-tmp-{secrets.token_hex(4)}"
    os.makedirs(tmp)
    try:
        items, tree_meta = [], {}
        for keys, arr in leaves:
            arr = np.asarray(arr, order="C")  # (ascontiguousarray would make 0-d arrays 1-d)
            if arr.size == 0:
                _unsupported(f"an array of zero size ({'.'.join(k for k, _ in keys)}), "
                             f"as in orbax,")
            name = ".".join(k for k, _ in keys)
            zarray = {"chunks": list(arr.shape), "compressor": {"id": "zstd", "level": 0},
                      "dimension_separator": ".", "dtype": _dtype_spec(arr.dtype),
                      "fill_value": None, "filters": None, "order": "C",
                      "shape": list(arr.shape), "zarr_format": 2}
            chunk = ".".join("0" for _ in arr.shape) or "0"
            items.append((f"{name}/.zarray".encode(),
                          json.dumps(zarray, sort_keys=True, separators=(",", ":")).encode()))
            items.append((f"{name}/{chunk}".encode(),
                          zstd.compress_raw(arr.reshape(-1).view(np.uint8))))
            tree_meta[repr(tuple(k for k, _ in keys))] = {
                "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
        ocdbt.write(tmp, items)
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
        for name, data in (extra_files or {}).items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": init_ns, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        # What `path` held is moved aside, not deleted, until the new directory is in place
        old = f"{tmp}-old" if os.path.lexists(path) else None
        if old:
            os.rename(path, old)
        try:
            os.rename(tmp, path)
        except OSError:
            if old:
                os.rename(old, path)
            raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old and os.path.isdir(old):
        shutil.rmtree(old)
    elif old:
        os.remove(old)

