"""OCDBT, tensorstore's key-value store of B+trees, as orbax writes it: a reader
and a single-writer writer in Python and the port's zstd and CRC-32C code.

A store is a directory:

    manifest.ocdbt   the config and the version tree (its newest leaf inline)
    d/<32 hex>       data files: indirect values, B+tree and version-tree nodes

Every manifest and node is an envelope: magic (uint32 big-endian), length of the
whole envelope (uint64 little-endian), format version (varint, 0), compression
(varint: 0 none, 1 zstd), the body (one zstd frame when compressed) and the
CRC-32C of every byte before it (uint32 little-endian). Integers in bodies are
unsigned LEB128 varints unless named otherwise, and each list is stored column by
column.

* Config: uuid (16 bytes), manifest kind (0: the version tree lives in this
  manifest), max inline value bytes, max decoded node bytes, version tree arity
  log2 (uint8), compression (0 none, 1 zstd followed by its level, int32le).
* Data file table, at the head of each body that references data files: count,
  then for files 1.. the length of the path prefix shared with the previous
  file, the suffix lengths, the base path lengths, and the suffix bytes. A
  file's path is relative to the store's root after the base path of the data
  file the body was read from (its "transitive" path): orbax's root store
  references the files of ocdbt.process_<n>/ that way.
* Manifest (kind 0): config, data file table, the newest version-tree leaf's
  entries (below), then references to older version-tree nodes (generation,
  file, offset, length, number of generations, commit time uint64le, height
  uint8).
* Version entries: generation, root height (uint8), root file, offset, length
  (offset and length 2^64 - 1 for an empty tree), then the root's number of keys,
  tree bytes and indirect value bytes, and the commit time (uint64le, ns).
* B+tree node: height (uint8), data file table, entry count, then for entries
  1.. the key prefix length shared with the previous key, the key suffix
  lengths, (interior nodes: the subtree common prefix lengths), the key suffix
  bytes. A leaf continues with value lengths, value kinds (0 inline, 1
  indirect), the indirect values' files and offsets, and the inline values'
  bytes. An interior node continues with its children's files, offsets,
  lengths, numbers of keys, tree bytes and indirect value bytes. A node's keys
  are stored without the prefix its parent's entry declares common to the
  subtree.
* Version-tree node: arity log2 (uint8), height (uint8), data file table, then
  version entries (height 0) or references to children (generation, file,
  offset, length, number of generations, commit time uint64le).

The writer makes one version (generation 1) of one writer: indirect values and
the nodes go into one data file, leaves are split to `max_decoded_node_bytes`
(tensorstore's default, 8 MiB), and bodies are compressed as zstd frames of
raw blocks. Any format violation or checksum mismatch raises ValueError.
"""

from __future__ import annotations

import dataclasses
import os
import secrets
import struct
import time
from typing import Iterable, Optional, Union

from novic_tpu_torch.train import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
MANIFEST = "manifest.ocdbt"
MISSING = (1 << 64) - 1
DEFAULT_MAX_INLINE_VALUE_BYTES = 100
DEFAULT_MAX_DECODED_NODE_BYTES = 8 << 20
DEFAULT_VERSION_TREE_ARITY_LOG2 = 4


@dataclasses.dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    zstd_level: Optional[int]  # None: uncompressed


@dataclasses.dataclass(frozen=True)
class Ref:
    """Bytes [offset, offset + length) of a data file, which lies at `path`
    under the store's root; `base` is the file's base path."""
    path: str
    base: str
    offset: int
    length: int


@dataclasses.dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Optional[Ref]  # None: the empty tree
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time_ns: int


def _fail(what: str):
    raise ValueError(f"ocdbt: {what}")


class _Body:
    """Cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or n > len(self.data) - self.pos:
            _fail(f"{self.what} ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if shift > 63:
                _fail(f"{self.what}: varint too long")
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7

    def count(self) -> int:
        """A list's length, which cannot exceed the bytes that remain."""
        n = self.varint()
        if n > len(self.data) - self.pos:
            _fail(f"{self.what}: list of {n} in {len(self.data) - self.pos} bytes")
        return n

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            _fail(f"{self.what}: {len(self.data) - self.pos} trailing bytes")


def _open_envelope(data: bytes, magic: int, what: str, max_size: int = 1 << 26) -> bytes:
    if len(data) < 18:
        _fail(f"{what}: {len(data)} bytes")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        _fail(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(data):
        _fail(f"{what}: length field {length}, {len(data)} bytes")
    if zstd.crc32c(memoryview(data)[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        _fail(f"{what}: CRC-32C mismatch")
    head = _Body(data[:-4], what)
    head.take(12)
    if head.varint() != 0:
        _fail(f"{what}: unsupported format version")
    compression = head.varint()
    body = data[head.pos:-4]
    if compression == 1:
        return zstd.decompress(body, max_size)
    if compression != 0:
        _fail(f"{what}: unknown compression {compression}")
    return body


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _seal(magic: int, body: bytes) -> bytes:
    """The envelope of `body`, compressed as a zstd frame of raw blocks."""
    payload = zstd.compress_raw(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + 2 + len(payload) + 4) + b"\x00\x01"
    data = head + payload
    return data + struct.pack("<I", zstd.crc32c(data))


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _read_config(b: _Body) -> Config:
    uuid = b.take(16)
    kind, max_inline, max_node = b.varint(), b.varint(), b.varint()
    arity = b.u8()
    method = b.varint()
    if method == 0:
        level = None
    elif method == 1:
        level = struct.unpack("<i", b.take(4))[0]
    else:
        _fail(f"unknown compression method {method} in the config")
    return Config(uuid, kind, max_inline, max_node, arity, level)


def _read_files(b: _Body, transitive: str) -> list[tuple[str, str]]:
    """The data file table → [(path under the root, base path)]."""
    n = b.count()
    prefix = [0] + b.varints(n - 1) if n else []
    suffix = b.varints(n)
    base = b.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            _fail("data file path prefix longer than the previous path")
        path = prev[:prefix[i]] + b.take(suffix[i])
        if base[i] > len(path):
            _fail("data file base path longer than its path")
        prev = path
        full = transitive + path.decode()
        files.append((full, transitive + path[:base[i]].decode()))
    return files


def _ref(files: list, file_id: int, offset: int, length: int) -> Ref:
    if file_id >= len(files):
        _fail(f"data file {file_id} of {len(files)}")
    path, base = files[file_id]
    return Ref(path, base, offset, length)


def _read_versions(b: _Body, files: list) -> list[Version]:
    n = b.count()
    gen, height = b.varints(n), [b.u8() for _ in range(n)]
    file_ids, offsets, lengths = b.varints(n), b.varints(n), b.varints(n)
    keys, tree, indirect = b.varints(n), b.varints(n), b.varints(n)
    times = [b.uint(8) for _ in range(n)]
    out = []
    for i in range(n):
        root = None if offsets[i] == MISSING else _ref(files, file_ids[i], offsets[i], lengths[i])
        out.append(Version(gen[i], height[i], root, keys[i], tree[i], indirect[i], times[i]))
    return out


@dataclasses.dataclass(frozen=True)
class _VersionNodeRef:
    generation: int
    ref: Ref
    num_generations: int
    commit_time_ns: int
    height: int


def _read_version_node_refs(b: _Body, files: list, child_height: Optional[int] = None) -> list:
    """References to version-tree nodes: a manifest's carry their heights, an
    interior node's children are all one level below it."""
    n = b.count()
    gen, file_ids, offsets, lengths = b.varints(n), b.varints(n), b.varints(n), b.varints(n)
    num_gen = b.varints(n)
    times = [b.uint(8) for _ in range(n)]
    heights = [b.u8() for _ in range(n)] if child_height is None else [child_height] * n
    return [_VersionNodeRef(gen[i], _ref(files, file_ids[i], offsets[i], lengths[i]), num_gen[i],
                            times[i], heights[i]) for i in range(n)]


Value = Union[bytes, Ref]


class Reader:
    """The newest version of a store (or any generation of its version tree).

    with Reader(path) as store:
        for key, value in store.items():   # sorted keys, value bytes
            ...
    """

    def __init__(self, root: str):
        self.root = root
        self._files: dict[str, object] = {}
        with open(os.path.join(root, MANIFEST), "rb") as f:
            data = f.read()
        b = _Body(_open_envelope(data, MANIFEST_MAGIC, MANIFEST), MANIFEST)
        self.config = _read_config(b)
        if self.config.manifest_kind != 0:
            _fail(f"manifest kind {self.config.manifest_kind} (numbered manifests) is not read")
        files = _read_files(b, "")
        self._inline_versions = _read_versions(b, files)
        self._version_nodes = _read_version_node_refs(b, files)
        b.end()
        if not self._inline_versions:
            _fail("the manifest holds no version")

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self) -> "Reader":
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, ref: Ref) -> bytes:
        """The bytes a reference points at."""
        f = self._files.get(ref.path)
        if f is None:
            path = os.path.normpath(os.path.join(self.root, ref.path))
            if os.path.relpath(path, self.root).startswith(".."):
                _fail(f"data file {ref.path!r} lies outside the store")
            f = self._files[ref.path] = open(path, "rb")
        f.seek(ref.offset)
        data = f.read(ref.length)
        if len(data) != ref.length:
            _fail(f"{ref.path}: {len(data)} of {ref.length} bytes at {ref.offset}")
        return data

    @property
    def latest(self) -> Version:
        return self._inline_versions[-1]

    def versions(self) -> list[Version]:
        """Every version of the version tree, oldest first."""
        out = []
        for node in self._version_nodes:
            out.extend(self._version_subtree(node.ref, node.height))
        return out + self._inline_versions

    def _version_subtree(self, ref: Ref, height: int) -> list[Version]:
        b = _Body(_open_envelope(self.read(ref), VERSION_TREE_MAGIC, "version tree node",
                                 self.config.max_decoded_node_bytes), "version tree node")
        b.u8()  # arity log2
        if b.u8() != height:
            _fail("version tree node height differs from its reference's")
        files = _read_files(b, ref.base)
        if height == 0:
            found = _read_versions(b, files)
            b.end()
            return found
        children = _read_version_node_refs(b, files, child_height=height - 1)
        b.end()
        return [v for c in children for v in self._version_subtree(c.ref, height - 1)]

    def entries(self, version: Optional[Version] = None) -> list[tuple[bytes, Value]]:
        """(key, inline bytes or a Ref to an indirect value), sorted by key."""
        v = version or self.latest
        out: list = []
        if v.root is not None:
            self._node(v.root, v.root_height, b"", out)
        return out

    def items(self, version: Optional[Version] = None) -> list[tuple[bytes, bytes]]:
        return [(k, v if isinstance(v, bytes) else self.read(v)) for k, v in self.entries(version)]

    def _node(self, ref: Ref, height: int, prefix: bytes, out: list):
        data = _open_envelope(self.read(ref), BTREE_MAGIC, f"B+tree node {ref.path}@{ref.offset}",
                              self.config.max_decoded_node_bytes)
        b = _Body(data, "B+tree node")
        if b.u8() != height:
            _fail("node height differs from its reference's")
        files = _read_files(b, ref.base)
        n = b.count()
        key_prefix = [0] + b.varints(n - 1) if n else []
        key_suffix = b.varints(n)
        common = b.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if key_prefix[i] > len(prev):
                _fail("key prefix longer than the previous key")
            prev = prev[:key_prefix[i]] + b.take(key_suffix[i])
            keys.append(prev)
        if height == 0:
            lengths = b.varints(n)
            kinds = b.varints(n)
            if any(k > 1 for k in kinds):
                _fail("unknown value kind")
            indirect = [i for i in range(n) if kinds[i] == 1]
            file_ids, offsets = b.varints(len(indirect)), b.varints(len(indirect))
            refs = {i: _ref(files, f, o, lengths[i]) for i, f, o in zip(indirect, file_ids, offsets)}
            for i in range(n):
                out.append((prefix + keys[i], refs[i] if kinds[i] else b.take(lengths[i])))
            b.end()
            return
        file_ids, offsets, lengths = b.varints(n), b.varints(n), b.varints(n)
        b.varints(3 * n)  # the children's statistics
        b.end()
        for i in range(n):
            if common[i] > len(keys[i]):
                _fail("subtree common prefix longer than its key")
            self._node(_ref(files, file_ids[i], offsets[i], lengths[i]), height - 1,
                       prefix + keys[i][:common[i]], out)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _files_table(path: Optional[str]) -> bytes:
    """A table of no file or of the one data file (base path empty)."""
    if path is None:
        return _varint(0)
    p = path.encode()
    return _varint(1) + _varint(len(p)) + _varint(0) + p


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _keys_columns(keys: list[bytes]) -> tuple[bytes, bytes, bytes]:
    """(prefix lengths of entries 1.., suffix lengths, suffix bytes)."""
    prefixes, suffixes, data = bytearray(), bytearray(), bytearray()
    prev = b""
    for i, k in enumerate(keys):
        p = _common_prefix(prev, k) if i else 0
        if i:
            prefixes += _varint(p)
        suffixes += _varint(len(k) - p)
        data += k[p:]
        prev = k
    return bytes(prefixes), bytes(suffixes), bytes(data)


@dataclasses.dataclass
class _Child:
    first: bytes  # full keys
    last: bytes
    offset: int
    length: int
    num_keys: int
    tree_bytes: int
    indirect_bytes: int


def _groups(sizes: list[int], limit: int, overhead: int) -> list[range]:
    """Consecutive runs of items whose estimated sizes fit in `limit`."""
    out, start, total = [], 0, overhead
    for i, s in enumerate(sizes):
        if i > start and total + s > limit:
            out.append(range(start, i))
            start, total = i, overhead
        total += s
    out.append(range(start, len(sizes)))
    return out


def write(root: str, items: Iterable[tuple[bytes, bytes]], *,
          max_inline_value_bytes: int = DEFAULT_MAX_INLINE_VALUE_BYTES,
          max_decoded_node_bytes: int = DEFAULT_MAX_DECODED_NODE_BYTES) -> None:
    """Write a new store of `items` into the directory `root` (created if missing;
    it must not hold a store already)."""
    entries = sorted(items)
    if not entries:
        raise ValueError("ocdbt: a store needs at least one key")
    if any(a[0] == b[0] for a, b in zip(entries, entries[1:])):
        raise ValueError("ocdbt: duplicate keys")
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    if os.path.exists(os.path.join(root, MANIFEST)):
        raise ValueError(f"ocdbt: {root} already holds a store")
    data_path = "d/" + secrets.token_hex(16)
    with open(os.path.join(root, data_path), "wb") as f:
        pos = 0

        def append(blob: bytes) -> int:
            nonlocal pos
            f.write(blob)
            pos += len(blob)
            return pos - len(blob)

        # Indirect values first, then the nodes bottom-up
        placed = []  # (key, inline bytes or (offset, length))
        for key, value in entries:
            if len(value) > max_inline_value_bytes:
                placed.append((key, (append(value), len(value))))
            else:
                placed.append((key, bytes(value)))
        table = _files_table(data_path)
        sizes = [len(k) + 24 + (len(v) if isinstance(v, bytes) else 0) for k, v in placed]
        leaves = _groups(sizes, max_decoded_node_bytes, 8 + len(table))
        level: list[_Child] = []
        for run in leaves:
            node = [placed[i] for i in run]
            base = b"" if len(leaves) == 1 else node[0][0][:_common_prefix(node[0][0], node[-1][0])]
            keys = [k[len(base):] for k, _ in node]
            pre, suf, kbytes = _keys_columns(keys)
            lengths = b"".join(_varint(len(v) if isinstance(v, bytes) else v[1]) for _, v in node)
            kinds = b"".join(b"\x00" if isinstance(v, bytes) else b"\x01" for _, v in node)
            indirect = [v for _, v in node if not isinstance(v, bytes)]
            inline = b"".join(v for _, v in node if isinstance(v, bytes))
            body = (b"\x00" + (table if indirect else _files_table(None)) + _varint(len(node))
                    + pre + suf + kbytes + lengths + kinds
                    + b"".join(_varint(0) for _ in indirect) + b"".join(_varint(o) for o, _ in indirect)
                    + inline)
            sealed = _seal(BTREE_MAGIC, body)
            ind_bytes = sum(n for _, n in indirect)
            level.append(_Child(node[0][0], node[-1][0], append(sealed), len(sealed), len(node),
                                len(sealed), ind_bytes))
        height = 0
        while len(level) > 1:
            height += 1
            sizes = [len(c.first) + 64 for c in level]
            groups = _groups(sizes, max_decoded_node_bytes, 8 + len(table))
            upper = []
            for run in groups:
                kids = [level[i] for i in run]
                first, last = kids[0].first, kids[-1].last
                base = b"" if len(groups) == 1 else first[:_common_prefix(first, last)]
                keys = [c.first[len(base):] for c in kids]
                pre, suf, kbytes = _keys_columns(keys)
                common = []
                for c in kids:
                    common.append(_common_prefix(c.first, c.last) - len(base))
                body = (bytes([height]) + table + _varint(len(kids)) + pre + suf
                        + b"".join(_varint(c) for c in common) + kbytes
                        + b"".join(_varint(0) for _ in kids)
                        + b"".join(_varint(c.offset) for c in kids)
                        + b"".join(_varint(c.length) for c in kids)
                        + b"".join(_varint(c.num_keys) for c in kids)
                        + b"".join(_varint(c.tree_bytes) for c in kids)
                        + b"".join(_varint(c.indirect_bytes) for c in kids))
                sealed = _seal(BTREE_MAGIC, body)
                upper.append(_Child(first, last, append(sealed), len(sealed),
                                    sum(c.num_keys for c in kids),
                                    len(sealed) + sum(c.tree_bytes for c in kids),
                                    sum(c.indirect_bytes for c in kids)))
            level = upper
        f.flush()
        os.fsync(f.fileno())
    root_node = level[0]
    config = (secrets.token_bytes(16) + _varint(0) + _varint(max_inline_value_bytes)
              + _varint(max_decoded_node_bytes) + bytes([DEFAULT_VERSION_TREE_ARITY_LOG2])
              + _varint(1) + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + bytes([height]) + _varint(0) + _varint(root_node.offset)
               + _varint(root_node.length) + _varint(root_node.num_keys)
               + _varint(root_node.tree_bytes) + _varint(root_node.indirect_bytes)
               + struct.pack("<Q", time.time_ns()))
    manifest = _seal(MANIFEST_MAGIC, config + table + version + _varint(0))
    tmp = os.path.join(root, MANIFEST + ".tmp")
    with open(tmp, "wb") as f:
        f.write(manifest)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, MANIFEST))
