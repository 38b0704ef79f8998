"""zstd frames and CRC-32C for the checkpoint formats, in the port's own host
C++ (csrc/zstd.cpp).

Orbax checkpoints hold zstd frames at two levels: the OCDBT store's manifests and
B+tree nodes, and each zarr chunk. `decompress` reads what orbax, tensorstore or
zstd itself wrote (every block, literal and sequence form of RFC 8878, with the
content checksum checked where a frame carries one); `compress_raw` writes
frames of raw blocks with the content size in their header, which every zstd
decoder reads. A truncated or corrupt input raises ValueError.

The library is compiled at first use with the host C++ compiler
(`ops.build.build_host`, -O2 -shared -fPIC) into build/novic_tpu_torch/ and
bound through ctypes (`library`, an `ops.build.Library`), rebuilt where it is
missing or older than its source. Without a compiler, or when the build fails, it raises
with the compiler's output: there is no other implementation.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from novic_tpu_torch.ops import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "zstd.cpp"
_ERRORS = {-2: "corrupt data", -3: "output larger than expected", -4: "truncated input",
           -5: "content checksum mismatch", -6: "frame needs a dictionary",
           -7: "out of memory", -8: "content size differs from the frame header's"}
_U8P, _SIZE, _I64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
library = _build.Library(SOURCE, {
    "novic_zstd_decompress": ([_U8P, _SIZE, _U8P, _SIZE], _I64),
    "novic_zstd_decompress_alloc": ([_U8P, _SIZE, _SIZE, ctypes.POINTER(ctypes.c_void_p)], _I64),
    "novic_zstd_free": ([_U8P], None),
    "novic_zstd_content_size": ([_U8P, _SIZE], _I64),
    "novic_zstd_raw_bound": ([_SIZE], _SIZE),
    "novic_zstd_compress_raw": ([_U8P, _SIZE, _U8P, _SIZE], _I64),
    "novic_crc32c": ([ctypes.c_uint32, _U8P, _SIZE], ctypes.c_uint32)}, host=True)


def _view(data) -> np.ndarray:
    """A uint8 view of a bytes-like object (no copy)."""
    return np.frombuffer(data, dtype=np.uint8)


def _check(code: int, what: str) -> int:
    if code < 0:
        raise ValueError(f"zstd: {_ERRORS.get(code, f'error {code}')} ({what})")
    return code


def content_size(data) -> int | None:
    """The total content size the frames declare; None if one does not."""
    src = _view(data)
    n = library().novic_zstd_content_size(src.ctypes.data, src.size)
    return None if n == -1 else _check(n, "frame headers")


def decompress(data, max_size: int = 1 << 30) -> bytes:
    """Every frame of `data` decoded and concatenated; more than `max_size`
    bytes (declared or decoded) raise ValueError before they are allocated."""
    src = _view(data)
    lib = library()
    size = content_size(src)
    if size is not None and size > max_size:
        raise ValueError(f"zstd: the frames declare {size} bytes, over the {max_size} allowed")
    if size is not None:
        out = bytearray(size)
        got = _check(lib.novic_zstd_decompress(src.ctypes.data, src.size,
                                               _view(out).ctypes.data if size else None, size),
                     f"{src.size} bytes")
        return bytes(out) if got == size else bytes(out[:got])
    ptr = ctypes.c_void_p()
    got = _check(lib.novic_zstd_decompress_alloc(src.ctypes.data, src.size, max_size,
                                                 ctypes.byref(ptr)), f"{src.size} bytes")
    try:
        return ctypes.string_at(ptr.value, got) if got else b""
    finally:
        lib.novic_zstd_free(ptr.value)


def decompress_into(data, out: np.ndarray) -> None:
    """Decode `data` into the C-contiguous array `out`, which it must fill exactly."""
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("decompress_into needs a writeable C-contiguous array")
    src = _view(data)
    got = _check(library().novic_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                                                 out.nbytes), f"{src.size} bytes")
    if got != out.nbytes:
        raise ValueError(f"zstd: decoded {got} bytes where {out.nbytes} were expected")


def compress_raw(data) -> bytes:
    """One zstd frame of raw blocks (at most 128 KiB each) holding `data`, with
    its content size in the header."""
    src = _view(data)
    lib = library()
    out = np.empty(lib.novic_zstd_raw_bound(src.size), np.uint8)
    n = _check(lib.novic_zstd_compress_raw(src.ctypes.data, src.size, out.ctypes.data, out.size),
               "raw frame")
    return out[:n].tobytes()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `crc`."""
    src = _view(data)
    return library().novic_crc32c(crc, src.ctypes.data, src.size)
