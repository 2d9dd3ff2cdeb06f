"""Zstandard (RFC 8878) and CRC-32C without libzstd or the zstandard module.

The codec is C++ (``native/zstd.cpp``), built with g++ at first use into the
package's build/ (see utils/native.py) and called through ctypes; a failed
build raises.  ``decompress`` reads every frame libzstd writes without a
dictionary (several frames in a row and skippable frames included) and
checks the content checksum when a frame carries one; corrupt input raises
ValueError.  ``compress`` writes one frame of raw and RLE blocks with the
content size: spec-valid zstd that libzstd, tensorstore and this decoder
read, though it only shrinks runs of equal bytes.  ``crc32c`` is the
Castagnoli CRC that OCDBT checks its files with.  ctypes releases the GIL
during each call, so threads code arrays in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lib = None
_lock = threading.Lock()     # utils/orbax.py calls the codec from threads


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from .native import BUILD_DIR, build_library
            lib = ctypes.CDLL(build_library("zstd", BUILD_DIR))
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.zstd_content_size.restype = i64
            lib.zstd_content_size.argtypes = [ptr, i64]
            lib.zstd_decompress.restype = i64
            lib.zstd_decompress.argtypes = [ptr, i64, ptr, i64,
                                            ctypes.c_char_p, ctypes.c_int]
            lib.zstd_compress_bound.restype = i64
            lib.zstd_compress_bound.argtypes = [i64]
            lib.zstd_compress.restype = i64
            lib.zstd_compress.argtypes = [ptr, i64, ptr, i64, ctypes.c_int]
            lib.zstd_xxh64.restype = ctypes.c_uint64
            lib.zstd_xxh64.argtypes = [ptr, i64, ctypes.c_uint64]
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c.argtypes = [ptr, i64]
            _lib = lib
    return _lib


def _view(data) -> np.ndarray:
    """A uint8 view of bytes, bytearray, memoryview or a numpy array."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def decompress_array(data) -> np.ndarray:
    """The decompressed bytes of one or more zstd frames as a uint8 array."""
    lib = _load()
    src = _view(data)
    n = src.size
    size = lib.zstd_content_size(src.ctypes.data, n)
    # a frame expands at most ~43690x (a 4-byte RLE block gives 128 KiB)
    if size == -2 or size > (n + 1) * 43691:
        size = -2
    cap = size if size >= 0 else max(1 << 16, 4 * n)
    err = ctypes.create_string_buffer(256)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        got = lib.zstd_decompress(src.ctypes.data, n, out.ctypes.data, cap,
                                  err, len(err))
        if got >= 0:
            return out[:got]
        if got == -1:
            raise ValueError("zstd: " + err.value.decode(errors="replace"))
        if cap > (n + 1) * 43691:
            raise ValueError("zstd: output larger than any frame can give")
        cap *= 2


def decompress(data) -> bytes:
    """zstd frames -> their content (ValueError on corrupt input)."""
    return decompress_array(data).tobytes()


def compress(data, checksum: bool = True) -> bytes:
    """bytes -> one zstd frame of raw and RLE blocks with the content size
    (and the XXH64 checksum unless checksum=False)."""
    return compress_array(data, checksum).tobytes()


def compress_array(data, checksum: bool = True) -> np.ndarray:
    lib = _load()
    src = _view(data)
    cap = lib.zstd_compress_bound(src.size)
    out = np.empty(cap, np.uint8)
    got = lib.zstd_compress(src.ctypes.data, src.size, out.ctypes.data, cap,
                            int(checksum))
    if got < 0:
        raise RuntimeError("zstd: compress bound too small")
    return out[:got]


def xxh64(data, seed: int = 0) -> int:
    src = _view(data)
    return int(_load().zstd_xxh64(src.ctypes.data, src.size, seed))


def crc32c(data) -> int:
    src = _view(data)
    return int(_load().crc32c(src.ctypes.data, src.size))
