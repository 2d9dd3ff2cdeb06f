"""numpy wrappers of native/imgdec.cpp, the inner loops of the BMP, TIFF and
GIF readers (data/bmp.py, data/tiff.py, data/gif.py), built with g++ at
first use (utils/native.py)."""

from __future__ import annotations

import ctypes

import numpy as np

_I64, _PTR, _INT = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lzw_tiff": (_I64, [_PTR, _I64, _PTR, _I64]),
    "lzw_gif": (_I64, [_PTR, _I64, _INT, _PTR, _I64]),
    "packbits": (_I64, [_PTR, _I64, _PTR, _I64]),
    "tiff_unpredict": (None, [_PTR, _I64, _I64, _INT, _INT, _INT]),
    "bmp_rle": (_I64, [_PTR, _I64, _I64, _I64, _I64, _INT, _PTR]),
}


def _lib():
    from ..utils.native import load_library
    return load_library("imgdec", _SIGNATURES)


def _src(data) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(data, np.uint8))


def _checked(n: int, what: str) -> int:
    if n < 0:
        raise ValueError(f"{what}: a code the stream cannot hold")
    return n


def lzw_tiff(data: bytes, size: int) -> np.ndarray:
    """TIFF LZW: at most `size` decoded bytes."""
    src, out = _src(data), np.zeros(size, np.uint8)
    n = _lib().lzw_tiff(src.ctypes.data, src.size, out.ctypes.data, size)
    return out[:_checked(n, "TIFF LZW")]


def lzw_gif(data: bytes, min_bits: int, size: int) -> np.ndarray:
    """GIF LZW of `min_bits`-bit roots: at most `size` decoded indices."""
    src, out = _src(data), np.zeros(size, np.uint8)
    n = _lib().lzw_gif(src.ctypes.data, src.size, min_bits, out.ctypes.data,
                       size)
    return out[:_checked(n, "GIF LZW")]


def packbits(data: bytes, size: int) -> np.ndarray:
    src, out = _src(data), np.zeros(size, np.uint8)
    n = _lib().packbits(src.ctypes.data, src.size, out.ctypes.data, size)
    return out[:n]


def unpredict(buf: np.ndarray, rows: int, cols: int, spp: int, nbytes: int,
              big_endian: bool) -> None:
    """Undo TIFF predictor 2 in the uint8 array `buf`, in place."""
    if not (buf.flags.c_contiguous and buf.dtype == np.uint8
            and buf.size >= rows * cols * spp * nbytes):
        raise ValueError("unpredict takes a contiguous uint8 buffer of "
                         "rows * cols * spp * nbytes bytes")
    _lib().tiff_unpredict(buf.ctypes.data, rows, cols, spp, nbytes,
                          int(big_endian))


def bmp_rle(data: bytes, pos: int, width: int, count: int,
            rle4: bool) -> np.ndarray:
    """Pillow's RLE8/RLE4 reading of `data` (the whole file) from `pos`: at
    most `count` pixel indices."""
    src, out = _src(data), np.zeros(count, np.uint8)
    n = _lib().bmp_rle(src.ctypes.data, src.size, pos, width, count,
                       int(rle4), out.ctypes.data)
    return out[:n]
