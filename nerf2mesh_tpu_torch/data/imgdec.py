"""numpy wrappers of native/imgdec.cpp, the inner loops of the BMP, TIFF,
GIF, netpbm, TGA and QOI readers (data/bmp.py, tiff.py, gif.py, netpbm.py,
tga.py, qoi.py), built with g++ at first use (utils/native.py)."""

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
    "netpbm_plain": (_I64, [_PTR, _I64, _INT, _PTR, _I64]),
    "tga_rle": (_I64, [_PTR, _I64, _INT, _I64, _PTR, _I64]),
    "qoi_decode": (_I64, [_PTR, _I64, _INT, _PTR, _I64]),
}


# Image.open's DecompressionBombError: more pixels than twice Pillow's
# MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * 89478485


def check_size(W: int, H: int, what: str) -> None:
    """ValueError for a size Pillow refuses to open."""
    if W * H > MAX_PIXELS:
        raise ValueError(f"{what} of {W}x{H} pixels: more than Pillow opens "
                         f"({MAX_PIXELS})")


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


def netpbm_plain(data: bytes, count: int, bitonal: bool) -> np.ndarray:
    """The first `count` samples (int32) of a plain netpbm body; fewer when
    the data ends first.  Raises ValueError on a token Pillow refuses."""
    count = min(count, len(data))            # a sample takes a byte or more
    src, out = _src(data), np.zeros(count, np.int32)
    n = _lib().netpbm_plain(src.ctypes.data, src.size, int(bitonal),
                            out.ctypes.data, count)
    if n < 0:
        raise ValueError("plain netpbm: a token that is not a sample")
    return out[:n]


def tga_rle(data: bytes, depth: int, row_bytes: int,
            count: int) -> np.ndarray:
    """TGA RLE packets of `depth`-byte pixels in rows of `row_bytes`: at
    most `count` bytes.  A run across a row's end raises ValueError, as
    Pillow's decoder refuses it."""
    src, out = _src(data), np.zeros(count, np.uint8)
    n = _lib().tga_rle(src.ctypes.data, src.size, depth, row_bytes,
                       out.ctypes.data, count)
    if n < 0:
        raise ValueError("TGA run across the end of a row (Pillow reads "
                         "none)")
    return out[:n]


def qoi_decode(data: bytes, channels: int, pixels: int) -> np.ndarray:
    """`pixels` QOI pixels of `channels` (3 or 4) bytes; none when the data
    ends first."""
    src, out = _src(data), np.zeros(pixels * channels, np.uint8)
    n = _lib().qoi_decode(src.ctypes.data, src.size, channels,
                          out.ctypes.data, pixels)
    return out[:max(n, 0) * channels]
