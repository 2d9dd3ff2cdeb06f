"""numpy wrappers of native/imgdec.cpp, the inner loops of the BMP, TIFF,
GIF, netpbm, TGA, QOI, SGI, PCX, PSD, ICNS, SUN and FLI readers
(data/bmp.py, tiff.py, gif.py, netpbm.py, tga.py, qoi.py, sgi.py, pcx.py,
psd.py, icns.py, sun.py, fli.py), built with g++ at first use
(utils/native.py)."""

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
    "fax_decode": (_I64, [_PTR, _I64, _INT, _I64, _I64, _I64, _PTR]),
    "thunder_decode": (_I64, [_PTR, _I64, _I64, _I64, _I64, _PTR]),
    "sgi_rle": (_I64, [_PTR, _I64, _I64, _I64, _INT, _INT, _PTR]),
    "pcx_rle": (_I64, [_PTR, _I64, _I64, _I64, _PTR]),
    "packbits_rows": (_I64, [_PTR, _I64, _I64, _I64, _PTR]),
    "icns_rle": (_I64, [_PTR, _I64, _I64, _I64, _PTR]),
    "sun_rle": (_I64, [_PTR, _I64, _I64, _PTR]),
    "fli_frame": (_I64, [_PTR, _I64, _I64, _I64, _PTR]),
}


class NotThisFormat(ValueError):
    """A header whose plugin's _open fails in a way Image.open passes over
    (SyntaxError, IndexError, TypeError, struct.error): Pillow tries the
    next plugin, and data/png.read_image the next reader."""


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


# fax_decode's modes
FAX_MH, FAX_MH_WORD, FAX_G3_1D, FAX_G3_2D, FAX_G4 = range(5)


def fax(data, mode: int, width: int, rows: int) -> np.ndarray:
    """A strip or tile of CCITT data (fill order 1) -> [rows, ceil(width /
    8)] packed rows, black runs as 1 bits.  A Group 4 strip that ends
    early keeps the rows it decoded, as libtiff does, and the rest are
    white (Pillow leaves them as whatever its buffer held); ValueError
    where libtiff's decoder fails the strip."""
    rowbytes = (width + 7) // 8
    src, out = _src(data), np.zeros(rows * rowbytes, np.uint8)
    n = _lib().fax_decode(src.ctypes.data, src.size, mode, width, rows,
                          rowbytes, out.ctypes.data)
    if n < 0:
        raise ValueError("TIFF CCITT data libtiff fails to decode")
    return out.reshape(rows, rowbytes)


def thunderscan(data, width: int, rows: int) -> np.ndarray:
    """ThunderScan 4-bit rows -> [rows, ceil(width / 2)] packed samples."""
    rowbytes = (width + 1) // 2
    src, out = _src(data), np.zeros(rows * rowbytes, np.uint8)
    if _lib().thunder_decode(src.ctypes.data, src.size, width, rows,
                             rowbytes, out.ctypes.data) < 0:
        raise ValueError("ThunderScan TIFF: a row of too few or too many "
                         "pixels (libtiff fails the strip)")
    return out.reshape(rows, rowbytes)


def sgi_rle(data, xsize: int, ysize: int, bands: int, bpc: int
            ) -> tuple:
    """SGI RLE (`data` the file from byte 512 on) -> ([ysize, xsize, bands *
    bpc] rows in file order, the rows stored).  A run past its row or the
    data raises ValueError, as Pillow's decoder refuses it."""
    src = _src(data)
    out = np.zeros(ysize * xsize * bands * bpc, np.uint8)
    n = _lib().sgi_rle(src.ctypes.data, src.size, xsize, ysize, bands, bpc,
                       out.ctypes.data)
    if n < 0:
        raise ValueError("SGI RLE: a run past its row or the data (Pillow "
                         "reads none)")
    return out.reshape(ysize, xsize, bands * bpc), n


def pcx_rle(data, line: int, rows: int) -> np.ndarray:
    """PCX RLE -> [rows, line] bytes; ValueError on a run past a line or
    data that ends first, as Pillow refuses both."""
    src, out = _src(data), np.zeros(rows * line, np.uint8)
    n = _lib().pcx_rle(src.ctypes.data, src.size, line, rows,
                       out.ctypes.data)
    if n < 0:
        raise ValueError("PCX: a run past the end of a line (Pillow reads "
                         "none)")
    if n < rows:
        raise ValueError("PCX: image data truncated")
    return out.reshape(rows, line)


def packbits_rows(data, rowbytes: int, rows: int) -> tuple:
    """Pillow's PackBits decoder from the start of `data`: ([rows, rowbytes]
    bytes, the bytes read).  A packet that passes a row's end is cut there,
    unlike ``packbits``'s single stream; ValueError when the data ends
    before the rows are full (Pillow: image file is truncated)."""
    src, out = _src(data), np.zeros(rows * rowbytes, np.uint8)
    n = _lib().packbits_rows(src.ctypes.data, src.size, rowbytes, rows,
                             out.ctypes.data)
    if n < 0:
        raise ValueError("PackBits data truncated (image file is truncated)")
    return out.reshape(rows, rowbytes), n


def icns_rle(data, pos: int, count: int) -> np.ndarray:
    """An ICNS 24-bit entry's RLE from `pos` of `data` (the whole file) ->
    [3, count] bands; ValueError where Pillow's read_32 fails (a band's
    packets that do not sum to `count`, or the file ending inside one)."""
    src, out = _src(data), np.zeros(3 * count, np.uint8)
    if _lib().icns_rle(src.ctypes.data, src.size, pos, count,
                       out.ctypes.data) < 0:
        raise ValueError("ICNS RLE: a band that does not decode to its "
                         "size (Pillow: Error reading channel)")
    return out.reshape(3, count)


def sun_rle(data, rowbytes: int, rows: int) -> np.ndarray:
    """Sun raster RLE from the start of `data` -> [rows, rowbytes] bytes (a
    run goes on across rows); ValueError when the data ends first (Pillow:
    image file is truncated)."""
    src, out = _src(data), np.zeros(rows * rowbytes, np.uint8)
    if _lib().sun_rle(src.ctypes.data, src.size, out.size,
                      out.ctypes.data) < 0:
        raise ValueError("SUN RLE data truncated (image file is truncated)")
    return out.reshape(rows, rowbytes)


# fli_frame's failures, as Pillow names them
FLI_ERRORS = {-2: "buffer overrun when reading image file",
              -3: "unrecognized data stream contents when reading image "
                  "file", -4: "broken data stream when reading image file"}


def fli_frame(data, out: np.ndarray) -> int:
    """Applies the FLI frame at the start of `data` to `out` (uint8 [H, W],
    C-contiguous): -1 when done, else the bytes consumed before it needs
    more data; ValueError on the errors Pillow's decoder reports."""
    if not (out.flags.c_contiguous and out.dtype == np.uint8
            and out.ndim == 2):
        raise ValueError("fli_frame takes a contiguous uint8 [H, W] array")
    src = _src(data)
    r = _lib().fli_frame(src.ctypes.data, src.size, out.shape[1],
                         out.shape[0], out.ctypes.data)
    if r < -1:
        raise ValueError(f"FLI: {FLI_ERRORS[r]}")
    return r
