"""A PNG codec (zlib + numpy, rows unfiltered in C++) without Pillow.

Reads every PNG that Pillow reads, into the array ``np.asarray(Image.open(
path))`` gives, in Pillow's dtype and shape for the file's mode
(PngImagePlugin's ``_MODES``):

* grey: 1-bit -> mode "1", bool [H, W]; 2- and 4-bit -> "L", the sample
  times 85 or 17; 8-bit -> uint8 [H, W]; 16-bit -> "I;16", uint16 [H, W];
* RGB and RGBA: uint8 [H, W, 3|4]; 16-bit samples -> their high byte;
* grey + alpha: 8-bit -> "LA", uint8 [H, W, 2]; 16-bit -> "RGBA" (Pillow
  reads "LA;16B" as RGBA), the grey's high byte thrice and the alpha's;
* palette, 1-8 bits -> "P": the indices, uint8 [H, W] (a tRNS chunk does
  not change the array, in any mode);
* Adam7-interlaced files of any of these.

The five row filters are undone by ``native/pngdec.cpp`` (built with g++
at first use, see utils/native.py): Paeth and Average depend on each
row's own output byte by byte.  Writing uses filter 0 on every row, for
[H, W] and [H, W, 3|4] uint8 images: every image the package writes.

``read_image`` reads a file by its signature, never through Pillow: a
PNG with this codec, a JPEG with data/jpeg.py's decoder, and BMP, TIFF,
GIF, WebP, netpbm, QOI and JPEG 2000 (JP2 files and raw codestreams) with
data/bmp.py, tiff.py, gif.py, webp.py, netpbm.py, qoi.py and jpeg2000.py;
a file with none of those signatures whose header
Pillow's TGA plugin would take is read by data/tga.py (TGA has no
signature, and Pillow tries it late); any other format raises
NotImplementedError naming ROADMAP A6 (j);
``write_image`` uses Pillow where it is importable (its files are the JAX
package's, byte for byte) and this codec otherwise.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}       # PNG color type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
# Adam7: (x start, y start, x step, y step) of the 7 passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r}: truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


_lib = None


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int
              ) -> np.ndarray:
    global _lib
    if _lib is None:
        from ..utils.native import BUILD_DIR, build_library
        lib = ctypes.CDLL(build_library("pngdec", BUILD_DIR))
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_void_p]
        _lib = lib
    if raw.size < rows * (stride + 1):
        raise ValueError("PNG image data too short")
    raw = np.ascontiguousarray(raw[:rows * (stride + 1)])
    out = np.empty(rows * stride, np.uint8)
    bad = _lib.png_unfilter(raw.ctypes.data, rows, stride, bpp,
                            out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type")
    return out.reshape(rows, stride)


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered rows -> [h, w, ch] samples (uint8, or uint16 at 16)."""
    h = rows.shape[0]
    if depth == 16:
        b = rows[:, :2 * w * ch].reshape(h, w, ch, 2).astype(np.uint16)
        return (b[..., 0] << 8) | b[..., 1]         # big-endian samples
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    per = 8 // depth                     # samples a byte, first in the MSBs
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w].reshape(h, w, 1)


def decode_png(data: bytes) -> np.ndarray:
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG with bit depth {depth} and color type "
                         f"{ctype} (not a combination the standard allows)")
    if comp or filt or interlace > 1 or not W or not H:
        raise ValueError("PNG with an unknown compression, filter method or "
                         "interlace method, or no pixels")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.empty((H, W, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        w, h = (W - x0 + dx - 1) // dx, (H - y0 + dy - 1) // dy
        if w <= 0 or h <= 0:
            continue
        stride = (w * ch * depth + 7) // 8
        rows = _unfilter(raw[pos:], h, stride, bpp)
        pos += h * (stride + 1)
        img[y0::dy, x0::dx] = _samples(rows, w, depth, ch)
    return _pillow_mode(img, depth, ctype)


def _pillow_mode(img: np.ndarray, depth: int, ctype: int) -> np.ndarray:
    """Samples -> the array of Pillow's mode for (depth, color type)."""
    if ctype in (0, 3):
        g = img[..., 0]
        if ctype == 3 or depth in (8, 16):
            return g
        if depth == 1:
            return g.astype(bool)
        return (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:               # "LA;16B" is read as RGBA
            img = img[..., [0, 0, 0, 1]]
    return np.ascontiguousarray(img)


def encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(
            f"PNG writer takes [H, W] or [H, W, 3|4] images, not {img.shape}")
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(H, W * C)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def read_image(path: str) -> np.ndarray:
    """np.asarray(Image.open(path)) for a PNG, JPEG, BMP, TIFF, GIF, WebP,
    netpbm, QOI, JPEG 2000 or TGA file, without Pillow.  Other formats
    raise NotImplementedError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        from .jpeg import decode_jpeg
        return decode_jpeg(data)
    if data[:8] == _SIGNATURE:
        return decode_png(data)
    if data[:2] == b"BM":
        from .bmp import decode_bmp
        return decode_bmp(data)
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        from .tiff import decode_tiff
        return decode_tiff(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        from .gif import decode_gif
        return decode_gif(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        from .webp import decode_webp
        return decode_webp(data)
    if data[:1] == b"P" and data[1:2] in (b"0", b"1", b"2", b"3", b"4",
                                          b"5", b"6", b"7", b"f", b"y"):
        from .netpbm import decode_netpbm
        return decode_netpbm(data)
    if data[:4] == b"qoif":
        from .qoi import decode_qoi
        return decode_qoi(data)
    if data[:4] == b"\xff\x4f\xff\x51" or data[:12] == (
            b"\x00\x00\x00\x0cjP  \r\n\x87\n"):
        from .jpeg2000 import decode_jpeg2000
        return decode_jpeg2000(data)
    from . import tga
    if tga.is_tga(data):                 # no signature: tried last
        return tga.decode_tga(data)
    raise NotImplementedError(
        f"{path}: only PNG, JPEG, BMP, TIFF, GIF, WebP, netpbm, QOI, JPEG "
        f"2000 and TGA images are read (ROADMAP A6 (j)); the file starts "
        f"{data[:12]!r}")


def write_image(path: str, img: np.ndarray) -> None:
    """Image.fromarray(img).save(path) with Pillow, else the PNG codec."""
    try:
        from PIL import Image
    except ImportError:
        write_png(path, img)
        return
    Image.fromarray(np.asarray(img)).save(path)
