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

``read_image`` reads a file without Pillow, trying the port's readers in
the order Image.open tries Pillow's plugins (``legacy_readers``): a PNG
with this codec, a JPEG with data/jpeg.py's decoder, and BMP, TIFF, GIF,
WebP, netpbm, QOI, JPEG 2000, BLP, DIB, CUR, PCX, DCX, DDS, FITS, FLI,
FTEX, GBR, ICNS, ICO, IM, IMT, IPTC, McIdas, MSP, PCD, PIXAR, PSD, SGI,
SPIDER, SUN, TGA, XBM, XPM and XV thumbnails with their modules under
data/; a plugin whose _accept takes the file but whose _open gives up
hands it on to the next, so IM, IMT, IPTC, PCD and SPIDER, which have no
signature, and TGA, whose header test is loose, read only what no earlier
plugin takes; BUFR, GRIB, HDF5, EPS, MPEG, WMF/EMF and OLE compound files
raise ValueError as Pillow cannot load them here (data/unloadable.py), and
so does a file no reader takes (Pillow: UnidentifiedImageError); AVIF
alone raises NotImplementedError (ROADMAP A6 (j) 10).  ``decode_image`` is
the same on bytes (IPTC reads its payload through it);
``write_image`` uses Pillow where it is importable (its files are the JAX
package's, byte for byte) and this codec otherwise.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from . import imgdec

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
    return decode_png(read_bytes(path))


def write_png(path: str, img: np.ndarray) -> None:
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def read_bytes(path: str) -> bytes:
    """A file's bytes in four system calls (open, fstat, one read of the
    file's size, close), each a round trip on a network file system."""
    fd = os.open(path, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        data = os.read(fd, size) if size else b""
        if len(data) < size or not size:     # a short read, or no size
            chunks = [data]
            while more := os.read(fd, 1 << 20):
                chunks.append(more)
            data = b"".join(chunks)
    finally:
        os.close(fd)
    return data


def read_image(path: str) -> np.ndarray:
    """np.asarray(Image.open(path)) of any image Pillow reads here but AVIF
    (ROADMAP A6 (j) 10), without Pillow; ValueError for what Pillow refuses
    or does not identify."""
    return decode_image(read_bytes(path), path)


def decode_image(data: bytes, name: str = "image") -> np.ndarray:
    """read_image on a file's bytes (`name` for the message)."""
    if not _BY_FIRST:
        _readers()
    for reader, accepts, read in _BY_FIRST[data[0] if data else 256]:
        if not accepts(data):
            continue
        try:
            return read(data)
        except imgdec.NotThisFormat:
            continue
        except (struct.error, IndexError) as e:
            if reader == "ICO":              # ICO decodes inside its _open
                continue
            raise ValueError(f"corrupt image ({type(e).__name__}: {e})") \
                from e
    from . import unloadable
    if data[:8] == unloadable.OLE_MAGIC:
        unloadable.refuse_ole(data)
    raise ValueError(f"{name}: no reader takes this file, as no Pillow "
                     f"plugin does (cannot identify image file); it starts "
                     f"{data[:12]!r}")


_READERS: tuple = ()
_BY_FIRST: list = []


def _readers() -> tuple:
    """Builds, once, the table of ``legacy_readers``: (name, the first
    bytes its _accept can take, or None for any, its _accept, its reader),
    and the entries that can take each first byte (the last for b"")."""
    global _READERS, _BY_FIRST
    from . import (blp, bmp, dds, fits, fli, ftex, gbr, gif, icns, ico, im,
                   imt, iptc, jpeg, jpeg2000, mcidas, msp, netpbm, pcd, pcx,
                   pixar, psd, qoi, sgi, spider, sun, tga, tiff,
                   unloadable as un, webp, xbm, xpm, xvthumb)
    dib = bmp.DIB_HEADERS

    def avif(data):
        raise NotImplementedError("AVIF images are not read yet (ROADMAP A6 "
                                  "(j) 10: the AV1 tables are not here)")

    _READERS = (
        ("BMP", b"B", lambda d: d[:2] == b"BM", bmp.decode_bmp),
        ("DIB", bytes(dib), lambda d: len(d) >= 4 and struct.unpack_from(
            "<I", d)[0] in dib, bmp.decode_dib),
        ("GIF", b"G", lambda d: d[:6] in (b"GIF87a", b"GIF89a"),
         gif.decode_gif),
        ("JPEG", b"\xff", lambda d: d[:2] == b"\xff\xd8", jpeg.decode_jpeg),
        ("PPM", b"P", lambda d: d[:1] == b"P" and d[1:2] in b"0123456fy"
         and len(d) > 1, netpbm.decode_netpbm),
        ("PNG", b"\x89", lambda d: d[:8] == _SIGNATURE, decode_png),
        ("AVIF", None, lambda d: d[4:8] == b"ftyp" and d[8:12] in (
            b"avif", b"avis", b"mif1", b"msf1"), avif),
        ("BLP", b"B", lambda d: d[:4] in (b"BLP1", b"BLP2"), blp.decode_blp),
        ("BUFR", b"BZ", un.accepts_bufr, un.refuse_bufr),
        ("CUR", b"\0", lambda d: d[:4] == b"\0\0\2\0", ico.decode_cur),
        ("PCX", b"\x0a", pcx.accepts_pcx, pcx.decode_pcx),
        ("DCX", b"\xb1", lambda d: d[:4] == b"\xb1\x68\xde\x3a",
         pcx.decode_dcx),
        ("DDS", b"D", lambda d: d[:4] == b"DDS ", dds.decode_dds),
        ("EPS", b"%\xc5", un.accepts_eps, un.refuse_eps),
        ("FITS", b"S", fits.accepts_fits, fits.decode_fits),
        ("FLI", None, fli.accepts_fli, fli.decode_fli),
        ("FTEX", b"F", lambda d: d[:4] == b"FTEX", ftex.decode_ftex),
        ("GBR", None, gbr.accepts_gbr, gbr.decode_gbr),
        ("GRIB", b"G", un.accepts_grib, un.refuse_grib),
        ("HDF5", b"\x89", un.accepts_hdf5, un.refuse_hdf5),
        ("JPEG2000", b"\xff\0", lambda d: d[:4] == jpeg2000.J2K_SIGNATURE or
         d[:12] == jpeg2000.JP2_SIGNATURE, jpeg2000.decode_jpeg2000),
        ("ICNS", b"i", icns.accepts_icns, icns.decode_icns),
        ("ICO", b"\0", lambda d: d[:4] == b"\0\0\1\0", ico.decode_ico),
        ("IM", None, lambda d: True, im.decode_im),
        ("IMT", None, lambda d: True, imt.decode_imt),
        ("IPTC", None, lambda d: True, iptc.decode_iptc),
        ("MCIDAS", b"\0", mcidas.accepts_mcidas, mcidas.decode_mcidas),
        ("MPEG", b"\0", un.accepts_mpeg, un.refuse_mpeg),
        ("TIFF", b"IM", lambda d: d[:4] in (b"II*\0", b"MM\0*", b"II+\0",
                                            b"MM\0+"), tiff.decode_tiff),
        ("MSP", b"DL", msp.accepts_msp, msp.decode_msp),
        ("PCD", None, lambda d: True, pcd.decode_pcd),
        ("PIXAR", b"\x80", pixar.accepts_pixar, pixar.decode_pixar),
        ("PSD", b"8", lambda d: d[:4] == b"8BPS", psd.decode_psd),
        ("QOI", b"q", lambda d: d[:4] == b"qoif", qoi.decode_qoi),
        ("SGI", b"\x01", lambda d: d[:2] == b"\x01\xda", sgi.decode_sgi),
        ("SPIDER", None, lambda d: True, spider.decode_spider),
        ("SUN", b"\x59", sun.accepts_sun, sun.decode_sun),
        ("TGA", None, tga.is_tga, tga.decode_tga),
        ("WEBP", b"R", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP",
         webp.decode_webp),
        ("WMF", b"\xd7\x01", un.accepts_wmf, un.refuse_wmf),
        ("XBM", b" \t\n\r\x0b\x0c#", xbm.accepts_xbm, xbm.decode_xbm),
        ("XPM", b"/", xpm.accepts_xpm, xpm.decode_xpm),
        ("XVTHUMB", b"P", xvthumb.accepts_xvthumb, xvthumb.decode_xvthumb),
    )
    _BY_FIRST = [tuple((n, a, r) for n, first, a, r in _READERS
                       if first is None or (b < 256 and b in first))
                 for b in range(257)]
    return _READERS


def legacy_readers(data: bytes) -> tuple:
    """(Pillow's format name, whether its _accept takes `data`, the port's
    reader) of every format ``read_image`` tries, in the order Image.open
    tries their plugins: preinit's BMP, DIB, GIF, JPEG, PPM and PNG, then
    Image.OPEN's (IM, IMT, IPTC, PCD and SPIDER have no _accept, TGA's is
    the port's header test).  A reader raises imgdec.NotThisFormat where Pillow's _open fails
    in a way Image.open passes over, and the next is tried."""
    return tuple((name, accepts(data), read)
                 for name, _, accepts, read in _READERS or _readers())


def write_image(path: str, img: np.ndarray) -> None:
    """Image.fromarray(img).save(path) with Pillow, else the PNG codec."""
    try:
        from PIL import Image
    except ImportError:
        write_png(path, img)
        return
    Image.fromarray(np.asarray(img)).save(path)
