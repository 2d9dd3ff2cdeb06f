"""A BLP reader without Pillow (Blizzard's mipmapped textures): the array
``np.asarray(Image.open(path))`` gives for the files Pillow 12.1.0's
BlpImagePlugin reads; "RGBA" [H, W, 4] when the header's alpha field is
not zero, else "RGB" [H, W, 3].

* BLP1, JPEG content: the JPEG header block and the first mipmap (after
  the gap up to its offset) decoded by data/jpeg.py, converted to RGB
  (grey replicated; four components taken as stored and inverted, then
  Pillow's CMYK -> RGB) and set as "BGR": red and blue swap;
* BLP1 palette (encodings 4 and 5): the BGRA palette, then the first
  mipmap's indices read right after it (its offset is not used);
* BLP2 palette (encoding 1): the indices at the first mipmap's offset;
  alpha, at any depth, is the palette entry's;
* BLP2 DXT (encoding 2): alpha encodings 0 (DXT1), 1 (DXT3) and 7 (DXT5)
  through the plugin's own Python decoders, which round otherwise than
  BcnDecode.c (5:6:5 colours shifted, not replicated; DXT3's alpha times
  17), in native/bcndec.cpp's ``blp_dxt``.  Their rows are whole blocks
  wide and are set as the image's rows as they come, so a width that is
  not a multiple of 4 shears the picture, and DXT3 or DXT5 without the
  alpha field reads four bytes a pixel as three: both as Pillow does.

What Pillow refuses (other compressions and encodings, data that ends
early, too few pixels) raises ValueError; a header Image.open passes over
raises imgdec.NotThisFormat.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec
from .dds import blp_dxt


def _pixels(flat: np.ndarray, width: int, height: int,
            channels: int) -> np.ndarray:
    """set_as_raw: the first width * height * channels bytes as the
    image's rows."""
    n = width * height * channels
    if flat.size < n:
        raise ValueError("BLP: not enough image data")
    return flat[:n].reshape((height, width, channels))


def _need(data: bytes, pos: int, n: int) -> bytes:
    """ImageFile._safe_read: n bytes at pos, else the file is truncated."""
    if n <= 0:
        return b""
    if pos + n > len(data):
        raise ValueError("BLP: truncated file read")
    return data[pos:pos + n]


def _palette(data: bytes, pos: int) -> np.ndarray:
    """The 256-entry BGRA palette at pos -> [256, 4] RGBA."""
    return np.frombuffer(_need(data, pos, 1024), np.uint8).reshape(
        256, 4)[:, [2, 1, 0, 3]]


def _indexed(data: bytes, pos: int, length: int, palette: np.ndarray,
             channels: int) -> np.ndarray:
    idx = np.frombuffer(_need(data, pos, length), np.uint8)
    return palette[idx, :channels].reshape(-1)


def _cmyk_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's CMYK -> RGB conversion (cmyk2rgb)."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _jpeg_rgb(stream: bytes) -> np.ndarray:
    """The JPEG as BLP1Decoder converts it to RGB: a four-component stream
    is read as stored (its colour space forced to CMYK), inverted."""
    from .jpeg import COLOUR_NONE, decode_jpeg, decode_jpeg_tables
    img = decode_jpeg(stream)
    imgdec.check_size(img.shape[1], img.shape[0], "BLP1 JPEG")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.shape[2] == 4:
        return _cmyk_rgb(255 - decode_jpeg_tables(b"", stream, COLOUR_NONE))
    return img


def decode_blp(data: bytes) -> np.ndarray:
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise ValueError("not a BLP file")
    if magic == b"BLP1":
        if len(data) < 24:
            raise imgdec.NotThisFormat("BLP1 header truncated")
        compression, alpha, width, height, encoding = struct.unpack_from(
            "<iIIIi", data, 4)
        alpha, start = alpha != 0, 28
    else:
        if len(data) < 20:
            raise imgdec.NotThisFormat("BLP2 header truncated")
        (compression, encoding, alpha, alpha_enc, width,
         height) = struct.unpack_from("<ibbbxII", data, 4)
        alpha, start = alpha != 0, 20
    if width == 0 or height == 0:
        raise imgdec.NotThisFormat("BLP of no pixels")
    imgdec.check_size(width, height, "BLP")
    C = 4 if alpha else 3
    offsets = struct.unpack("<16I", _need(data, start, 64))
    lengths = struct.unpack("<16I", _need(data, start + 64, 64))
    pos = start + 128
    if magic == b"BLP1":
        if compression == 0:
            (hsize,) = struct.unpack("<I", _need(data, pos, 4))
            header = _need(data, pos + 4, hsize)
            pos += 4 + hsize
            _need(data, pos, offsets[0] - pos)
            pos = max(pos, offsets[0])
            rgb = _jpeg_rgb(header + _need(data, pos, lengths[0]))
            img = _pixels(rgb.reshape(-1), width, height, 3)[..., ::-1]
            if alpha:
                img = np.concatenate(
                    [img, np.full((height, width, 1), 255, np.uint8)], -1)
            return np.ascontiguousarray(img)
        if compression != 1 or encoding not in (4, 5):
            raise ValueError(f"BLP1 compression {compression}, encoding "
                             f"{encoding} (Pillow reads none)")
        pal = _palette(data, pos)
        return _pixels(_indexed(data, pos + 1024, lengths[0], pal, C),
                       width, height, C)
    pal = _palette(data, pos)
    if compression != 1:
        raise ValueError(f"BLP2 compression {compression} (Pillow reads "
                         "none)")
    if encoding == 1:
        return _pixels(_indexed(data, offsets[0], lengths[0], pal, C),
                       width, height, C)
    kind = {0: 1, 1: 3, 7: 5}.get(alpha_enc)
    if encoding != 2 or kind is None:
        raise ValueError(f"BLP2 encoding {encoding}, alpha encoding "
                         f"{alpha_enc} (Pillow reads none)")
    bw, bh = (width + 3) // 4, (height + 3) // 4
    bsize = 8 if kind == 1 else 16
    blocks = _need(data, offsets[0], bw * bh * bsize)
    return _pixels(blp_dxt(blocks, kind, alpha, bw, bh), width, height, C)
