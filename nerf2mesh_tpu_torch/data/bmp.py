"""A BMP reader without Pillow: the array ``np.asarray(Image.open(path))``
gives, in Pillow's dtype and shape for the mode BmpImagePlugin chooses.

* headers: OS/2 (12 bytes, 16-bit sizes, 3-byte palette entries) and
  Windows v3-v5 (40-124 bytes); rows bottom-up, or top-down when the
  height is negative;
* 1, 4 and 8 bits a pixel through a palette: mode "P", the indices as
  uint8 [H, W]; a palette that is black and white (2 colours) gives mode
  "1", bool [H, W], and one that is the grey ramp 0, 1, 2, ... gives "L",
  the same indices;
* 16 bits: 5-5-5 (and 5-6-5 under BI_BITFIELDS), each field scaled to
  8 bits as v * 255 // (2^bits - 1): RGB uint8 [H, W, 3];
* 24 bits: RGB; 32 bits: RGB without BI_BITFIELDS (the fourth byte
  ignored), and under BI_BITFIELDS the byte masks Pillow lists, RGBA when
  one names an alpha byte (or all four are zero);
* RLE8 and RLE4 as Pillow's BmpRleDecoder reads them (native/imgdec.cpp).

What Pillow refuses (other depths, masks and compressions) raises
ValueError.  ``bitmap`` reads a bitmap from its header on, for the BMP
entries of icons and cursors (data/ico.py) and for a bare DIB (a BMP
without its 14-byte file header: ``decode_dib``, Pillow's DibImageFile).
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec

_HEADERS = (40, 52, 56, 64, 108, 124)
# the 32-bit BI_BITFIELDS masks Pillow reads (r, g, b, a), and its 16-bit ones
_MASKS32 = ((0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
            (0xFF000000, 0xFF00, 0xFF, 0x0),
            (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
            (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
            (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
            (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0))
_MASKS16 = {(0xF800, 0x7E0, 0x1F): (11, 5, 0, 5, 6, 5),
            (0x7C00, 0x3E0, 0x1F): (10, 5, 0, 5, 5, 5)}


def _u16(d, o):
    return struct.unpack_from("<H", d, o)[0]


def _u32(d, o):
    return struct.unpack_from("<I", d, o)[0]


def decode_bmp(data: bytes) -> np.ndarray:
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    return bitmap(data, 14, _u32(data, 10))[0]


# the header sizes DibImageFile's _accept takes (the first 4 bytes)
DIB_HEADERS = (12,) + _HEADERS


def decode_dib(data: bytes) -> np.ndarray:
    """A bare DIB: the bitmap from byte 0, its pixels after its header,
    masks and palette.  Bitfield masks cut short (struct.error in Pillow)
    make Image.open pass the file over: imgdec.NotThisFormat."""
    try:
        return bitmap(data, 0)[0]
    except struct.error as e:
        raise imgdec.NotThisFormat(f"DIB masks truncated ({e})") from e


def bitmap(data: bytes, header: int, offset: int = 0, half: bool = False,
           raw_alpha: bool = False) -> tuple:
    """BmpImageFile._bitmap: the bitmap whose header is at `header`, its
    pixels at `offset` (0: right after the header, masks and palette, as a
    DIB without a file header has them).  `half` reads the first half of
    the bitmap's rows (an icon's XOR image, its AND mask after it);
    `raw_alpha` reads 32 bits without bitfields as RGBA (Pillow's CUR entry
    at file offset 22).  Returns (the array, Pillow's mode, the palette as
    [n, 3] RGB for mode "P" else None, the pixel offset)."""
    hsize = _u32(data, header)
    hdr = data[header + 4:header + hsize]
    if len(hdr) < hsize - 4:
        raise ValueError("BMP header truncated")
    after = header + hsize
    masks = None
    if hsize == 12:
        w, h = _u16(hdr, 0), _u16(hdr, 2)
        bits, comp, colors, pad, top_down = _u16(hdr, 6), 0, 0, 3, False
    elif hsize in _HEADERS:
        top_down = hdr[7] == 0xFF
        w = _u32(hdr, 0)
        h = 2 ** 32 - _u32(hdr, 4) if top_down else _u32(hdr, 4)
        bits, comp, colors = _u16(hdr, 10), _u32(hdr, 12), _u32(hdr, 28)
        pad = 4
        if comp == 3:
            if len(hdr) >= 48:
                masks = tuple(_u32(hdr, 36 + 4 * i) for i in range(3)) + (
                    _u32(hdr, 48) if len(hdr) >= 52 else 0,)
            else:       # a 40-byte header: the three masks follow it
                masks = tuple(_u32(data, after + 4 * i)
                              for i in range(3)) + (0,)
                after += 12
    else:
        raise ValueError(f"BMP header of {hsize} bytes (Pillow reads none)")
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP of {bits} bits a pixel (Pillow reads none)")
    if comp not in (0, 1, 2, 3) or (comp == 3 and bits not in (16, 24, 32)):
        raise ValueError(f"BMP compression {comp} at {bits} bits (Pillow "
                         "reads none)")
    n = h // 2 if half else h
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours")
        pal = data[after:after + pad * colors]
        offset = offset or after + len(pal)
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[i * pad:i * pad + 3] == bytes([v]) * 3
                   for i, v in enumerate(ramp))
        mode = ("1" if colors == 2 else "L") if grey else "P"
        palette = None if grey else np.frombuffer(
            pal[:len(pal) // pad * pad], np.uint8).reshape(-1, pad)[:, 2::-1]
        if comp in (1, 2):
            idx = imgdec.bmp_rle(data, offset, w, w * n, comp == 2)
            if idx.size < w * n:
                raise ValueError("BMP RLE: not enough image data")
            return _orient(idx.reshape(n, w), top_down), mode, palette, offset
        stride = ((w * bits + 31) >> 3) & ~3
        raw = _rows(data, offset, stride, n)
        if mode == "L" and bits != 8:
            # Pillow reads these bytes as 8-bit "L" rows
            if stride < w:
                raise ValueError("BMP: a grey palette below 8 bits wider "
                                 "than its row (Pillow's raw decoder fails)")
            return _orient(raw[:, :w], top_down), mode, palette, offset
        if bits == 8:
            img = raw[:, :w]
        else:
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            img = ((raw[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(
                n, -1)[:, :w]
        img = _orient(img, top_down)
        return (img.astype(bool) if mode == "1" else img), mode, palette, \
            offset
    offset = offset or after
    stride = ((w * bits + 31) >> 3) & ~3
    raw = _rows(data, offset, stride, n)
    if bits == 16:
        if comp == 3 and masks[:3] not in _MASKS16:
            raise ValueError(f"BMP bitfields {masks} (Pillow reads none)")
        rs, gs, bs, rb, gb, bb = _MASKS16[masks[:3] if comp == 3 else
                                          (0x7C00, 0x3E0, 0x1F)]
        p = raw[:, :2 * w].view("<u2").astype(np.uint32)
        img = np.stack([((p >> s) & ((1 << b) - 1)) * 255 // ((1 << b) - 1)
                        for s, b in ((rs, rb), (gs, gb), (bs, bb))], -1)
        return _orient(img.astype(np.uint8), top_down), "RGB", None, offset
    if bits == 24:
        if comp == 3 and masks[:3] != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"BMP bitfields {masks} (Pillow reads none)")
        return (_orient(raw[:, :3 * w].reshape(n, w, 3)[..., ::-1],
                        top_down), "RGB", None, offset)
    px = raw[:, :4 * w].reshape(n, w, 4)
    if comp != 3:
        order = [2, 1, 0, 3] if raw_alpha else [2, 1, 0]
        return (_orient(px[..., order], top_down),
                "RGBA" if raw_alpha else "RGB", None, offset)
    if masks not in _MASKS32:
        raise ValueError(f"BMP bitfields {masks} (Pillow reads none)")
    if masks == (0, 0, 0, 0):
        masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    order = [m.bit_length() // 8 - 1 for m in masks if m]
    return (_orient(px[..., order], top_down),
            "RGBA" if len(order) == 4 else "RGB", None, offset)


def _rows(data: bytes, offset: int, stride: int, n: int) -> np.ndarray:
    raw = np.frombuffer(data, np.uint8, count=min(stride * n,
                                                  len(data) - offset),
                        offset=offset)
    if raw.size < stride * n:
        raise ValueError("BMP: image data truncated")
    return raw.reshape(n, stride)


def _orient(img: np.ndarray, top_down: bool) -> np.ndarray:
    return np.ascontiguousarray(img if top_down else img[::-1])
