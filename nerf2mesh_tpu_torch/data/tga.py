"""A TGA (Truevision Targa) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow's TgaImagePlugin reads.

* uncompressed (image types 1, 2, 3) and run-length encoded (9, 10, 11):
  a literal packet may go on across rows, a run may not (Pillow's decoder
  calls that an overrun) (native/imgdec.cpp);
* colour-mapped 8-bit -> mode "P", the indices, uint8 [H, W] (the
  colour map, of 16 or 24 bits, is skipped; Pillow reads no 32-bit map);
* grey 8-bit -> "L" [H, W]; grey + alpha 16-bit -> "LA" [H, W, 2]; 1-bit
  -> "1", bool [H, W] (uncompressed only);
* true colour 24-bit BGR -> "RGB"; 32-bit BGRA -> "RGBA"; 16-bit
  A1R5G5B5 -> "RGBA" as Pillow's "BGRA;15Z" unpacks it: each 5-bit
  channel v as v * 255 // 31, alpha 255 where the top bit is clear and 0
  where it is set;
* both origin bits: rows bottom to top unless bit 5 of the descriptor is
  set, and columns mirrored where bit 4 is.

TGA has no signature.  Pillow's TgaImagePlugin registers no _accept, and
Image.open tries it after every plugin whose _accept takes the file (PNG,
JPEG, BMP, GIF, netpbm, QOI, ...) and only TIFF, WebP and a few text
formats come later; data/png.read_image tries it likewise, after every
signature it knows, and takes the file when its header passes the checks
of TgaImageFile._open: colour map type 0 or 1, a nonzero size, a depth of
1, 8, 16, 24 or 32 bits and an image type of 1-3 or 9-11.  The rest raise
ValueError, as Pillow refuses them.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec

# (image type & 7, depth) -> Pillow's mode
_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
          (2, 16): "RGBA", (2, 24): "RGB", (2, 32): "RGBA"}


# Pillow's "BGRA;15Z": A1R5G5B5 (little-endian) -> R, G, B, A
_V = np.arange(65536)
_LUT15 = np.stack([((_V >> 10) & 31) * 255 // 31, ((_V >> 5) & 31) * 255 // 31,
                   (_V & 31) * 255 // 31, np.where(_V & 0x8000, 0, 255)],
                  -1).astype(np.uint8)
del _V


def _header(data: bytes):
    """(id length, colour map type, image type, width, height, depth,
    descriptor) when TgaImageFile._open would take the header, else None."""
    if len(data) < 18:
        return None
    id_len, cmap, itype = data[0], data[1], data[2]
    W, H, depth, flags = struct.unpack_from("<HHBB", data, 12)
    if (cmap in (0, 1) and W > 0 and H > 0 and depth in (1, 8, 16, 24, 32)
            and itype in (1, 2, 3, 9, 10, 11)):
        return id_len, cmap, itype, W, H, depth, flags
    return None


def is_tga(data: bytes) -> bool:
    """Whether TgaImageFile._open would take the header."""
    return _header(data) is not None


def decode_tga(data: bytes) -> np.ndarray:
    head = _header(data)
    if head is None:
        raise ValueError("not a TGA file Pillow reads")
    id_len, cmap, itype, W, H, depth, flags = head
    imgdec.check_size(W, H, "TGA")
    pos = 18 + id_len
    if cmap:
        size, mapdepth = struct.unpack_from("<HB", data, 5)
        if mapdepth not in (16, 24):
            raise ValueError(f"TGA colour map of {mapdepth}-bit entries "
                             "(Pillow reads none)")
        pos += size * mapdepth // 8
    key = (itype & 7, depth)
    if key not in _MODES or (itype & 7 == 1 and not cmap):
        raise ValueError(f"TGA image type {itype} of {depth} bits (Pillow "
                         "reads none)")
    if itype & 8 and depth == 1:
        raise ValueError("run-length encoded 1-bit TGA (Pillow reads none)")
    if depth == 1:
        stride = (W + 7) // 8
        if len(data) < pos + stride * H:
            raise ValueError("TGA data too short")
        raw = np.frombuffer(data, np.uint8, stride * H, pos)
        img = np.unpackbits(raw.reshape(H, stride), axis=1)[:, :W] == 1
    else:
        nb = depth // 8
        count = W * H * nb
        if itype & 8:
            if count > 128 * nb * (len(data) - pos):   # runs of 128 at most
                raise ValueError("TGA data too short")
            flat = imgdec.tga_rle(data[pos:], nb, W * nb, count)
            if flat.size < count:
                raise ValueError("TGA data too short")
        elif len(data) < pos + count:
            raise ValueError("TGA data too short")
        else:
            flat = np.frombuffer(data, np.uint8, count, pos)
        px = flat.reshape(H, W, nb)
        if depth == 16 and key[0] == 2:
            img = _LUT15[px.view("<u2")[..., 0]]
        elif nb == 1:
            img = px[..., 0]
        elif key[0] == 2:                    # BGR(A) -> RGB(A)
            img = px[..., (2, 1, 0, 3)[:nb]]
        else:                                # LA
            img = px
    # rows bottom to top unless bit 5 is set; columns mirrored by bit 4
    img = img[::1 if flags & 0x20 else -1, ::-1 if flags & 0x10 else 1]
    return np.ascontiguousarray(img)
