"""A Sun raster (SUN) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's SunImagePlugin reads.

The 32-byte header is eight big-endian words: magic 0x59A66A95, width,
height, depth, length (ignored), type, colour-map type and colour-map
length.  Depth 1 is mode "1" (bool [H, W], a 0 bit True: Pillow's "1;I"),
depth 4 "L" (each nibble times 17) and depth 8 "L"; with a colour map
(type 1, at most 1024 bytes, skipped) depths 4 and 8 are "P", the
indices; with one, depths 1, 24 and 32 raise ValueError (Pillow sets a
palette on a mode that takes none: unrecognized image mode).  Depths 24
and 32 are "RGB" (uint8 [H, W, 3]), stored B, G, R (and a pad byte)
unless the file type is 3, which stores R, G, B.  File
types 0, 1, 3, 4 and 5 hold raw rows padded to 16 bits; type 2 holds
Pillow's "sun_rle" stream (native/imgdec.cpp) of unpadded rows, a run
going on across a row's end.  Another depth, colour-map type or file type,
a map over 1024 bytes, a size of 0 or a header cut short hands the file on
(Image.open passes over the plugin); data that ends before the last row
raises ValueError (Pillow: image file is truncated).
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec

MAGIC = b"\x59\xa6\x6a\x95"


def accepts_sun(data: bytes) -> bool:
    return data[:4] == MAGIC


def unpack_rows(rows: np.ndarray, W: int, depth: int, bgr: bool,
                indexed: bool) -> np.ndarray:
    """[H, >= rowbytes] uint8 rows -> the array of Pillow's mode."""
    if depth == 1:
        return np.ascontiguousarray(np.unpackbits(rows, axis=1)[:, :W] == 0)
    if depth == 4:
        nib = np.stack([rows >> 4, rows & 15], -1).reshape(len(rows), -1)
        nib = nib[:, :W]
        return np.ascontiguousarray(nib if indexed else nib * np.uint8(17))
    if depth == 8:
        return np.ascontiguousarray(rows[:, :W])
    px = rows[:, :W * depth // 8].reshape(len(rows), W, depth // 8)
    return np.ascontiguousarray(px[..., 2::-1] if bgr else px[..., :3])


def decode_sun(data: bytes) -> np.ndarray:
    if len(data) < 32 or not accepts_sun(data):
        raise imgdec.NotThisFormat("not an SUN raster file")
    (_, W, H, depth, _, ftype, ptype, plen) = struct.unpack_from(">8I", data)
    if depth not in (1, 4, 8, 24, 32):
        raise imgdec.NotThisFormat("Unsupported Mode/Bit Depth")
    if plen and plen > 1024:
        raise imgdec.NotThisFormat("Unsupported Color Palette Length")
    if plen and ptype != 1:
        raise imgdec.NotThisFormat("Unsupported Palette Type")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise imgdec.NotThisFormat("Unsupported Sun Raster file type")
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("SUN size of 0")
    imgdec.check_size(W, H, "SUN")
    if plen and depth not in (4, 8):
        raise ValueError(f"SUN colour map on a depth-{depth} image (Pillow: "
                         f"unrecognized image mode)")
    offset = 32 + plen
    rowbytes = (W * depth + 7) // 8
    if ftype == 2:
        rows = imgdec.sun_rle(data[offset:], rowbytes, H)
    else:
        stride = (W * depth + 15) // 16 * 2
        if len(data) < offset + (H - 1) * stride + rowbytes:
            raise ValueError("SUN raster data truncated (image file is "
                             "truncated)")
        rows = np.lib.stride_tricks.as_strided(
            np.frombuffer(data, np.uint8, offset=offset), (H, rowbytes),
            (stride, 1))
    return unpack_rows(rows, W, depth, ftype != 3, plen > 0)
