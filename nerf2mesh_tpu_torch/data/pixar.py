"""A PIXAR raster reader without Pillow: ``np.asarray(Image.open(path))``
of the files Pillow 12.1's PixarImagePlugin reads, mode "RGB" (uint8 [H,
W, 3]).

The file starts 0x80 0xE8 0 0; the 512-byte header holds the height at
byte 416 and the width at 418 (little-endian words), and Pillow knows only
the mode words (14, 2) at 424 and 426: RGB, raw rows from byte 1024.  Any
other mode, a size of 0 or a header cut short hands the file on (Image.open
passes over the plugin); rows that end before the last raise ValueError
(Pillow: image file is truncated).
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec


def accepts_pixar(data: bytes) -> bool:
    return data[:4] == b"\x80\xe8\x00\x00"


def decode_pixar(data: bytes) -> np.ndarray:
    if len(data) < 428 or not accepts_pixar(data):
        raise imgdec.NotThisFormat("not a PIXAR file")
    H, W, m0, m1 = struct.unpack_from("<HHHH", data, 416)[:2] + \
        struct.unpack_from("<HH", data, 424)
    if (m0, m1) != (14, 2) or W == 0 or H == 0:
        raise imgdec.NotThisFormat("PIXAR mode other than (14, 2), or size 0")
    imgdec.check_size(W, H, "PIXAR")
    if len(data) < 1024 + W * H * 3:
        raise ValueError("PIXAR data truncated (image file is truncated)")
    return np.frombuffer(data, np.uint8, W * H * 3, 1024).reshape(
        H, W, 3).copy()
