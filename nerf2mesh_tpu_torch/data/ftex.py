"""An FTEX reader without Pillow (Independence War 2's .ftc/.ftu textures):
the array ``np.asarray(Image.open(path))`` gives for the files Pillow
12.1.0's FtexImagePlugin reads.

The header (magic, version, width, height, mipmap count, format count:
little-endian int32) and one format entry (format, file offset); at the
offset the first mipmap's byte count and bytes.  Format 0 is DXT1 through
BcnDecode.c's BC1 (data/dds.py's ``bcn``): "RGBA" [H, W, 4]; format 1 is
raw RGB [H, W, 3].  Only the first mipmap is read.  What Pillow refuses
(more than one format, another format, a mipmap shorter than the image, a
negative offset) raises ValueError; a header Image.open passes over (cut
short, no pixels) raises imgdec.NotThisFormat.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec
from .dds import bcn, raw


def decode_ftex(data: bytes) -> np.ndarray:
    if data[:4] != b"FTEX":
        raise ValueError("not an FTEX file")
    if len(data) < 24:
        raise imgdec.NotThisFormat("FTEX header truncated")
    width, height, _, formats = struct.unpack_from("<4i", data, 8)
    if formats != 1:
        raise ValueError(f"FTEX of {formats} formats (Pillow reads one)")
    if len(data) < 32:
        raise imgdec.NotThisFormat("FTEX format entry truncated")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"FTEX data at offset {where}")
    if where + 4 > len(data):
        raise imgdec.NotThisFormat("FTEX mipmap size past the file's end")
    (size,) = struct.unpack_from("<i", data, where)
    mip = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"FTEX texture format {fmt} (Pillow reads 0 and 1)")
    if width <= 0 or height <= 0:
        raise imgdec.NotThisFormat("FTEX of no pixels")
    imgdec.check_size(width, height, "FTEX")
    if fmt == 0:
        return bcn(mip, 0, 1, False, width, height)
    return raw(mip, 0, (height, width, 3))
