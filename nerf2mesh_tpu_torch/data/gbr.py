"""A GIMP brush (GBR) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's GbrImagePlugin reads.

The header is big-endian words: its size (at least 20), the version (1 or
2), width, height and bytes a pixel (1: mode "L", uint8 [H, W]; 4: "RGBA",
[H, W, 4]); version 2 then has the magic "GIMP" and the spacing.  The
pixels follow the header (a comment fills the rest of it).  Another
version or depth, a size of 0, a version-2 file without the magic or a
header cut short hands the file on (Image.open passes over the plugin);
pixels that end first raise ValueError (Pillow: not enough image data), as
does a version-2 header shorter than 28 bytes, whose comment Pillow reads
to the file's end.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec


def accepts_gbr(data: bytes) -> bool:
    return len(data) >= 8 and struct.unpack_from(">I", data)[0] >= 20 and \
        struct.unpack_from(">I", data, 4)[0] in (1, 2)


def decode_gbr(data: bytes) -> np.ndarray:
    if len(data) < 20:
        raise imgdec.NotThisFormat("GIMP brush header cut short")
    size, version, W, H, depth = struct.unpack_from(">5I", data)
    if size < 20 or version not in (1, 2) or W == 0 or H == 0 or \
            depth not in (1, 4):
        raise imgdec.NotThisFormat("not a GIMP brush")
    if version == 2:
        if len(data) < 28:
            raise imgdec.NotThisFormat("GIMP brush header cut short")
        if data[20:24] != b"GIMP":
            raise imgdec.NotThisFormat("not a GIMP brush, bad magic number")
    imgdec.check_size(W, H, "GIMP brush")
    need = W * H * depth
    body = data[size:size + need] if size >= (20 if version == 1 else 28) \
        else b""
    if len(body) < need:
        raise ValueError("GIMP brush pixels cut short (not enough image "
                         "data)")
    a = np.frombuffer(body, np.uint8).reshape((H, W) if depth == 1
                                              else (H, W, 4))
    return a.copy()
