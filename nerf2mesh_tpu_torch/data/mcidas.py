"""A McIdas area reader without Pillow: ``np.asarray(Image.open(path))``
of the files Pillow 12.1's McIdasImagePlugin reads.

The 256-byte directory is 64 big-endian int32 words (1-based): word 9 the
lines, word 10 the elements a line, word 11 the bytes a sample (1: mode
"L", uint8; 2: "I;16B", big-endian uint16; 4: "I", int32 from big-endian
words), word 14 the bands, word 15 a line's prefix bytes and word 34 the
data's offset.  The first line starts at word 34 + word 15, and a line
takes word 15 + elements * bytes * bands bytes (the stride).  Another
sample size, a size not above 0 or a directory cut short hands the file
on (Image.open passes over the plugin).

"L" and "I;16B" are Pillow's map modes: when the file holds offset +
lines * stride bytes, Pillow maps the lines at the stride (a stride not
above 0 means the elements' own bytes; lines may overlap, and a stride
shorter than a line reads the mapping's zeros past the file's end for the
last); otherwise, and
for "I", its raw decoder reads them, which refuses a stride shorter than a
line's samples but 0.  A negative offset, a stride the decoder refuses and
lines that end first raise ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec

_MODES = {1: ">u1", 2: ">u2", 4: ">i4"}


def accepts_mcidas(data: bytes) -> bool:
    return data[:8] == b"\0\0\0\0\0\0\0\x04"


def decode_mcidas(data: bytes) -> np.ndarray:
    if len(data) < 256 or not accepts_mcidas(data):
        raise imgdec.NotThisFormat("not an McIdas area file")
    w = (0,) + struct.unpack_from("!64i", data)
    if w[11] not in _MODES:
        raise imgdec.NotThisFormat("unsupported McIdas format")
    nb, W, H = w[11], w[10], w[9]
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("McIdas size not above 0")
    imgdec.check_size(W, H, "McIdas")
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]
    rowbytes = W * nb
    if offset < 0:
        raise ValueError("McIdas: Tile offset cannot be negative")
    buf = data
    if nb < 4 and offset + H * stride <= len(data):
        step = stride if stride > 0 else rowbytes
        if offset + H * step > len(data):
            raise ValueError("McIdas lines cut short (buffer is not large "
                             "enough)")
        buf = data + bytes(max(offset + (H - 1) * step + rowbytes
                               - len(data), 0))
    else:
        if stride and stride < rowbytes:
            raise ValueError("McIdas: a stride shorter than a line's "
                             "samples (Pillow's raw decoder refuses it)")
        step = stride or rowbytes
        if offset + (H - 1) * step + rowbytes > len(data):
            raise ValueError("McIdas lines cut short (image file is "
                             "truncated)")
    rows = np.lib.stride_tricks.as_strided(
        np.frombuffer(buf, np.uint8, offset=offset), (H, rowbytes),
        (step, 1))
    a = np.ascontiguousarray(rows).view(_MODES[nb]).reshape(H, W)
    return a.astype(np.int32) if nb == 4 else (a if nb == 2 else
                                                 a.astype(np.uint8))
