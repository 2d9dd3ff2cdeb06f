"""An XV thumbnail reader without Pillow: ``np.asarray(Image.open(path))``
of the files Pillow 12.1's XVThumbImagePlugin reads, mode "P" (the 3:3:2
indices, uint8 [H, W]).

The file starts "P7 332"; the rest of that line is skipped, then lines
that start "#"; the next line's first two fields are the width and height,
and the pixels follow it.  A file that ends before that line or a size not
above 0 hands the file on (Image.open passes over the plugin); a line of
fewer than two fields or a field that is not a number raises ValueError,
as Pillow's int() does, and so do pixels that end first (Pillow: buffer is
not large enough).
"""

from __future__ import annotations

import numpy as np

from . import imgdec

MAGIC = b"P7 332"


def accepts_xvthumb(data: bytes) -> bool:
    return data[:6] == MAGIC


def _readline(data: bytes, pos: int) -> tuple:
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def decode_xvthumb(data: bytes) -> np.ndarray:
    if not accepts_xvthumb(data):
        raise imgdec.NotThisFormat("not an XV thumbnail file")
    _, pos = _readline(data, 6)
    while True:
        line, pos = _readline(data, pos)
        if not line:
            raise imgdec.NotThisFormat("Unexpected EOF reading XV thumbnail "
                                       "file")
        if line[0] != 35:
            break
    fields = line.strip().split(maxsplit=2)[:2]
    if len(fields) < 2:
        raise ValueError("XV thumbnail size line of fewer than two fields")
    W, H = int(fields[0]), int(fields[1])
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("XV thumbnail size not above 0")
    imgdec.check_size(W, H, "XV thumbnail")
    if len(data) < pos + W * H:
        raise ValueError("XV thumbnail pixels cut short (buffer is not "
                         "large enough)")
    return np.frombuffer(data, np.uint8, W * H, pos).reshape(H, W).copy()
