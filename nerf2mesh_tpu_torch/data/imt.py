"""An IM Tools (IMT) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's ImtImagePlugin reads, mode "L" (uint8
[H, W]).

IMT has no _accept: Image.open tries it on every file no earlier plugin
took.  Its first 100 bytes must hold a newline.  Then the header is read
as Pillow's _open reads it, in 100-byte reads: a form feed (0x0C) ends it
and the pixels follow; otherwise a line "width N", "height N" or "pixel
n8" (the last makes the mode "L") is taken, a line starting "*" is a
comment, and any other (a line of one byte, of more than 100, or not
"name value") ends the header without pixels.  No "pixel n8", a size not
above 0 or no newline hands the file on (Image.open passes over the
plugin); a header that ends without a form feed (Pillow: cannot load this
image), a width or height that is not a number (Pillow's int()) and pixels
that end first raise ValueError.
"""

from __future__ import annotations

import re

import numpy as np

from . import imgdec

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _header(data: bytes) -> tuple:
    """ImtImageFile._open over `data`: (width, height, whether the mode is
    "L", the pixels' offset or None)."""
    fp = min(100, len(data))                # the file position
    buffer = data[:fp]
    if b"\n" not in buffer:
        raise imgdec.NotThisFormat("not an IM file")
    xsize = ysize = 0
    size, grey = (0, 0), False
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[fp:fp + 1]
            fp += len(s)
        if not s:
            return size + (grey, None)
        if s == b"\x0c":
            return size + (grey, fp - len(buffer))
        if b"\n" not in buffer:
            more = data[fp:fp + 100]
            fp += len(more)
            buffer += more
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            return size + (grey, None)
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            return size + (grey, None)
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
            size = (xsize, ysize)
        elif k == b"height":
            ysize = int(v)
            size = (xsize, ysize)
        elif k == b"pixel" and v == b"n8":
            grey = True


def decode_imt(data: bytes) -> np.ndarray:
    W, H, grey, offset = _header(data)
    if not grey or W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("not an IM Tools image")
    imgdec.check_size(W, H, "IM Tools")
    if offset is None:
        raise ValueError("IM Tools header without pixels (cannot load this "
                         "image)")
    if len(data) < offset + W * H:
        raise ValueError("IM Tools pixels cut short (buffer is not large "
                         "enough)")
    return np.frombuffer(data, np.uint8, W * H, offset).reshape(H, W).copy()
