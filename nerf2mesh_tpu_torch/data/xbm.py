"""An X bitmap (XBM) reader without Pillow: ``np.asarray(Image.open(path))``
of the files Pillow 12.1's XbmImagePlugin reads, mode "1" (bool [H, W]).

Pillow takes a file whose first 16 bytes, leading whitespace stripped,
start "#define", and whose first 512 bytes match its header expression
(the width and height defines, an optional hot spot, then anything up to
the last "_bits[]"); else the file is handed on.  XbmDecode.c then reads
the text after that "_bits[]": it skips to the next "x", takes the two
characters after it as hex digits (a character that is not one counts 0),
and goes on after them.  So an X11 file's "0x5a" is a byte, and an X10
file's "0x1234" gives its first two digits, "34" skipped.  Each row is
ceil(W / 8) such bytes, its first pixel in the low bit ("1;R"); text that
ends before the last row raises ValueError (image file is truncated).
"""

from __future__ import annotations

import re

import numpy as np

from . import imgdec

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789abcdefABCDEF":
    _HEX[_c] = int(chr(_c), 16)
del _c


def accepts_xbm(data: bytes) -> bool:
    return data[:16].lstrip().startswith(b"#define")


def decode_xbm(data: bytes) -> np.ndarray:
    m = _HEAD.match(data[:512])
    if not m:
        raise imgdec.NotThisFormat("not a XBM file")
    W, H = int(m.group("width")), int(m.group("height"))
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("XBM size not positive")
    imgdec.check_size(W, H, "XBM")
    stride = (W + 7) // 8
    need = stride * H
    text = np.frombuffer(data, np.uint8, offset=m.end())
    xs = np.flatnonzero(text == ord("x"))
    xs = xs[xs + 2 < text.size]              # a token needs its two digits
    if xs.size and np.any(np.diff(xs[:need + 2]) < 3):
        keep, last = [], -3                  # an "x" inside a token
        for x in xs.tolist():
            if x >= last + 3:
                keep.append(x)
                last = x
                if len(keep) == need:
                    break
        xs = np.asarray(keep, np.int64)
    if xs.size < need:
        raise ValueError("XBM data truncated (image file is truncated)")
    xs = xs[:need]
    rows = ((_HEX[text[xs + 1]] << 4) | _HEX[text[xs + 2]]).reshape(H, stride)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :W]
    return np.ascontiguousarray(bits == 1)
