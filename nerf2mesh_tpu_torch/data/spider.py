"""A SPIDER reader without Pillow: ``np.asarray(Image.open(path))`` of the
2D images Pillow 12.1's SpiderImagePlugin reads, mode "F" (float32 [H, W]).

SPIDER has no signature: Image.open tries the plugin on every file no
earlier plugin took.  Its header is 27 float32 words, big-endian tried
first, then little-endian; it is SPIDER when words 1, 2, 5, 12, 13, 22 and
23 are whole, word 5 (iform) is one of 1, 3, -11, -12, -21, -22 and word 22
(the header's bytes) is word 13 times word 23 and not 0; else the file is
handed on.  Only iform 1 (a 2D image) reads; a stack (word 24 > 0, word 27
0) reads its first image, after the second header.  The size is word 12 x
word 2; the samples follow the header in the header's byte order.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import imgdec

_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    return math.isfinite(f) and f - int(f) == 0


def _header_bytes(t: tuple) -> int:
    """SpiderImagePlugin.isSpiderHeader on the words t (1-based there)."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


def decode_spider(data: bytes) -> np.ndarray:
    if len(data) < 108 or not any(struct.unpack_from(o + "f", data, 16)[0]
                                  in _IFORMS for o in "><"):
        raise imgdec.NotThisFormat("not a valid Spider file")
    order = ">"
    t = struct.unpack_from(">27f", data)
    hdrlen = _header_bytes(t)
    if not hdrlen:
        order = "<"
        t = struct.unpack_from("<27f", data)
        hdrlen = _header_bytes(t)
    if not hdrlen:
        raise imgdec.NotThisFormat("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise imgdec.NotThisFormat("not a Spider 2D image")
    W, H = int(h[12]), int(h[2])
    for v in (h[24], h[27]):
        if not math.isfinite(v):
            raise ValueError(f"SPIDER stack word {v} (Pillow: cannot "
                             f"convert to an integer)")
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        if not math.isfinite(h[26]):
            raise ValueError(f"SPIDER stack of {h[26]} images")
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        raise ValueError("SPIDER image of a stack without its stack header "
                         "(Pillow: no stkoffset)")
    else:
        raise imgdec.NotThisFormat("inconsistent stack header values")
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("SPIDER size not positive")
    imgdec.check_size(W, H, "SPIDER")
    if offset < 0 or len(data) < offset + 4 * W * H:
        raise ValueError("SPIDER image data truncated (image file is "
                         "truncated)")
    img = np.frombuffer(data, order + "f4", W * H, offset).reshape(H, W)
    return img.astype(np.float32)
