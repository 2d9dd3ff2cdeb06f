"""A GIF reader without Pillow: the first frame as ``np.asarray(Image.open(
path))`` gives it, mode "P" (or "L" when the frame has no palette, or a
palette that is the grey ramp 0, 1, 2, ...): the colour indices as uint8
[H, W], H and W the logical screen's (grown to hold the frame, as Pillow
grows it).

The frame's LZW data (native/imgdec.cpp) fills its rectangle, in the
four-pass order when interlaced; the rest of the screen holds the graphic
control extension's transparent index, or 0 without one.  Global and local
palettes are skipped: the array is the indices in either mode.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec


def _sub_blocks(data: bytes, pos: int):
    """(the concatenated data sub-blocks at pos, the position after them)."""
    out = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        out.append(data[pos:pos + n])
        pos += n
    return b"".join(out), pos


def decode_gif(data: bytes) -> np.ndarray:
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    W, H, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 128 else 0)
    transparency = None
    while pos < len(data):
        kind = data[pos]
        pos += 1
        if kind == 0x21:                             # an extension
            label = data[pos]
            block, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(block) >= 4:
                transparency = block[3] if block[0] & 1 else None
        elif kind == 0x2C:                           # the image descriptor
            x0, y0, w, h, f = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            if f & 128:
                pos += 3 << ((f & 7) + 1)            # the local palette
            bits = data[pos]
            lzw, _ = _sub_blocks(data, pos + 1)
            break
        elif kind == 0x3B:
            raise ValueError("GIF without an image")
        else:
            raise ValueError(f"GIF block 0x{kind:02x}")
    else:
        raise ValueError("GIF without an image")
    W, H = max(W, x0 + w), max(H, y0 + h)
    out = np.full((H, W), transparency or 0, np.uint8)
    if bits > 12:
        raise ValueError(f"GIF LZW of {bits}-bit codes")
    px = imgdec.lzw_gif(lzw, bits, w * h)
    order = (np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                             np.arange(2, h, 4), np.arange(1, h, 2)])
             if f & 64 else np.arange(h))
    # the decoded rows into their places; data that ends early leaves the
    # fill in the rows it does not reach
    full, last = divmod(px.size, w)
    region = out[y0:y0 + h, x0:x0 + w]
    region[order[:full]] = px[:full * w].reshape(full, w)
    if last:
        region[order[full], :last] = px[full * w:]
    return out
