"""PCX and DCX readers without Pillow: ``np.asarray(Image.open(path))`` of
the files Pillow's PcxImagePlugin and DcxImagePlugin read.

* 1 bit in 1 plane -> mode "1", bool [H, W]; 1 bit in 2 or 4 planes ->
  "P", the indices (plane k holds bit k, a stride into the line);
* version 5, 8 bits in 1 plane -> "L" or "P" (the grey test of the
  769-byte palette at the end of the file decides; the array is the
  indices either way); 8 bits in 3 planes -> "RGB";
* the run-length code (native/imgdec.cpp; a run past the end of a line is
  refused) over lines of planes x stride bytes, the stride ceil(W * bits /
  8), rounded up to even when the header's differs, and at 8 bits
  PcxDecode.c's shift of the planes of a line whose length is not a
  multiple of W (Pillow's "RGB;L" unpacker then takes planes W apart);
* a DCX file gives its first page, a PCX at the first directory offset
  (whose palette check still reads the end of the whole file).

What Pillow refuses raises ValueError; a header Pillow's _open passes over
(too short, an empty box) raises imgdec.NotThisFormat.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec


def accepts_pcx(data: bytes) -> bool:
    """PcxImagePlugin._accept."""
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def decode_pcx(data: bytes, start: int = 0) -> np.ndarray:
    """The PCX image at `start` of `data` (0, or a DCX page's offset)."""
    s = data[start:start + 68]
    if len(s) < 68 or not accepts_pcx(s):
        raise imgdec.NotThisFormat("PCX header truncated")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise imgdec.NotThisFormat("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    (given,) = struct.unpack_from("<H", s, 66)
    W, H = x1 + 1 - x0, y1 + 1 - y0
    if bits == 1 and planes in (1, 2, 4):
        pass
    elif version == 5 and bits == 8 and planes in (1, 3):
        if planes == 1 and len(data) < 769:
            raise ValueError("8-bit PCX shorter than its end palette (Pillow "
                             "cannot seek to it)")
    else:
        raise ValueError(f"PCX of {bits} bits in {planes} planes, version "
                         f"{version} (Pillow reads none)")
    imgdec.check_size(W, H, "PCX")
    stride = (W * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    line = planes * stride
    lines = imgdec.pcx_rle(data[start + 128:], line, H)
    if bits == 8 and line % W and line > W:  # PcxDecode.c moves the planes
        bands = line // W
        step = line // bands
        lines = lines.copy()
        for i in range(1, bands):
            lines[:, i * W:(i + 1) * W] = lines[:, i * step:i * step + W]
    if bits == 8:
        if planes == 3:
            return np.ascontiguousarray(
                lines[:, :3 * W].reshape(H, 3, W).transpose(0, 2, 1))
        return np.ascontiguousarray(lines[:, :W])
    idx = np.zeros((H, W), np.uint8)
    for k in range(planes):
        b = np.unpackbits(lines[:, k * stride:(k + 1) * stride], axis=1)
        idx |= b[:, :W] << k
    return idx.astype(bool) if planes == 1 else idx


def decode_dcx(data: bytes) -> np.ndarray:
    # the directory: up to 1024 offsets, read until a zero
    offsets = []
    for i in range(1024):
        if len(data) < 8 + 4 * i:
            raise imgdec.NotThisFormat("DCX directory truncated")
        (off,) = struct.unpack_from("<I", data, 4 + 4 * i)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise ValueError("DCX without pages (Pillow reads none)")
    return decode_pcx(data, offsets[0])
