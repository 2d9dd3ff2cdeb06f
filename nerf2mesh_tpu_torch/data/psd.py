"""A PSD reader without Pillow: the array ``np.asarray(Image.open(path))``
gives for the Photoshop files Pillow 12.1.0's PsdImagePlugin reads.

That array is the merged image (the image data section after the layer
and mask section), whatever layers the file holds.  Pillow's ``MODES``:
bitmap as raw "1" (bit 1 True, no inversion), grey, duotone and
multichannel as "L", indexed as "P" (the indices), RGB as "RGB", or
"RGBA" when the file has exactly four channels, CMYK inverted ("C;I"...),
Lab with its a and b bytes' top bit flipped (Pillow's "A" and "B" band
unpackers for "LAB"); channels past the mode's are not read.  Raw data holds the
channels one after another; PackBits (compression 1) a 16-bit byte count
a row of each channel, then the rows: a channel starts where the byte
counts of the ones before it end, and is decoded from there on as
Pillow's PackBits decoder reads it (data/imgdec.py's ``packbits_rows``),
whatever its own rows' counts say.

What Pillow refuses (16- and 32-bit files and other mode/depth pairs,
fewer channels than the mode's, other compressions, data that ends early)
raises ValueError; a header Image.open passes over (another version, cut
short, no pixels) raises imgdec.NotThisFormat.  Pillow's refusal of a
mode/depth pair outside MODES is a KeyError that ImageFile turns into a
SyntaxError, so Image.open reports the file unidentified; no other plugin
reads a file that starts 8BPS, and the port says why it refuses it.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec

# (Photoshop colour mode, bits) -> (Pillow's mode, channels it reads)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


class _File:
    """The plugin's reads: short at the end of the data, unpacking a short
    read is a struct.error (Image.open passes the file over)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(b)
        return b

    def u(self, n: int) -> int:
        b = self.read(n)
        if len(b) < n:
            raise imgdec.NotThisFormat("PSD header truncated")
        return int.from_bytes(b, "big")


def _skip_resources(f: _File) -> None:
    size = f.u(4)
    end = f.pos + size
    while f.pos < end:
        f.read(4)
        f.u(2)
        name = f.read(f.u(1))
        if not len(name) & 1:
            f.read(1)
        if len(f.read(f.u(4))) & 1:
            f.read(1)


def decode_psd(data: bytes) -> np.ndarray:
    f = _File(data)
    s = f.read(26)
    if s[:4] != b"8BPS" or len(s) < 6 or s[4:6] != b"\0\1":
        raise imgdec.NotThisFormat("not a PSD file (version 1)")
    if len(s) < 26:
        raise imgdec.NotThisFormat("PSD header truncated")
    channels, height, width, bits, pmode = struct.unpack_from(">HIIHH", s, 12)
    if (pmode, bits) not in MODES:
        raise ValueError(f"PSD colour mode {pmode} at {bits} bits (Pillow "
                         "reads none)")
    mode, count = MODES[(pmode, bits)]
    if count > channels:
        raise ValueError(f"PSD {mode} with {channels} channels (not enough "
                         "channels)")
    if mode == "RGB" and channels == 4:
        mode, count = "RGBA", 4
    f.read(f.u(4))                              # colour mode data
    _skip_resources(f)
    size = f.u(4)                               # layer and mask section
    if size:
        end = f.pos + size
        f.u(4)
        f.pos = end
    compression = f.u(2)
    if width == 0 or height == 0:
        raise imgdec.NotThisFormat("PSD of no pixels")
    imgdec.check_size(width, height, "PSD")
    rowbytes = (width + 7) // 8 if mode == "1" else width
    if compression == 0:
        n = rowbytes * height
        starts = [f.pos + c * width * height for c in range(count)]
        planes = []
        for at in starts:
            if at + n > len(data):
                raise ValueError("PSD: image file is truncated")
            planes.append(np.frombuffer(data, np.uint8, n, at).reshape(
                height, rowbytes))
    elif compression == 1:
        counts = f.read(count * height * 2)
        if len(counts) < count * height * 2:
            raise imgdec.NotThisFormat("PSD byte counts truncated")
        sums = np.frombuffer(counts, ">u2").astype(np.int64).reshape(
            count, height).sum(1)
        starts = f.pos + np.concatenate([[0], np.cumsum(sums)[:-1]])
        planes = [imgdec.packbits_rows(data[int(at):], rowbytes, height)[0]
                  for at in starts]
    else:
        raise ValueError(f"PSD compression {compression} (Pillow cannot "
                         "load it)")
    if mode == "1":
        return np.unpackbits(planes[0], axis=1)[:, :width].astype(bool)
    if count == 1:
        return np.ascontiguousarray(planes[0])
    img = np.stack(planes, -1)
    if mode == "LAB":
        img[..., 1:] ^= 0x80
    return 255 - img if mode == "CMYK" else img
