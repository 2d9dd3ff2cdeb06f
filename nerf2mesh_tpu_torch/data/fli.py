"""An Autodesk FLI/FLC animation reader without Pillow: ``np.asarray(
Image.open(path))`` of the files Pillow 12.1's FliImagePlugin reads: the
first frame, mode "P" (the indices, uint8 [H, W]).

Pillow takes a file whose 16-byte prefix has magic 0xAF11 or 0xAF12 at
byte 4 and flags 0 or 3 at byte 14, and whose 128-byte header is zero at
bytes 20-21, 42-79 and 88-127; it needs a frame count of at least 1 and a
size not 0.  To build its palette it walks the first frame's chunks (after
an optional 0xF100 prefix chunk) up to the first COLOR256 or COLOR64 chunk;
a read cut short there, or palette entries past index 255, hand the file
on as Image.open passes over the plugin.  The palette does not change the
indices.  The frame is then read from byte 128 whatever came first (a
prefix chunk there is not a frame: Pillow's decoder fails on it), in
reads of the frame's size as ImageFile.load reads it, and decoded into a
zeroed image by native/imgdec.cpp's ``fli_frame`` (SS2, LC, BLACK, BRUN,
COPY; colour and stamp chunks skipped); what Pillow's decoder reports, and
data that ends first, raise ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def accepts_fli(data: bytes) -> bool:
    return (len(data) >= 16 and _i16(data, 4) in (0xAF11, 0xAF12)
            and _i16(data, 14) in (0, 3))


def _walk_palette(data: bytes) -> None:
    """FliImageFile._open's chunk walk, for its failures alone."""
    pos = 128
    s = data[pos:pos + 16]
    pos += len(s)
    if _i16(s, 4) == 0xF100:
        pos = 128 + _i32(s)
        s = data[pos:pos + 16]
        pos += len(s)
    if _i16(s, 4) != 0xF1FA:
        return
    size = None
    for _ in range(_i16(s, 6)):
        if size is not None:
            pos += size - 6
            if pos < 0:
                raise ValueError("FLI: a chunk size that seeks before the "
                                 "file's start (Invalid argument)")
        s = data[pos:pos + 6]
        pos += len(s)
        kind = _i16(s, 4)
        if kind in (4, 11):
            count = data[pos:pos + 2]
            pos += len(count)
            i = 0
            for _ in range(_i16(count)):
                s = data[pos:pos + 2]
                pos += len(s)
                i, n = i + s[0], s[1] or 256
                s = data[pos:pos + 3 * n]
                pos += len(s)
                for k in range(0, len(s), 3):
                    s[k + 2]
                    if i >= 256:
                        raise IndexError("palette index past 255")
                    i += 1
            return
        size = _i32(s)
        if not size:
            return


def decode_fli(data: bytes) -> np.ndarray:
    head = data[:128]
    if not (accepts_fli(data) and head[20:22] == b"\0\0"
            and head[42:80] == bytes(38) and head[88:] == bytes(40)):
        raise imgdec.NotThisFormat("not an FLI/FLC file")
    frames, W, H = _i16(head, 6), _i16(head, 8), _i16(head, 10)
    try:
        _walk_palette(data)
    except (IndexError, struct.error) as e:
        raise imgdec.NotThisFormat(f"FLI header: {e}") from e
    if frames < 1:
        raise imgdec.NotThisFormat("FLI: attempt to seek outside sequence")
    if len(data) < 132:
        raise imgdec.NotThisFormat("FLI: missing frame size")
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("FLI size of 0")
    framesize = _i32(data, 128)
    out = np.zeros((H, W), np.uint8)
    pos, buf = 128, b""
    while True:
        s = data[pos:pos + framesize]
        pos += len(s)
        if not s:
            raise ValueError("FLI frame data truncated (image file is "
                             "truncated)")
        buf += s
        r = imgdec.fli_frame(buf, out)
        if r < 0:
            return out
        buf = buf[r:]
