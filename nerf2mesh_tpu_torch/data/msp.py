"""A Windows Paint (MSP) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's MspImagePlugin reads, mode "1" (bool
[H, W], a set bit True).

The 32-byte header starts "DanM" (version 1) or "LinS" (version 2), and
its sixteen little-endian words XOR to 0 (else the file is handed on, as
Image.open passes over the plugin); the size is words 2 and 3.  Version 1
holds raw rows of ceil(W / 8) bytes from byte 32.  Version 2 holds a map of
H row lengths, then each row's RLE as Pillow's Python MspDecoder reads it:
a row of length 0 is white (0xFF bytes); a 0 byte starts a run (count,
value), any other a literal of that many bytes.  The decoded rows are one
stream, unpacked W bits a row whatever each row's own length, so a row
that decodes short or long shifts the rows after it; a stream too short
for the image, a row map or row cut short, or a run cut short raise
ValueError (Pillow: "not enough image data", OSError).
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec


def accepts_msp(data: bytes) -> bool:
    return data[:4] in (b"DanM", b"LinS")


def _rle_rows(data: bytes, W: int, H: int) -> bytes:
    blank = b"\xff" * ((W + 7) // 8)
    if len(data) < 32 + 2 * H:
        raise ValueError("Truncated MSP file in row map")
    rowmap = struct.unpack_from(f"<{H}H", data, 32)
    out, pos = [], 32 + 2 * H
    for y, n in enumerate(rowmap):
        if n == 0:
            out.append(blank)
            continue
        row = data[pos:pos + n]
        pos += n
        if len(row) != n:
            raise ValueError(f"Truncated MSP file, expected {n} bytes on "
                             f"row {y}")
        i = 0
        while i < n:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > n:
                    raise ValueError(f"Corrupted MSP file in row {y}")
                out.append(row[i + 1:i + 2] * row[i])
                i += 2
            else:
                out.append(row[i:i + kind])
                i += kind
    return b"".join(out)


def decode_msp(data: bytes) -> np.ndarray:
    if len(data) < 32 or not accepts_msp(data):
        raise imgdec.NotThisFormat("not an MSP file")
    words = struct.unpack_from("<16H", data)
    check = 0
    for w in words:
        check ^= w
    W, H = words[2], words[3]
    if check or W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("bad MSP checksum or size")
    stride = (W + 7) // 8
    body = data[32:] if data[:4] == b"DanM" else _rle_rows(data, W, H)
    if len(body) < stride * H:
        raise ValueError("MSP image data truncated (not enough image data)")
    rows = np.frombuffer(body, np.uint8, stride * H).reshape(H, stride)
    return np.ascontiguousarray(np.unpackbits(rows, axis=1)[:, :W] == 1)
