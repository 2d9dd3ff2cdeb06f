"""A QOI (Quite OK Image) reader without Pillow: ``np.asarray(Image.open(
path))`` of a QOI file, as Pillow's QoiImagePlugin reads it.

The header ("qoif", width and height big-endian, channels, colour space);
3 channels -> "RGB" uint8 [H, W, 3], any other count -> "RGBA" [H, W, 4].
The operations of the specification (native/imgdec.cpp): QOI_OP_RGB,
QOI_OP_RGBA, QOI_OP_INDEX into the 64-entry table hashed by (3r + 5g +
7b + 11a) % 64, QOI_OP_DIFF, QOI_OP_LUMA and QOI_OP_RUN, from the pixel
(0, 0, 0, 255); as Pillow's QoiDecoder, a run does not enter its pixel
into the table, and an entry never written reads (0, 0, 0, 0).  Data that
ends before the last pixel raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec


def decode_qoi(data: bytes) -> np.ndarray:
    if data[:4] != b"qoif" or len(data) < 14:
        raise ValueError("not a QOI file")
    W, H, channels = struct.unpack_from(">IIB", data, 4)
    c = 3 if channels == 3 else 4
    imgdec.check_size(W, H, "QOI")
    if W * H > 62 * (len(data) - 14):        # a byte gives at most a run
        raise ValueError("QOI data ends before its last pixel")
    px = imgdec.qoi_decode(data[14:], c, W * H)
    if px.size < W * H * c:
        raise ValueError("QOI data ends before its last pixel")
    return px.reshape(H, W, c)
