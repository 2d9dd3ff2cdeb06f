"""A Kodak PhotoCD (PCD) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's PcdImagePlugin reads: the 768 x 512
base image, mode "RGB" (uint8 [512, 768, 3], or [768, 512, 3] rotated).

PCD has no _accept: Image.open tries it on every file no earlier plugin
took, and it is PCD when the 1539 bytes from 2048 start "PCD_" (else the
file is handed on).  Byte 2048 + 1538 & 3 is the orientation: 1 turns the
image 90 degrees counter-clockwise, 3 turns it 270.  The base image starts
at 96 * 2048: 256 chunks of two luma rows of 768 bytes and their shared
C1 and C2 rows of 384 bytes each; Pillow's "pcd" decoder gives each pixel
the chroma of its column / 2 (PcdDecode.c) and its "YCC;P" unpacker turns
PhotoYCC to RGB by five tables of (int)(k * (v - v0) + 0.5) (Kodak's
PhotoYCC matrix: luma 1.3584 y, C1 2.2179 (c1 - 156), C2 1.8215 (c2 -
137); R = L + C2, G = L - 0.194 C1 - 0.509 C2, B = L + C1), each channel
clipped to 0-255.  A file that ends inside the base image raises ValueError
(Pillow: image file is truncated).
"""

from __future__ import annotations

import numpy as np

from . import imgdec

W, H = 768, 512
OFFSET = 96 * 2048
_CHUNK = 3 * W


def _table(k: float, v0: int) -> np.ndarray:
    return np.trunc(k * (np.arange(256) - v0) + 0.5).astype(np.int32)


_L = _table(1.3584, 0)
_CB, _GB = _table(2.2179, 156), _table(-0.194 * 2.2179, 156)
_CR, _GR = _table(1.8215, 137), _table(-0.509 * 1.8215, 137)


def ycc_to_rgb(y: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Pillow's "YCC;P" unpacker on uint8 planes of one shape."""
    lum = _L[y]
    rgb = np.stack([lum + _CR[c2], lum + _GR[c2] + _GB[c1], lum + _CB[c1]],
                   -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_pcd(data: bytes) -> np.ndarray:
    head = data[2048:2048 + 1539]
    if not head.startswith(b"PCD_") or len(head) < 1539:
        raise imgdec.NotThisFormat("not a PCD file")
    orientation = head[1538] & 3
    body = data[OFFSET:OFFSET + _CHUNK * (H // 2)]
    if len(body) < _CHUNK * (H // 2):
        raise ValueError("PCD base image truncated (image file is "
                         "truncated)")
    chunks = np.frombuffer(body, np.uint8).reshape(H // 2, _CHUNK)
    y = chunks[:, :2 * W].reshape(H, W)
    cols = np.arange(W) // 2
    c1 = np.repeat(chunks[:, 2 * W:2 * W + W // 2][:, cols], 2, 0)
    c2 = np.repeat(chunks[:, 2 * W + W // 2:][:, cols], 2, 0)
    rgb = ycc_to_rgb(y, c1, c2)
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, -1)
    return np.ascontiguousarray(rgb)
