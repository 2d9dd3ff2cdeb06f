"""A minimal PNG codec (zlib + numpy) for machines without Pillow.

Reads and writes 8-bit, non-interlaced grayscale, RGB and RGBA images: the
blender frames, the synthetic scene's RGBA frames and the eval's rgb, depth
and error maps.  Reading undoes the five row filters of the PNG standard;
writing uses filter 0 on every row.  Any other PNG (palette, 16-bit, gray
with alpha, interlaced) raises NotImplementedError (ROADMAP A6 (a')).

``read_image`` / ``write_image`` use Pillow where it is importable and this
codec otherwise, so both give the array ``np.asarray(Image.open(path))``
gives: [H, W] for grayscale, [H, W, 3] or [H, W, 4] uint8 otherwise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG color type -> channels
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


def _paeth_row(f: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(len(f))
    for i, v in enumerate(f):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (v + pred) & 0xFF
    return out


def _average_row(f: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(len(f))
    for i, v in enumerate(f):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (v + ((a + prior[i]) >> 1)) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"PNG with bit depth {depth}, color type {ctype}, interlace "
            f"{interlace}: only 8-bit non-interlaced gray, RGB and RGBA are "
            "read without Pillow (ROADMAP A6 (a'))")
    C = _CHANNELS[ctype]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, f = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            row = f
        elif kind == 1:         # Sub: running sum along each channel
            row = np.cumsum(f.reshape(W, C), axis=0, dtype=np.uint64)
            row = (row & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:         # Up
            row = f + prior
        elif kind == 3:         # Average
            row = np.frombuffer(_average_row(f.tobytes(), prior.tobytes(), C),
                                np.uint8)
        elif kind == 4:         # Paeth
            row = np.frombuffer(_paeth_row(f.tobytes(), prior.tobytes(), C),
                                np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter {kind}")
        out[y] = row
        prior = out[y]
    return out.reshape(H, W, C)[..., 0] if C == 1 else out.reshape(H, W, C)


def encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise NotImplementedError(
            f"PNG writer takes [H, W] or [H, W, 3|4] images, not {img.shape} "
            "(ROADMAP A6 (a'))")
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(H, W * C)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def read_image(path: str) -> np.ndarray:
    """np.asarray(Image.open(path)) with Pillow, else the PNG codec."""
    try:
        from PIL import Image
    except ImportError:
        return read_png(path)
    with Image.open(path) as im:
        return np.asarray(im)


def write_image(path: str, img: np.ndarray) -> None:
    """Image.fromarray(img).save(path) with Pillow, else the PNG codec."""
    try:
        from PIL import Image
    except ImportError:
        write_png(path, img)
        return
    Image.fromarray(np.asarray(img)).save(path)
