"""A netpbm reader without Pillow: ``np.asarray(Image.open(path))`` of the
files Pillow's PpmImagePlugin reads.

* P1-P6, plain (ASCII) and raw: P1/P4 bitmaps -> mode "1", bool [H, W]
  (0 white, True); P2/P5 -> "L", uint8 [H, W], or "I", int32, when maxval
  passes 255; P3/P6 -> "RGB", uint8 [H, W, 3];
* samples scaled as PpmDecoder / PpmPlainDecoder scale them: v / maxval *
  255 (or * 65535 in "I") rounded half to even, except a raw file whose
  maxval is 255 (copied) or a raw P5 of maxval 65535 (read as big-endian
  16-bit "I;16B"); raw samples above a maxval are clipped, plain ones
  refused;
* Pf (PFM): "F", float32, rows stored bottom to top, little-endian when
  the scale is negative; and Pillow's own P0CMYK, PyP, PyRGBA and PyCMYK;
* the header's tokens as PpmImageFile reads them: a comment runs from '#'
  to the end of its line, and a token may go on after it; at most 10
  characters.

A magic Pillow's MODES lacks, P7 (PAM) among them, hands the file on
(imgdec.NotThisFormat: Pillow's _open raises SyntaxError and Image.open
tries the next plugin; its _accept does not take "P7" at all, so an XV
thumbnail's "P7 332" reaches the XVThumb reader).  The plain samples are
parsed by native/imgdec.cpp.
"""

from __future__ import annotations

import math

import numpy as np

from . import imgdec

_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
          b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
          b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_WHITESPACE = b" \t\n\x0b\x0c\r"


class _Header:
    """PpmImageFile._read_magic / _read_token over the file's bytes."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def magic(self) -> bytes:
        m = b""
        while len(m) < 6 and self.pos < len(self.data):
            c = self.data[self.pos:self.pos + 1]
            self.pos += 1
            if c in _WHITESPACE:
                break
            m += c
        return m

    def token(self) -> bytes:
        t = b""
        while len(t) <= 10 and self.pos < len(self.data):
            c = self.data[self.pos:self.pos + 1]
            self.pos += 1
            if c in _WHITESPACE:
                if not t:
                    continue
                break
            if c == b"#":
                while self.pos < len(self.data) and self.data[
                        self.pos:self.pos + 1] not in b"\r\n":
                    self.pos += 1
                self.pos += 1
                continue
            t += c
        if not t or len(t) > 10:
            raise ValueError(f"netpbm header: a bad token {t[:11]!r}")
        return t


def decode_netpbm(data: bytes) -> np.ndarray:
    head = _Header(data)
    magic = head.magic()
    if magic not in _MODES:
        raise imgdec.NotThisFormat(f"not a PPM file (magic {magic!r})")
    mode = _MODES[magic]
    W, H = int(head.token()), int(head.token())
    if W <= 0 or H <= 0:
        raise ValueError(f"netpbm of size {W}x{H}")
    imgdec.check_size(W, H, "netpbm")
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        return _bitmap(data[head.pos:], W, H, plain)
    if mode == "F":
        scale = float(head.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PFM scale must be finite and non-zero")
        n = W * H * 4
        body = data[head.pos:head.pos + n]
        if len(body) < n:
            raise ValueError("PFM data too short")
        img = np.frombuffer(body, "<f4" if scale < 0 else ">f4")
        return img.reshape(H, W)[::-1].astype(np.float32)
    maxval = int(head.token())
    if not 0 < maxval < 65536:
        raise ValueError("netpbm maxval must be greater than 0 and less "
                         "than 65536")
    if maxval > 255 and mode == "L":
        mode = "I"
    bands = _BANDS[mode]
    count = W * H * bands
    shape = (H, W) if bands == 1 else (H, W, bands)
    out_max = 65535 if mode == "I" else 255
    body = data[head.pos:]
    if plain:
        v = imgdec.netpbm_plain(body, count, False)
        if v.size < count:
            raise ValueError("plain netpbm data too short")
        if (v > maxval).any():
            raise ValueError("plain netpbm sample above its maxval")
    else:
        if maxval == 255 or (maxval == 65535 and mode == "I"):
            dt = np.dtype(np.uint8) if maxval == 255 else np.dtype(">u2")
            raw = np.frombuffer(body[:count * dt.itemsize], dt)
            if raw.size < count:
                raise ValueError("netpbm data too short")
            out = raw.reshape(shape)
            return out.astype(np.int32 if mode == "I" else np.uint8)
        dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
        v = np.frombuffer(body[:count * dt.itemsize], dt)
        if v.size < count:
            raise ValueError("netpbm data too short")
    v = np.minimum(np.rint(v.astype(np.float64) / maxval * out_max), out_max)
    return v.astype(np.int32 if mode == "I" else np.uint8).reshape(shape)


def _bitmap(body: bytes, W: int, H: int, plain: bool) -> np.ndarray:
    """P1 / P4 -> mode "1": True where the pixel is white (0)."""
    if plain:
        v = imgdec.netpbm_plain(body, W * H, True)
        if v.size < W * H:
            raise ValueError("plain PBM data too short")
        return (v == 0).reshape(H, W)
    stride = (W + 7) // 8
    raw = np.frombuffer(body[:stride * H], np.uint8)
    if raw.size < stride * H:
        raise ValueError("PBM data too short")
    bits = np.unpackbits(raw.reshape(H, stride), axis=1)[:, :W]
    return bits == 0
