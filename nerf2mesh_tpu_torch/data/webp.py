"""A WebP reader without Pillow or libwebp: the array ``np.asarray(
Image.open(path))`` gives for the first frame, as Pillow's WebPAnimDecoder
returns it: RGBA uint8 [H, W, 4] when the file says it has alpha (the VP8X
alpha flag, or a lossless stream's alpha bit), else RGB [H, W, 3].

The RIFF container (simple "VP8 " or "VP8L", extended "VP8X" with "ALPH",
and animations' "ANIM"/"ANMF", of which the first frame is placed on a
transparent black canvas of the VP8X size) is read here; the bitstreams are
decoded by ``native/webpdec.cpp``: lossless VP8L (its four transforms, the
colour cache, meta prefix codes), lossy VP8 key frames (the boolean
decoder, intra prediction, the inverse DCT and WHT, the loop filters, then
libwebp's YUV -> RGB and its "fancy" chroma upsampling), and the ALPH
chunk (raw or VP8L-coded, with its horizontal, vertical or gradient
filter).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

_I64, _PTR, _INT = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "vp8l_decode": (_INT, [_PTR, _I64, _INT, _INT, _INT, _PTR,
                           ctypes.c_char_p, _INT]),
    "vp8_decode": (_INT, [_PTR, _I64, _INT, _INT, _PTR, _INT,
                          ctypes.c_char_p, _INT]),
    "alpha_unfilter": (None, [_PTR, _INT, _INT, _INT]),
}


def _lib():
    from ..utils.native import load_library
    return load_library("webpdec", _SIGNATURES)


def _u24(b: bytes, o: int) -> int:
    return b[o] | (b[o + 1] << 8) | (b[o + 2] << 16)


def _chunks(data: bytes, pos: int, end: int):
    out = []
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _call(fn, *args):
    err = ctypes.create_string_buffer(256)
    if fn(*args, err, len(err)):
        raise ValueError("WebP: " + err.value.decode(errors="replace"))


def _vp8l(payload: bytes, w: int, h: int, headerless: bool) -> np.ndarray:
    """ARGB words [h, w] of a VP8L stream."""
    src = np.frombuffer(payload, np.uint8)
    out = np.empty((h, w), np.uint32)
    _call(_lib().vp8l_decode, src.ctypes.data, src.size, w, h,
          int(headerless), out.ctypes.data)
    return out


def _alpha(payload: bytes, w: int, h: int) -> np.ndarray:
    head = payload[0]
    method, filt = head & 3, (head >> 2) & 3
    if method == 0:
        a = np.frombuffer(payload, np.uint8, w * h, 1).reshape(h, w).copy()
    elif method == 1:
        a = ((_vp8l(payload[1:], w, h, True) >> 8) & 255).astype(np.uint8)
    else:
        raise ValueError(f"WebP ALPH compression {method}")
    if filt:
        _lib().alpha_unfilter(a.ctypes.data, w, h, filt)
    return a


def _frame(chunks) -> tuple:
    """(RGBA [h, w, 4], the stream's own alpha bit) of a frame's chunks."""
    alph = None
    for kind, payload in chunks:
        if kind == b"ALPH":
            alph = payload
        elif kind == b"VP8L":
            if len(payload) < 5:
                raise ValueError("WebP: VP8L chunk too short")
            (bits,) = struct.unpack_from("<I", payload, 1)
            w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
            argb = _vp8l(payload, w, h, False)
            rgba = argb.view(np.uint8).reshape(h, w, 4)[..., [2, 1, 0, 3]]
            return np.ascontiguousarray(rgba), bool((bits >> 28) & 1)
        elif kind == b"VP8 ":
            if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
                raise ValueError("WebP: not a VP8 key frame")
            w = struct.unpack_from("<H", payload, 6)[0] & 0x3FFF
            h = struct.unpack_from("<H", payload, 8)[0] & 0x3FFF
            src = np.frombuffer(payload, np.uint8)
            rgba = np.full((h, w, 4), 255, np.uint8)
            _call(_lib().vp8_decode, src.ctypes.data, src.size, w, h,
                  rgba.ctypes.data, 4)
            if alph is not None:
                rgba[..., 3] = _alpha(alph, w, h)
            return rgba, False
    raise ValueError("WebP: no VP8 or VP8L bitstream")


def decode_webp(data: bytes) -> np.ndarray:
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    chunks = _chunks(data, 12, end)
    if not chunks:
        raise ValueError("WebP without chunks")
    if chunks[0][0] != b"VP8X":
        rgba, alpha = _frame(chunks[:1])
        return rgba if alpha else np.ascontiguousarray(rgba[..., :3])
    head = chunks[0][1]
    flags = head[0]
    W, H = _u24(head, 4) + 1, _u24(head, 7) + 1
    x = y = 0
    if flags & 0x02:                                 # animated
        frames = [p for k, p in chunks if k == b"ANMF"]
        if not frames:
            raise ValueError("WebP animation without frames")
        f = frames[0]
        x, y = 2 * _u24(f, 0), 2 * _u24(f, 3)
        rgba, _ = _frame(_chunks(f, 16, len(f)))
    else:
        rgba, _ = _frame(chunks[1:])
    canvas = np.zeros((H, W, 4), np.uint8)
    fh, fw = rgba.shape[:2]
    canvas[y:y + fh, x:x + fw] = rgba[:H - y, :W - x]
    return canvas if flags & 0x10 else np.ascontiguousarray(canvas[..., :3])
