"""An IM (IFUNC Image Memory) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's ImImagePlugin reads, frame 0 of a file
that holds more.

* the header: lines "Key: value" (each at most 100 bytes, matched by the
  plugin's regular expression) up to a NUL or ^Z byte, then on to the ^Z;
  a line that does not match, no known key, no ^Z, or a size that is not
  positive hands the file on (Pillow's _open fails as Image.open passes
  over); the defaults are "L" and 512x512;
* every "Image type" of the plugin's OPEN table, by its raw mode: "1", "L",
  "P;2", "P;4", "RGB", line-interleaved "RGB;L", "LA;L", "RGBA;L",
  "RGBX;L", "CMYK;L" and "YCbCr;L", the band planes "RGB;T" and "RYB;T"
  (stored G, R, B), "I;32"/"I;32S", "I;16"/"I;16L"/"I;16B" (the last in
  Pillow's big-endian dtype), the float conversions "F;8", "F;8S", "F;16",
  "F;16S", "F;32" (unsigned) and "F;32F", and "F;2"-"F;31" through
  Pillow's bit decoder (Bit.c: LSB first, each row from a byte boundary,
  the bits left over ORed into the next row's first byte); "RLB" and a
  "PA;L" image without a colour LUT have no unpacker (ValueError);
* a "Lut" line: 768 bytes of planar palette after the header; a colour
  LUT makes "L" "P" (and "B2"/"B4" 8-bit "P") and "LA" "PA";
* rows bottom to top, as the plugin's tiles read them (orientation -1).
"""

from __future__ import annotations

import re

import numpy as np

from . import imgdec

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_COMMENT, _FRAMES, _LUT = "Comment", "File size (no of images)", "Lut"
_SCALE, _SIZE, _MODE = "Scale (x,y)", "Image size (x*y)", "Image type"
_TAGS = {_COMMENT, "Date", "Digitalization equipment", _FRAMES, _LUT, "Name",
         _SCALE, _SIZE, _MODE}

# ImImagePlugin.OPEN: "Image type" -> (mode, raw mode)
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
del _i, _j

# (mode, raw mode) -> (dtype of a sample as stored, samples a pixel); the
# line-interleaved modes store each row's bands one after the other
_RAW = {("L", "L"): ("u1", 1), ("P", "P"): ("u1", 1),
        ("RGB", "RGB"): ("u1", 3), ("I", "I;32"): ("<i4", 1),
        ("I", "I;32S"): ("<i4", 1), ("I;16", "I;16"): ("<u2", 1),
        ("I;16L", "I;16L"): ("<u2", 1), ("I;16B", "I;16B"): (">u2", 1),
        ("F", "F;8"): ("u1", 1), ("F", "F;8S"): ("i1", 1),
        ("F", "F;16"): ("<u2", 1), ("F", "F;16S"): ("<i2", 1),
        ("F", "F;32"): ("<u4", 1), ("F", "F;32F"): ("<f4", 1)}
_LINES = {("RGB", "RGB;L"): 3, ("LA", "LA;L"): 2, ("PA", "PA;L"): 2,
          ("RGBA", "RGBA;L"): 4, ("RGB", "RGBX;L"): 4,
          ("CMYK", "CMYK;L"): 4, ("YCbCr", "YCbCr;L"): 3}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _header(data: bytes):
    """ImImageFile._open: (mode, raw mode, (W, H), data offset)."""
    if b"\n" not in data[:100]:
        raise imgdec.NotThisFormat("not an IM file")
    info = {_MODE: "L", _SIZE: (512, 512)}
    rawmode, n, p, end = "L", 0, 0, len(data)
    while True:
        s = data[p:p + 1]
        p += len(s)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        nl = data.find(b"\n", p)
        stop = end if nl < 0 else nl + 1
        s, p = s + data[p:stop], stop
        if len(s) > 100:
            raise imgdec.NotThisFormat("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(
            b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise imgdec.NotThisFormat("Syntax error in IM header")
        k, v = (g.decode("latin-1") for g in m.group(1, 2))
        if k in (_FRAMES, _SCALE, _SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        elif k == _MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k != _COMMENT:
            info[k] = v
        n += k in _TAGS
    if not n:
        raise imgdec.NotThisFormat("Not an IM file")
    size, mode = info[_SIZE], info[_MODE]
    if not mode or not isinstance(size, tuple) or min(size[:2]) <= 0:
        raise imgdec.NotThisFormat("IM mode empty or size not positive")
    if s == b"\0":                       # on to the ^Z
        z = data.find(b"\x1a", p)
        if z < 0:
            raise imgdec.NotThisFormat("File truncated")
        p = z + 1
    elif not s:
        raise imgdec.NotThisFormat("File truncated")
    if _LUT in info:
        pal = data[p:p + 768]
        p += len(pal)
        greyscale = True
        for i in range(256):                 # the plugin's chained test
            if i + 256 >= len(pal) or (
                    pal[i] == pal[i + 256] and i + 512 >= len(pal)):
                raise imgdec.NotThisFormat("IM palette cut short")
            if not pal[i] == pal[i + 256] == pal[i + 512]:
                greyscale = False
        if not greyscale:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            elif mode in ("LA", "PA"):
                mode, rawmode = "PA", "PA;L"
    return mode, rawmode, size, p


def _rows(data: bytes, pos: int, H: int, stride: int) -> np.ndarray:
    """[H, stride] bytes from pos, top row first (the file's rows run
    bottom to top)."""
    if len(data) < pos + H * stride:
        raise ValueError("IM image data truncated (image file is "
                         "truncated)")
    return np.frombuffer(data, np.uint8, H * stride, pos).reshape(
        H, stride)[::-1]


def _bits(data: bytes, pos: int, W: int, H: int, n: int) -> np.ndarray:
    """Pillow's bit decoder ("F;n", fill 3, pad 8): each row's n-bit
    samples LSB first from a byte boundary; the bits a row leaves in the
    last byte are ORed into the next row's first byte."""
    stride = (W * n + 7) // 8
    rows = _rows(data, pos, H, stride)[::-1].copy()     # file order
    left = 0
    if W * n >= 8:       # what a row leaves comes from its last byte alone
        carry = rows[:, -1].astype(np.int64) >> ((W * n) % 8 or 8)
        rows[1:, 0] |= carry[:-1].astype(np.uint8)
    else:
        for r in range(H):
            v = left | int(rows[r, 0])
            rows[r, 0] = v & 0xFF
            left = v >> (W * n)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :W * n]
    weights = np.left_shift(np.uint64(1), np.arange(n, dtype=np.uint64))
    vals = (bits.reshape(H, W, n).astype(np.uint64) * weights).sum(-1)
    return vals.astype(np.float32)[::-1]


def decode_im(data: bytes) -> np.ndarray:
    mode, rawmode, size, pos = _header(data)
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ValueError(f"IM size {size} (Pillow loads none)")
    W, H = size
    imgdec.check_size(W, H, "IM")
    if rawmode[:2] == "F;" and rawmode[2:].isdigit() and int(
            rawmode[2:]) not in (8, 16, 32):
        if mode != "F":
            raise ValueError(f"IM {rawmode} into mode {mode}")
        return np.ascontiguousarray(_bits(data, pos, W, H, int(rawmode[2:])))
    if (mode, rawmode) == ("RGB", "RGB;T") or (mode, rawmode) == (
            "RGB", "RYB;T"):
        g, r, b = (_rows(data, pos + i * W * H, H, W) for i in range(3))
        return np.ascontiguousarray(np.stack([r, g, b], -1))
    if (mode, rawmode) == ("1", "1"):
        rows = _rows(data, pos, H, (W + 7) // 8)
        return np.ascontiguousarray(np.unpackbits(rows, axis=1)[:, :W] == 1)
    if (mode, rawmode) in (("P", "P;2"), ("P", "P;4")):
        n = int(rawmode[2])
        rows = _rows(data, pos, H, (W * n + 7) // 8)
        bits = np.unpackbits(rows, axis=1)[:, :W * n].reshape(H, W, n)
        return np.ascontiguousarray(
            (bits << np.arange(n - 1, -1, -1, dtype=np.uint8)).sum(
                -1, dtype=np.uint8))
    if (mode, rawmode) in _LINES:
        nb = _LINES[(mode, rawmode)]
        rows = _rows(data, pos, H, nb * W).reshape(H, nb, W)
        img = rows.transpose(0, 2, 1)
        return np.ascontiguousarray(img[..., :3] if nb == 4 and mode ==
                                    "RGB" else img)
    if (mode, rawmode) not in _RAW:
        raise ValueError(f"IM mode {mode} with raw mode {rawmode}: unknown "
                         f"raw mode for given image mode (Pillow loads "
                         f"none)")
    dt, ch = _RAW[(mode, rawmode)]
    nb = np.dtype(dt).itemsize * ch
    rows = _rows(data, pos, H, nb * W)
    img = np.ascontiguousarray(rows).view(dt).reshape(
        (H, W, ch) if ch > 1 else (H, W))
    if mode == "F":
        img = img.astype(np.float32)
    return np.ascontiguousarray(img)
