"""ICO and CUR readers without Pillow: ``np.asarray(Image.open(path))`` of
the files Pillow's IcoImagePlugin and CurImagePlugin read.

* ICO: the entry the plugin's two stable sorts put first (the largest
  width x height, a width or height byte of 0 meaning 256, and among
  equal sizes the lowest colour depth: the bpp field, else log2 of the
  colour count, else 256); a PNG entry reads through data/png.py; a BMP
  entry (its header's height doubled) through data/bmp.py's ``bitmap``,
  as "RGBA": at 32 bits the fourth byte of each pixel is the alpha, below
  that the AND mask (read at the directory's offset + size less the
  mask's bytes) is the alpha, 255 where its bit is clear, the colours
  through the palette;
* CUR: the entry Pillow's raw byte comparison keeps (a later entry wins
  only when both its width and height bytes are larger, so 256 stored as
  0 loses), read as the bitmap's first half in its own mode ("P" as
  indices), without the mask; 32 bits without bitfields are "RGB", but
  "RGBA" for an entry at file offset 22 (BmpImagePlugin's special case of
  a one-cursor file).  A PNG entry is refused, as Pillow refuses it.

What Pillow refuses raises ValueError; a directory Image.open passes over
(too short, no entries) raises imgdec.NotThisFormat.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import imgdec
from .bmp import bitmap

_PNG = b"\x89PNG\r\n\x1a\n"


def _entries(data: bytes) -> list:
    if len(data) < 6:
        raise imgdec.NotThisFormat("icon directory truncated")
    (count,) = struct.unpack_from("<H", data, 4)
    if len(data) < 6 + 16 * count:
        raise imgdec.NotThisFormat("icon directory truncated")
    return [data[6 + 16 * i:22 + 16 * i] for i in range(count)]


def decode_ico(data: bytes) -> np.ndarray:
    ents = []
    for e in _entries(data):
        w, h, colours = e[0] or 256, e[1] or 256, e[2]
        bpp, size, off = struct.unpack_from("<HII", e, 6)
        depth = bpp or (colours and math.ceil(math.log(colours, 2))) or 256
        ents.append((w * h, depth, size, off, bpp))
    if not ents:
        raise imgdec.NotThisFormat("ICO without entries")
    ents.sort(key=lambda t: t[1])
    ents.sort(key=lambda t: t[0], reverse=True)
    _, _, size, off, bpp = ents[0]
    if data[off:off + 8] == _PNG:
        from .png import decode_png
        return decode_png(data[off:])
    img, mode, palette, pix = bitmap(data, off, half=True)
    H, W = img.shape[:2]
    imgdec.check_size(W, H, "ICO")
    if bpp == 32:
        a = np.frombuffer(data, np.uint8, min(W * H * 4, max(
            len(data) - pix, 0)), pix)[3::4]
        if a.size < W * H:
            raise ValueError("ICO alpha truncated (not enough image data)")
        alpha = a.reshape(H, W)[::-1]
    else:
        wpad = -(-W // 32) * 32
        total = wpad * H // 8
        at = off + size - total
        m = np.frombuffer(data[at:at + total] if at >= 0 else b"", np.uint8)
        if m.size < total:
            raise ValueError("ICO AND mask truncated (not enough image data)")
        bits = np.unpackbits(m.reshape(H, wpad // 8), axis=1)[:, :W]
        alpha = np.where(bits[::-1] == 0, 255, 0).astype(np.uint8)
    return np.concatenate([_rgb(img, mode, palette), alpha[..., None]], -1)


def _rgb(img: np.ndarray, mode: str, palette) -> np.ndarray:
    """convert("RGB") of a bitmap in Pillow's mode."""
    if mode == "1":
        img = img.astype(np.uint8) * 255
    if mode in ("1", "L"):
        return np.repeat(img[..., None], 3, -1)
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(len(palette), 256)] = palette[:256]
        return pal[img]
    return np.ascontiguousarray(img[..., :3])


def decode_cur(data: bytes) -> np.ndarray:
    ents, best = _entries(data), b""
    for e in ents:
        if not best or (e[0] > best[0] and e[1] > best[1]):
            best = e
    if not best:
        raise imgdec.NotThisFormat("CUR without cursors")
    (off,) = struct.unpack_from("<I", best, 12)
    header = off or 6 + 16 * len(ents)      # 0: right after the directory
    if len(data) < header + 4:
        raise imgdec.NotThisFormat("CUR bitmap header truncated")
    if data[header:header + 8] == _PNG:
        raise ValueError("CUR with a PNG entry (Pillow reads none)")
    img = bitmap(data, header, half=True, raw_alpha=off == 22)[0]
    imgdec.check_size(img.shape[1], img.shape[0], "CUR")
    return img
