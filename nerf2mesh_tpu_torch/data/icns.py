"""A Mac OS icon (ICNS) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's IcnsImagePlugin reads.

* the table of contents: blocks (type, length) from byte 8 to the header's
  file size, a later block of a type replacing an earlier one; a block
  length of 0, a header cut short or no block of a known slot hands the
  file on (Image.open passes over the plugin);
* the slots of ``IcnsFile.SIZES``, and the best one: the largest (width,
  height, scale) present, all of its entries read in the table's order;
* a PNG or JPEG 2000 entry (``ic07``-``ic14``, ``icp4``-``icp6``) wins over
  its slot's RGB and mask.  A PNG entry, read through the file from its
  start, keeps the PNG's own mode and size: RGBA as is, RGB "scrambled"
  (np.asarray packs the loaded RGB core with the RGBA packer Pillow chose
  before the load, and shapes the bytes as RGB: the pixels with a 255 pad
  byte each, cut to H * W * 3), any other mode refused (no packer to
  RGBA).  A JPEG 2000 entry goes through data/jpeg2000.py and Pillow's
  convert("RGBA"): grey thrice, "I;16" clipped to 255, CMYK by Pillow's
  cmyk2rgb, alpha 255 where there is none; "P" and "PA" through the
  palette Pillow builds from the pclr box (jpeg2000.pillow_palette: one
  slot a distinct colour), its slots past the palette's size opaque black
  as the core leaves them, with "PA"'s own alpha;
* an RGB entry (``is32``, ``il32``, ``ih32``, and ``it32`` after four zero
  bytes) is raw when its length is 3 * W * H, else three bands of Pillow's
  RLE (native/imgdec.cpp); with its slot's mask (``s8mk``-``t8mk``) it is
  RGBA, without one RGB scrambled as above, with a 255 pad after raw data
  and a 0 pad after RLE (Image.new's);
* the loaded size must be one Pillow's size setter allows (S_h / h == S_w
  // w for a slot present), else ValueError, as Pillow raises.

What Pillow's load refuses raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec

_PNG, _RGB, _RGB_T, _MASK = range(4)
# IcnsFile.SIZES: (width, height, scale) -> [(block type, reader)]; _PNG
# reads a PNG or JPEG 2000 entry
SIZES = {
    (512, 512, 2): [(b"ic10", _PNG)],
    (512, 512, 1): [(b"ic09", _PNG)],
    (256, 256, 2): [(b"ic14", _PNG)],
    (256, 256, 1): [(b"ic08", _PNG)],
    (128, 128, 2): [(b"ic13", _PNG)],
    (128, 128, 1): [(b"ic07", _PNG), (b"it32", _RGB_T), (b"t8mk", _MASK)],
    (64, 64, 1): [(b"icp6", _PNG)],
    (32, 32, 2): [(b"ic12", _PNG)],
    (48, 48, 1): [(b"ih32", _RGB), (b"h8mk", _MASK)],
    (32, 32, 1): [(b"icp5", _PNG), (b"il32", _RGB), (b"l8mk", _MASK)],
    (16, 16, 2): [(b"ic11", _PNG)],
    (16, 16, 1): [(b"icp4", _PNG), (b"is32", _RGB), (b"s8mk", _MASK)],
}
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def accepts_icns(data: bytes) -> bool:
    return data[:4] == b"icns"


def _toc(data: bytes) -> dict:
    """IcnsFile.__init__: {block type: (start, length)}."""
    if len(data) < 8:
        raise imgdec.NotThisFormat("ICNS header cut short")
    (filesize,) = struct.unpack_from(">I", data, 4)
    blocks, i = {}, 8
    while i < filesize:
        if i + 8 > len(data):
            raise imgdec.NotThisFormat("ICNS block header cut short")
        sig, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise imgdec.NotThisFormat("invalid block header")
        blocks[sig] = (i + 8, size - 8)
        i += size
    return blocks


def _rgba_packed(rgb: np.ndarray, pad: int) -> np.ndarray:
    """np.asarray of an RGB core packed as "RGBA" and shaped as RGB."""
    H, W = rgb.shape[:2]
    px = np.concatenate([rgb, np.full((H, W, 1), pad, np.uint8)], -1)
    return px.reshape(-1)[:H * W * 3].reshape(H, W, 3)


def _png_entry(data: bytes, start: int):
    """(the PNG's array, whether it is RGB) of the PNG from `start`."""
    from .png import decode_png
    img = decode_png(data[start:])
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        return img, img.shape[2] == 3
    raise ValueError(f"ICNS PNG entry of {img.dtype} {img.shape[2:]} "
                     f"samples: not RGB or RGBA, no packer found from its "
                     f"mode to RGBA (Pillow)")


def _core_palette(palette) -> np.ndarray:
    """[256, 4] RGBA of Pillow's core palette after putpalette: the
    palette's whole slots, then opaque black."""
    mode, pal = palette
    n = len(mode)
    size = len(pal) // n
    if size > 256:
        raise ValueError("invalid palette size")
    core = np.zeros((256, 4), np.uint8)
    core[:, 3] = 255
    slots = np.frombuffer(pal, np.uint8, size * n).reshape(size, n)
    core[:size, :n] = slots
    return core


def _j2k_entry(data: bytes) -> np.ndarray:
    """The JPEG 2000 entry through Pillow's convert("RGBA")."""
    from . import jpeg2000 as j2k
    img = j2k.decode_jpeg2000(data)
    palette = None
    if data[:4] == j2k.J2K_SIGNATURE:
        mode = j2k._codestream_mode(data, 4)[1]
    else:
        _, mode, palette = j2k._pillow_jp2_mode(data)
    H, W = img.shape[:2]
    opaque = np.full((H, W), 255, np.uint8)
    if mode == "RGBA":
        return img
    if mode == "RGB":
        return np.dstack([img, opaque])
    if mode == "L":
        return np.dstack([img, img, img, opaque])
    if mode == "LA":
        g, a = img[..., 0], img[..., 1]
        return np.dstack([g, g, g, a])
    if mode == "I;16":
        g = np.minimum(img, 255).astype(np.uint8)
        return np.dstack([g, g, g, opaque])
    if mode == "CMYK":
        nk = 255 - img[..., 3:].astype(np.int32)
        t = img[..., :3].astype(np.int32) * nk + 128
        rgb = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
        return np.dstack([rgb, opaque])
    core = _core_palette(palette)
    if mode == "P":
        return core[img]
    return np.dstack([core[img[..., 0]][..., :3], img[..., 1]])


def _rgb_entry(data: bytes, start: int, length: int, px: tuple):
    """IcnsImagePlugin.read_32: ([H, W, 3], the pad byte of its core)."""
    W, H = px
    n = W * H
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError("ICNS RGB entry cut short (not enough image "
                             "data)")
        return np.frombuffer(raw, np.uint8).reshape(H, W, 3), 255
    bands = imgdec.icns_rle(data, start, n)
    return np.ascontiguousarray(bands.reshape(3, H, W).transpose(1, 2, 0)), 0


def decode_icns(data: bytes) -> np.ndarray:
    if not accepts_icns(data):
        raise imgdec.NotThisFormat("not an icns file")
    blocks = _toc(data)
    sizes = [size for size, entries in SIZES.items()
             if any(code in blocks for code, _ in entries)]
    if not sizes:
        raise imgdec.NotThisFormat("No 32bit icon resources found")
    best = max(sizes)
    px = (best[0] * best[2], best[1] * best[2])
    rgba = rgb = alpha = None
    for code, kind in SIZES[best]:
        if code not in blocks:
            continue
        start, length = blocks[code]
        if kind == _PNG:
            sig = data[start:start + 12]
            if sig.startswith(_PNG_SIG):
                rgba = _png_entry(data, start)
            elif sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
                                ) or sig == _JP2_SIG:
                stream = data[start:] if length < 0 else data[
                    start:start + length]
                rgba = _j2k_entry(stream), False
            else:
                raise ValueError("Unsupported icon subimage format")
        elif kind == _MASK:
            mask = data[start:start + px[0] * px[1]]
            if len(mask) < px[0] * px[1]:
                raise ValueError("ICNS mask cut short (not enough image "
                                 "data)")
            alpha = np.frombuffer(mask, np.uint8).reshape(px[1], px[0])
        else:
            if kind == _RGB_T:
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError("Unknown signature, expecting "
                                     "0x00000000")
                start, length = start + 4, length - 4
            rgb = _rgb_entry(data, start, length, px)
    if rgba is not None:
        img, scrambled = rgba
        pad = 255
    elif rgb is None:
        raise ValueError("ICNS slot with a mask and no RGB entry (Pillow: "
                         "KeyError 'RGB')")
    elif alpha is not None:
        img, scrambled = np.dstack([rgb[0], alpha]), False
    else:
        (img, pad), scrambled = rgb, True
    H, W = img.shape[:2]
    imgdec.check_size(W, H, "ICNS entry")
    if not any(s[1] * s[2] / H == s[0] * s[2] // W for s in sizes):
        raise ValueError(f"ICNS entry of {W}x{H}: not one of the allowed "
                         f"sizes of this image (Pillow)")
    return np.ascontiguousarray(_rgba_packed(img, pad) if scrambled else img)
