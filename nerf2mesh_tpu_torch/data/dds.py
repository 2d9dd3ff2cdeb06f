"""A DDS reader without Pillow: the array ``np.asarray(Image.open(path))``
gives for the files Pillow 12.1.0's DdsImagePlugin reads, in its dtype and
shape.

* the first surface only (mipmaps, depth slices and cube faces after it
  are ignored); blocks at the right and bottom edges are cropped;
* ``DDPF_RGB`` (any bit count and masks): each mask's field scaled to 8
  bits as int(field / (mask >> shift) * 255), "RGBA" with
  ``DDPF_ALPHAPIXELS`` (four masks) else "RGB"; a pixel past the data's
  end reads as zeros, as the plugin's file reads give it;
* luminance: 8 bits "L", 16 bits with alpha "LA"; ``PALETTEINDEXED8``:
  mode "P" after its 1024-byte RGBA palette (the indices, as
  ``np.asarray`` of a "P" image);
* FourCC DXT1, DXT3, DXT5 (RGBA), ATI1/BC4U (L), ATI2/BC5U and BC5S
  (RGB), and DX10 BC1-BC5 (typeless, unorm; BC5 snorm), BC6H_UF16 and
  _SF16 (RGB), BC7 (typeless, unorm, sRGB: RGBA as stored) and R8G8B8A8
  (typeless, unorm, sRGB) through native/bcndec.cpp, Pillow's BcnDecode.c
  arithmetic.

Uncompressed pixels are read from where the plugin's header reads stop
(its tiles say offset 0, but its ``load_seek`` ignores them): right after
the 128-byte header, the palette or the DX10 header.  What Pillow refuses
(a header size other than 124, a short header, other pixel format flags,
FourCCs and DXGI formats, luminance at other bit counts, data that ends
before the surface) raises ValueError; a header Image.open passes over
raises imgdec.NotThisFormat.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import imgdec

_I64, _PTR, _INT = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bcn_decode": (_I64, [_PTR, _I64, _INT, _INT, _I64, _I64, _PTR]),
    "blp_dxt": (_I64, [_PTR, _I64, _INT, _INT, _I64, _I64, _PTR]),
    "dds_rgb": (None, [_PTR, _I64, _I64, _PTR, _INT, _I64, _PTR]),
    "bc6h_layout": (_INT, [_INT, _PTR]),
}

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8 = 0x1, 0x4, 0x20
DDPF_RGB, DDPF_LUMINANCE = 0x40, 0x20000
# FourCC -> (BcnDecode's n, signed)
_FOURCC = {b"DXT1": (1, False), b"DXT3": (2, False), b"DXT5": (3, False),
           b"BC4U": (4, False), b"ATI1": (4, False), b"BC5S": (5, True),
           b"BC5U": (5, False), b"ATI2": (5, False)}
# DXGI format -> (n, signed); 0 for R8G8B8A8, read raw
_DXGI = {70: (1, False), 71: (1, False), 73: (2, False), 74: (2, False),
         76: (3, False), 77: (3, False), 79: (4, False), 80: (4, False),
         82: (5, False), 83: (5, False), 84: (5, True), 95: (6, False),
         96: (6, True), 97: (7, False), 98: (7, False), 99: (7, False),
         27: (0, False), 28: (0, False), 29: (0, False)}
# BcnDecode's n -> channels
CHANNELS = {1: 4, 2: 4, 3: 4, 4: 1, 5: 3, 6: 3, 7: 4}
CODEC_NAMES = {1: "bc1", 2: "bc2", 3: "bc3", 4: "bc4", 5: "bc5", 6: "bc6h",
               7: "bc7"}


def _lib():
    from ..utils.native import load_library
    return load_library("bcndec", _SIGNATURES)


def bcn(data: bytes, offset: int, codec: int, sign: bool, width: int,
        height: int) -> np.ndarray:
    """A surface of BcnDecode.c's `codec` (1-7) blocks from data[offset:],
    cropped to height x width: [H, W, C] uint8 ([H, W] for BC4)."""
    src = np.frombuffer(data, np.uint8, offset=min(offset, len(data)))
    src = np.ascontiguousarray(src)
    C = CHANNELS[codec]
    out = np.empty((height, width, C), np.uint8)
    if _lib().bcn_decode(src.ctypes.data, src.size, codec, int(sign), width,
                         height, out.ctypes.data) < 0:
        raise ValueError("block-compressed data truncated (image file is "
                         "truncated)")
    return out[..., 0] if C == 1 else out


def blp_dxt(blocks: bytes, kind: int, alpha: bool, bw: int,
            bh: int) -> np.ndarray:
    """BLP2's Python decode_dxt1 (kind 1), decode_dxt3 (3) or decode_dxt5
    (5) of bh rows of bw blocks: their concatenated rows, [4 bh * 4 bw *
    C] uint8 (C 3 for DXT1 without alpha, else 4)."""
    src = np.ascontiguousarray(np.frombuffer(blocks, np.uint8))
    C = 3 if kind == 1 and not alpha else 4
    out = np.empty(bh * bw * 16 * C, np.uint8)
    if _lib().blp_dxt(src.ctypes.data, src.size, kind, int(alpha), bw, bh,
                      out.ctypes.data) < 0:
        raise ValueError("BLP: DXT data truncated")
    return out


def bc6h_layout(mode: int) -> list:
    """The endpoint bits of BC6H `mode` (BcnDecode's numbering, 0-13) in
    block order after the mode bits: [(endpoint word, bit), ...]."""
    buf = np.zeros(75, np.uint8)
    n = _lib().bc6h_layout(mode, buf.ctypes.data)
    if n < 0:
        raise ValueError(f"BC6H mode {mode}")
    return [(int(b) >> 4, int(b) & 15) for b in buf[:n]]


def rgb_masks(data: bytes, offset: int, bitcount: int, masks: tuple,
              width: int, height: int) -> np.ndarray:
    """DdsRgbDecoder: [H, W, len(masks)] from data[offset:]."""
    src = np.ascontiguousarray(np.frombuffer(data, np.uint8,
                                             offset=min(offset, len(data))))
    m = np.array(masks, np.uint32)
    out = np.empty((height, width, len(masks)), np.uint8)
    _lib().dds_rgb(src.ctypes.data, src.size, bitcount // 8, m.ctypes.data,
                   len(masks), width * height, out.ctypes.data)
    return out


def raw(data: bytes, offset: int, shape: tuple) -> np.ndarray:
    """Pillow's raw decoder of 8-bit samples from data[offset:]."""
    n = int(np.prod(shape))
    if len(data) - offset < n:
        raise ValueError("image file is truncated")
    return np.frombuffer(data, np.uint8, n, offset).reshape(shape).copy()


RGB_MASKS = -1         # pixel_format's codec for DDPF_RGB's masked pixels


def pixel_format(data: bytes) -> tuple:
    """(codec: BcnDecode's n, RGB_MASKS, or 0 for raw bytes; signed; the
    pixel data's offset; Pillow's mode) of a DDS header as DdsImageFile._open
    reads it; raises as it refuses."""
    if len(data) < 8:
        raise imgdec.NotThisFormat("DDS header truncated")
    (hsize,) = struct.unpack_from("<I", data, 4)
    if hsize != 124:
        raise ValueError(f"DDS header size {hsize} (Pillow reads 124)")
    if len(data) < 128:
        raise ValueError(f"DDS header of {len(data) - 8} bytes (incomplete)")
    pfflags, fourcc = struct.unpack_from("<I4s", data, 80)
    (bitcount,) = struct.unpack_from("<I", data, 88)
    if pfflags & DDPF_RGB:
        return (RGB_MASKS, False, 128,
                "RGBA" if pfflags & DDPF_ALPHAPIXELS else "RGB")
    if pfflags & DDPF_LUMINANCE:
        if bitcount == 8:
            return 0, False, 128, "L"
        if bitcount == 16 and pfflags & DDPF_ALPHAPIXELS:
            return 0, False, 128, "LA"
        raise ValueError(f"DDS luminance of {bitcount} bits (flags "
                         f"{pfflags:#x}): Pillow reads none")
    if pfflags & DDPF_PALETTEINDEXED8:
        return 0, False, min(128 + 1024, len(data)), "P"
    if pfflags & DDPF_FOURCC:
        if fourcc in _FOURCC:
            n, sign = _FOURCC[fourcc]
            return n, sign, 128, {4: "L", 5: "RGB"}.get(n, "RGBA")
        if fourcc != b"DX10":
            raise ValueError(f"DDS pixel format {fourcc!r} (Pillow reads "
                             "none)")
        if len(data) < 132:
            raise imgdec.NotThisFormat("DX10 header truncated")
        (dxgi,) = struct.unpack_from("<I", data, 128)
        if dxgi not in _DXGI:
            raise ValueError(f"DDS DXGI format {dxgi} (Pillow reads none)")
        n, sign = _DXGI[dxgi]
        offset = min(148, len(data))
        return n, sign, offset, {0: "RGBA", 4: "L", 5: "RGB",
                                 6: "RGB"}.get(n, "RGBA")
    raise ValueError(f"DDS pixel format flags {pfflags:#x} (Pillow reads "
                     "none)")


def decode_dds(data: bytes) -> np.ndarray:
    if data[:4] != b"DDS ":
        raise ValueError("not a DDS file")
    n, sign, offset, mode = pixel_format(data)
    height, width = struct.unpack_from("<2I", data, 12)
    if width == 0 or height == 0:
        raise imgdec.NotThisFormat("DDS of no pixels")
    imgdec.check_size(width, height, "DDS")
    if n == RGB_MASKS:
        masks = struct.unpack_from(f"<{len(mode)}I", data, 92)
        (bitcount,) = struct.unpack_from("<I", data, 88)
        return rgb_masks(data, offset, bitcount, masks, width, height)
    if n:
        return bcn(data, offset, n, sign, width, height)
    bands = {"L": (), "P": (), "LA": (2,), "RGBA": (4,)}[mode]
    return raw(data, offset, (height, width) + bands)
