"""A TIFF reader without Pillow or libtiff: the first page's array as
``np.asarray(Image.open(path))`` gives it, in Pillow's dtype and shape for
the mode TiffImagePlugin's OPEN_INFO chooses.

* either byte order; strips or tiles; samples contiguous or planar
  (PlanarConfiguration 2);
* compression none, PackBits, LZW (native/imgdec.cpp) and deflate (zlib),
  with or without horizontal predictor 2 on 8- and 16-bit samples;
* grey (min-is-black, or min-is-white, inverted as Pillow inverts it):
  1 bit -> mode "1", bool [H, W]; 2 and 4 bits -> "L", the sample times 85
  or 17; 8 bits -> uint8 [H, W]; 16 bits -> "I;16", uint16 [H, W] (its
  big-endian twin "I;16B", dtype >u2, for a big-endian min-is-black file);
  grey + unassociated alpha -> "LA";
* RGB: 8-bit -> uint8 [H, W, 3]; a fourth sample that is unassociated
  alpha (or unnamed) -> RGBA [H, W, 4]; further unnamed samples dropped;
  16-bit samples -> their high byte, as Pillow's "RGB;16L/B" unpack;
* palette, 1-8 bits -> "P": the indices, uint8 [H, W].

JPEG-compressed files, associated alpha, fill order 2, sample formats other
than unsigned integers and BigTIFF raise NotImplementedError naming ROADMAP
A6 (i); what Pillow refuses raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import imgdec

_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 7: "B"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 16: 8}


def _unsupported(what: str):
    return NotImplementedError(f"TIFF {what} is not read (ROADMAP A6 (i))")


def _ifd(data: bytes, bo: str, pos: int) -> dict:
    """{tag: tuple of its integer values} of the IFD at pos."""
    (n,) = struct.unpack_from(bo + "H", data, pos)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(bo + "HHI", data, pos + 2 + 12 * i)
        if typ not in _TYPES:
            continue
        size = _SIZES[typ] * count
        at = pos + 2 + 12 * i + 8
        if size > 4:
            (at,) = struct.unpack_from(bo + "I", data, at)
        tags[tag] = struct.unpack_from(f"{bo}{count}{_TYPES[typ]}", data, at)
    return tags


def decode_tiff(data: bytes) -> np.ndarray:
    bo = "<" if data[:2] == b"II" else ">"
    (magic,) = struct.unpack_from(bo + "H", data, 2)
    if magic == 43:
        raise _unsupported("BigTIFF")
    if magic != 42:
        raise ValueError("not a TIFF file")
    tags = _ifd(data, bo, struct.unpack_from(bo + "I", data, 4)[0])

    def one(tag, default=None):
        return tags[tag][0] if tag in tags else default

    W, H = one(256), one(257)
    spp = one(277, 1)
    bits = tags.get(258, (1,))
    if len(bits) == 1:
        bits = bits * spp
    comp, photo = one(259, 1), one(262)
    planar, pred = one(284, 1), one(317, 1)
    extra = tags.get(338, ())
    if photo is None:
        raise ValueError("TIFF without PhotometricInterpretation")
    if one(266, 1) != 1:
        raise _unsupported("fill order 2")
    if any(v != 1 for v in tags.get(339, (1,))):
        raise _unsupported(f"sample format {tags[339]}")
    if comp in (6, 7):
        raise _unsupported("JPEG compression")
    if comp not in (1, 5, 8, 32946, 32773):
        raise _unsupported(f"compression {comp}")
    if len(set(bits)) != 1:
        raise _unsupported(f"bits per sample {bits}")
    b = bits[0]
    if b not in (1, 2, 4, 8, 16) or (b < 8 and spp != 1):
        raise _unsupported(f"{b}-bit samples ({spp} a pixel)")
    if pred not in (1, 2) or (pred == 2 and b < 8):
        raise _unsupported(f"predictor {pred} at {b} bits")
    if 1 in extra[:1]:
        raise _unsupported("associated alpha")

    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp          # samples a pixel of a plane
    if 322 in tags:                          # tiles
        tw, th = one(322), one(323)
        offs, counts = tags[324], tags[325]
        across, down = -(-W // tw), -(-H // th)
    else:
        tw, th = W, min(one(278, 2 ** 32 - 1), H)
        offs, counts = tags[273], tags.get(279)
        across, down = 1, -(-H // th)
        if counts is None:
            raise ValueError("TIFF strips without StripByteCounts")
    if len(offs) < across * down * planes:
        raise ValueError("TIFF: fewer strips or tiles than the image needs")
    row_bytes = (tw * b * per + 7) // 8
    dt = np.dtype(bo + "u2") if b == 16 else np.dtype(np.uint8)
    img = np.zeros((planes, down * th, across * tw, per), dt)
    k = 0
    for p in range(planes):
        for ty in range(down):
            rows = th if 322 in tags else min(th, H - ty * th)
            for tx in range(across):
                raw = data[offs[k]:offs[k] + counts[k]]
                k += 1
                buf = _decompress(raw, comp, rows * row_bytes)
                if pred == 2:
                    imgdec.unpredict(buf, rows, tw, per, b // 8, bo == ">")
                tile = (buf.view(dt).reshape(rows, tw, per) if b >= 8 else
                        _unpack(buf.reshape(rows, row_bytes), b, tw)[..., None])
                img[p, ty * th:ty * th + rows, tx * tw:(tx + 1) * tw] = tile
    img = img[:, :H, :W]
    samples = img[0] if planes == 1 else np.concatenate(list(img), axis=-1)
    return _pillow_mode(samples, photo, b, spp, extra, bo)


def _decompress(raw: bytes, comp: int, size: int) -> np.ndarray:
    if comp == 1:
        out = np.frombuffer(raw, np.uint8)[:size]
    elif comp == 5:
        out = imgdec.lzw_tiff(raw, size)
    elif comp == 32773:
        out = imgdec.packbits(raw, size)
    else:
        out = np.frombuffer(zlib.decompressobj().decompress(raw, size),
                            np.uint8)
    if out.size < size:
        raise ValueError(f"TIFF strip or tile of {out.size} bytes, not "
                         f"{size}")
    return np.array(out, np.uint8)


def _unpack(rows: np.ndarray, b: int, w: int) -> np.ndarray:
    shifts = np.arange(8 - b, -1, -b, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << b) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w]


def _pillow_mode(s: np.ndarray, photo: int, b: int, spp: int, extra,
                 bo: str) -> np.ndarray:
    """[H, W, spp] samples -> the array of Pillow's mode."""
    if photo in (0, 1) and spp == 1:
        g = s[..., 0]
        if b == 1:
            return (g == 0) if photo == 0 else g.astype(bool)
        if b == 16:
            if bo == ">" and photo == 0:
                raise ValueError("big-endian min-is-white 16-bit TIFF "
                                 "(Pillow reads none)")
            return np.ascontiguousarray(g)   # Pillow does not invert these
        if b < 8:
            g = g * (255 // ((1 << b) - 1))
        g = g.astype(np.uint8)
        return (255 - g) if photo == 0 else g
    if photo == 1 and spp == 2 and b == 8 and tuple(extra) == (2,):
        return np.ascontiguousarray(s)
    if photo == 2 and spp >= 3:
        alpha = spp >= 4 and (not extra or extra[0] in (2, 999))
        if spp > 4 and not extra:
            raise ValueError(f"TIFF RGB with {spp} samples and no "
                             "ExtraSamples (Pillow reads none)")
        s = s[..., :4 if alpha else 3]
        if b == 16:
            s = (s.astype(np.uint16) >> 8).astype(np.uint8)
        return np.ascontiguousarray(s)
    if photo == 3 and spp == 1 and b <= 8:
        return np.ascontiguousarray(s[..., 0].astype(np.uint8))
    raise _unsupported(f"photometric {photo} with {spp} samples of {b} bits")
