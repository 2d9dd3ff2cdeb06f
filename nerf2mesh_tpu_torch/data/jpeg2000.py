"""A JPEG 2000 reader without Pillow: ``np.asarray(Image.open(path))`` of a
JP2 file or a raw codestream (.j2k, .j2c, .jpc), as Pillow 12.1's
Jpeg2KImagePlugin and its OpenJPEG 2.5.4 decoder read it.

Three layers, each Pillow's or OpenJPEG's rule:

* the mode and size, from Pillow's plugin: a codestream's SIZ gives "L"
  (one component of at most 8 bits), "I;16" (one of more), "LA", "RGB" or
  "RGBA" by component count; a JP2 file's ``ihdr`` gives the same from its
  own fields (one component is "I;16" only above 9 bits there), a ``colr``
  of enumerated space 12 makes four components "CMYK", and a ``pclr`` box
  of entries of at most 8 bits makes "L" "P" and "LA" "PA";
* the colour space, from OpenJPEG's JP2 reader: ``colr`` enumerated 16
  sRGB, 17 grey, 18 sYCC, 24 e-sYCC, 12 CMYK; anything else (another
  enumerated space, an ICC profile, no ``colr``) and a raw codestream are
  unspecified, which Pillow takes as grey for one or two components and
  sRGB for three or four.  OpenJPEG's tile decoding, which Pillow calls, applies no
  ``pclr``, ``cmap`` or ``cdef`` box: a palette image reads as its
  indices;
* the samples: ``native/j2kdec.cpp`` decodes the codestream (the jp2c
  box's payload) to int32 planes after the DC shift and clamp; each is
  then kept to 1, 2 or 4 bytes by its precision, as OpenJPEG hands tiles
  over, and unpacked as Pillow's Jpeg2KDecode.c does: the unpacker chosen
  by (mode, colour space, component count), its shift to 8 bits (16 for
  "I;16"), the offset 2^(prec-1) that makes signed samples unsigned, and
  for sYCC Pillow's fixed-point YCbCr -> RGB (ConvertYCbCr.c's tables).

What Pillow or OpenJPEG refuses raises ValueError; a codestream feature
that Pillow's writer cannot make (and so no test can hold to Pillow)
raises NotImplementedError naming ROADMAP A6 (j) 1.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import imgdec

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

_I64, _PTR = ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "j2k_info": (_I64, [_PTR, _I64, _PTR, _I64, _PTR, _I64]),
    "j2k_decode": (_I64, [_PTR, _I64, _PTR, _PTR, _I64]),
}

# OpenJPEG's colour spaces; a JP2 file's other enumerated spaces, an ICC
# profile or no colr box read as a raw codestream's, unspecified
UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}

# Pillow's Jpeg2KDecode.c j2k_unpackers: (mode, colour space, components)
# -> unpacker
_UNPACKERS = {
    ("L", GRAY, 1): "gray", ("P", SRGB, 1): "gray", ("PA", SRGB, 2): "graya",
    ("I;16", GRAY, 1): "gray_i", ("LA", GRAY, 2): "graya",
    ("RGB", GRAY, 1): "gray_rgb", ("RGB", GRAY, 2): "gray_rgb",
    ("RGB", SRGB, 3): "srgb", ("RGB", SYCC, 3): "sycc",
    ("RGB", SRGB, 4): "srgb", ("RGB", SYCC, 4): "sycc",
    ("RGBA", GRAY, 1): "gray_rgb", ("RGBA", GRAY, 2): "graya",
    ("RGBA", SRGB, 3): "srgb", ("RGBA", SYCC, 3): "sycc",
    ("RGBA", SRGB, 4): "srgba", ("RGBA", SYCC, 4): "sycca",
    ("RGBA", GRAY, 4): "srgba",
    ("CMYK", CMYK, 4): "srgba",
}


def _lib():
    from ..utils.native import load_library
    return load_library("j2kdec", _SIGNATURES)


def _raise(code: int, err: ctypes.Array) -> None:
    msg = err.value.decode(errors="replace")
    if code == -2:
        raise NotImplementedError(msg)
    raise ValueError(msg)


def decode_codestream(cs: bytes):
    """((X0, Y0, X1, Y1), per component [prec, signed, dx, dy], the decoded
    int32 planes [ncomp, Y1 - Y0, X1 - X0]) of a codestream of at most four
    components (Pillow's decoder refuses more)."""
    lib = _lib()
    src = np.frombuffer(cs, np.uint8)
    err = ctypes.create_string_buffer(512)
    info = np.zeros(5 + 4 * 4, np.int64)
    nc = lib.j2k_info(src.ctypes.data, src.size, info.ctypes.data, info.size,
                      err, len(err))
    if nc < 0:
        _raise(nc, err)
    if nc > 4:
        raise ValueError(f"JPEG 2000 codestream of {nc} components (Pillow "
                         f"decodes 1-4)")
    x0, y0, x1, y1 = (int(v) for v in info[:4])
    comps = info[5:5 + 4 * nc].reshape(nc, 4)
    imgdec.check_size(x1 - x0, y1 - y0, "JPEG 2000")
    planes = np.zeros((nc, y1 - y0, x1 - x0), np.int32)
    code = lib.j2k_decode(src.ctypes.data, src.size, planes.ctypes.data, err,
                          len(err))
    if code < 0:
        _raise(code, err)
    return (x0, y0, x1, y1), comps, planes


# ------------------------------------------------------------ Pillow's mode
def _codestream_mode(data: bytes, pos: int):
    """Jpeg2KImagePlugin._parse_codestream: (size, mode) from SIZ at pos
    (just after the SIZ marker)."""
    try:
        (lsiz,) = struct.unpack_from(">H", data, pos)
        siz = data[pos:pos + lsiz]
        (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
         csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
        ssiz = siz[38] if csiz == 1 else 0
    except (struct.error, IndexError) as e:
        raise ValueError(f"JPEG 2000 SIZ marker segment truncated: {e}")
    mode = {1: "I;16" if (ssiz & 0x7F) + 1 > 8 else "L", 2: "LA", 3: "RGB",
            4: "RGBA"}.get(csiz)
    if mode is None:
        raise ValueError("unable to determine J2K image mode (Pillow reads "
                         f"1-4 components, not {csiz})")
    return (xsiz - xosiz, ysiz - yosiz), mode


def _boxes(data: bytes, pos: int, end: int, pillow: bool):
    """(type, payload start, payload end) of the boxes in data[pos:end]; a
    box of length 0 runs to `end` (Pillow refuses it), and for OpenJPEG so
    does a jp2c box that claims more than there is."""
    while pos < end:
        if pos + 8 > end:
            raise ValueError("JPEG 2000 box header truncated")
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > end:
                raise ValueError("JPEG 2000 box header truncated")
            (lbox,) = struct.unpack_from(">Q", data, pos + 8)
            hlen = 16
        elif lbox == 0 and not pillow:
            lbox = end - pos
        if tbox == b"jp2c" and not pillow:   # OpenJPEG reads on to the end
            lbox = max(min(lbox, end - pos), hlen)
        if lbox < hlen or pos + lbox > end:
            raise ValueError("Invalid header length (JPEG 2000 box)")
        yield tbox, pos + hlen, pos + lbox
        pos += lbox


def pillow_palette(entries, npc: int) -> tuple:
    """The ImagePalette Jpeg2KImagePlugin builds from a pclr box's entries
    ([n] tuples of npc bytes) through ImagePalette.getcolor, one entry at a
    time: (its mode, "RGBA" for four components else "RGB", its bytes).
    getcolor keeps one slot a distinct colour and puts a new one at slot
    len(palette) // len(mode), so entries of one or two components (bytes
    of their own length in an RGB palette) overwrite each other's bytes;
    ValueError as getcolor raises it (a 257th slot, a non-opaque colour of
    four bytes in an RGB palette)."""
    mode = "RGBA" if npc == 4 else "RGB"
    n = len(mode)
    pal, colours = bytearray(), {}
    for colour in entries:
        colour = tuple(colour)
        if mode == "RGB" and len(colour) == 4:
            if colour[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB "
                                 "palette")
            colour = colour[:3]
        if colour in colours:
            continue
        index = len(pal) // n
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        colours[colour] = index
        if index * n < len(pal):
            pal = pal[:index * n] + bytes(colour) + pal[index * n + n:]
        else:
            pal += bytes(colour)
    return mode, bytes(pal)


def _pclr_entries(body: bytes):
    """(entries, components) of a pclr box Pillow builds a palette from,
    or None when an entry is deeper than 8 bits (the mode stays)."""
    ne, npc = struct.unpack_from(">HB", body)
    depths = struct.unpack_from(f">{npc}B", body, 3)
    if max(depths, default=0) > 8:
        return None
    flat = struct.unpack_from(f">{ne * npc}B", body, 3 + npc)
    return [flat[i * npc:(i + 1) * npc] for i in range(ne)], npc


def _pillow_jp2_mode(data: bytes):
    """Jpeg2KImagePlugin._parse_jp2_header: (size, mode, the palette:
    pillow_palette's pair for "P" and "PA", else None)."""
    header = None
    for tbox, b0, b1 in _boxes(data, 12, len(data), pillow=True):
        if tbox == b"jp2h":
            header = (b0, b1)
            break
    if header is None:
        raise ValueError("JPEG 2000 file without a jp2h box")
    size = mode = nc = palette = None
    for tbox, b0, b1 in _boxes(data, header[0], header[1], pillow=True):
        body = data[b0:b1]
        try:
            if tbox == b"ihdr":
                height, width, nc, bpc = struct.unpack_from(">IIHB", body)
                size = (width, height)
                mode = ("I;16" if nc == 1 and (bpc & 0x7F) > 8 else
                        {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode))
            elif tbox == b"colr" and nc == 4:
                meth, _, _, enumcs = struct.unpack_from(">BBBI", body)
                if meth == 1 and enumcs == 12:
                    mode = "CMYK"
            elif tbox == b"pclr" and mode in ("L", "LA"):
                pclr = _pclr_entries(body)
                if pclr is not None:
                    palette = pillow_palette(*pclr)
                    mode = "P" if mode == "L" else "PA"
        except struct.error as e:
            raise ValueError(f"Not enough data in JPEG 2000 header: {e}")
    if size is None or mode is None:
        raise ValueError("Malformed JP2 header")
    return size, mode, palette


def _openjpeg_jp2(data: bytes):
    """OpenJPEG's JP2 reading: (colour space, codestream)."""
    boxes = _boxes(data, 0, len(data), pillow=False)
    if next(boxes, (None,))[0] != b"jP  ":
        raise ValueError("JPEG 2000: the signature box must come first")
    if next(boxes, (None,))[0] != b"ftyp":
        raise ValueError("JPEG 2000: the ftyp box must be the second box")
    enumcs, has_colr, jp2h = 0, False, False
    for tbox, b0, b1 in boxes:
        if tbox == b"jp2c":
            if not jp2h:
                raise ValueError("JPEG 2000: jp2c box before jp2h")
            return _ENUMCS.get(enumcs, UNSPECIFIED), data[b0:b1]
        if tbox != b"jp2h":
            continue
        jp2h, has_ihdr = True, False
        for sub, s0, s1 in _boxes(data, b0, b1, pillow=False):
            body = data[s0:s1]
            if sub == b"ihdr":
                if len(body) != 14:
                    raise ValueError("JPEG 2000: bad ihdr box size")
                h, w, nc = struct.unpack_from(">IIH", body)
                if not (h and w and nc):
                    raise ValueError("JPEG 2000 ihdr: zero size or "
                                     "components")
                has_ihdr = True
            elif sub == b"colr" and not has_colr:
                if len(body) < 3:
                    raise ValueError("JPEG 2000: bad colr box size")
                if body[0] == 1:
                    if len(body) < 7:
                        raise ValueError("JPEG 2000: bad colr box size")
                    (enumcs,) = struct.unpack_from(">I", body, 3)
                    has_colr = True
                elif body[0] == 2:
                    has_colr = True          # an ICC profile: enumcs 0
        if not has_ihdr:
            raise ValueError("JPEG 2000: jp2h box without ihdr")
    raise ValueError("JPEG 2000 file without a codestream (jp2c) box")


# -------------------------------------------------------- Pillow's unpacking
def _sample(plane: np.ndarray, prec: int, sgnd: int, bits: int
            ) -> np.ndarray:
    """j2ku_shift(offset + word, shift) of Jpeg2KDecode.c on the word
    OpenJPEG hands over (1, 2 or 4 bytes by precision), kept to `bits`."""
    dtype = np.uint16 if bits == 16 else np.uint8
    if prec == bits:   # the decoder clamped the samples: no shift or wrap
        return (plane + (1 << (prec - 1)) if sgnd else plane).astype(dtype)
    csiz = (prec + 7) >> 3
    csiz = 4 if csiz == 3 else csiz
    word = plane.astype(np.int64) & ((1 << (8 * csiz)) - 1)
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (word + offset) & 0xFFFFFFFF
    x = (x >> -shift) if shift < 0 else ((x << shift) & 0xFFFFFFFF)
    return (x & ((1 << bits) - 1)).astype(dtype)


def _ycc_tables():
    """ConvertYCbCr.c's R_Cr, G_Cb, G_Cr and B_Cb: (int)(k * 64 * (i - 128)
    + 0.5) (SCALE 6)."""
    i = np.arange(256) - 128
    return [np.trunc(i * k * 64 + 0.5).astype(np.int32)
            for k in (1.40200, -0.34414, -0.71414, 1.77200)]


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB on uint8 [..., 3] planes."""
    rcr, gcb, gcr, bcb = _ycc_tables()
    y, cb, cr = (ycc[..., i].astype(np.int32) for i in range(3))
    r = y + (rcr[cr] >> 6)
    g = y + ((gcb[cb] + gcr[cr]) >> 6)
    b = y + (bcb[cb] >> 6)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _unpack(kind: str, mode: str, comps, planes) -> np.ndarray:
    def ch(i, bits=8):
        return _sample(planes[i], int(comps[i][0]), int(comps[i][1]), bits)

    if kind == "gray":
        return ch(0)
    if kind == "gray_i":
        return ch(0, 16)
    if kind == "graya":
        g, a = ch(0), ch(1)
        return np.stack([g, a] if mode in ("LA", "PA") else [g, g, g, a], -1)
    if kind == "gray_rgb":
        g = ch(0)
        out = [g, g, g] + ([np.full_like(g, 255)] if mode == "RGBA" else [])
        return np.stack(out, -1)
    n = 4 if kind in ("srgba", "sycca") else 3
    px = np.stack([ch(i) for i in range(n)], -1)
    if kind in ("sycc", "sycca"):
        px[..., :3] = ycbcr_to_rgb(px[..., :3])
    if mode == "RGBA" and n == 3:
        px = np.concatenate([px, np.full_like(px[..., :1], 255)], -1)
    return px


def decode_jpeg2000(data: bytes) -> np.ndarray:
    if data[:4] == J2K_SIGNATURE:
        size, mode = _codestream_mode(data, 4)
        space, cs = UNSPECIFIED, data
    elif data[:12] == JP2_SIGNATURE:
        size, mode, _ = _pillow_jp2_mode(data)
        space, cs = _openjpeg_jp2(data)
    else:
        raise ValueError("not a JPEG 2000 file")
    imgdec.check_size(size[0], size[1], "JPEG 2000")
    (x0, y0, x1, y1), comps, planes = decode_codestream(cs)
    nc = len(comps)
    if space == UNSPECIFIED:
        space = GRAY if nc <= 2 else SRGB
    kind = _UNPACKERS.get((mode, space, nc))
    if kind is None:
        raise ValueError(f"JPEG 2000 mode {mode} with {nc} components in "
                         f"colour space {space}: Pillow has no unpacker")
    if (x1 - x0, y1 - y0) != tuple(size):
        raise ValueError(f"JPEG 2000 codestream of {x1 - x0}x{y1 - y0} in a "
                         f"file whose header says {size[0]}x{size[1]} "
                         f"(Pillow reads none)")
    return np.ascontiguousarray(_unpack(kind, mode, comps, planes))
