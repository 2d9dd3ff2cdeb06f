"""A TIFF reader without Pillow or libtiff: the first page's array as
``np.asarray(Image.open(path))`` gives it, in Pillow's dtype and shape for
the mode TiffImagePlugin's OPEN_INFO chooses.

* either byte order, classic TIFF or little-endian BigTIFF (version 43,
  8-byte offsets and counts, LONG8 / SLONG8 / IFD8 fields; Pillow's reader
  takes a big-endian one for a classic file and refuses it); strips or
  tiles; samples contiguous or planar (PlanarConfiguration 2);
* compression none, PackBits, LZW (native/imgdec.cpp), deflate (zlib),
  LZMA (the standard library's lzma, .xz streams as libtiff's liblzma
  reads them) and zstd (utils/zstd.py), with horizontal predictor 2 or
  floating-point predictor 3; new-style JPEG (7): each strip or tile an
  abbreviated JPEG stream decoded after the JPEGTables stream by
  data/jpeg.py's decoder, YCbCr converted to RGB (libtiff's
  JPEGCOLORMODE_RGB, which Pillow asks for), grey and RGB as stored;
* CCITT (native/imgdec.cpp, tif_fax3.c's decoder): modified Huffman (2),
  RLEW (32771, rows on 16-bit words), Group 3 (3) 1-D or, by T4Options
  bit 0, 2-D, with or without fill bits, and Group 4 (4), 1-bit only;
  black runs come out as 1 bits and photometric 0 or 1 maps them as for
  uncompressed data; a damaged row is repaired as libtiff repairs it, and
  a Group 4 strip that ends early keeps its decoded rows (the rest, which
  Pillow leaves as whatever its buffer held, come out white here);
* ThunderScan (32809), 4 bits only: "L", each sample times 17;
* old-style JPEG (6), as libtiff's tif_ojpeg.c feeds libjpeg (``_old_jpeg``):
  a JPEG stream at JPEGInterchangeFormat, or tables in JPEGQTables,
  JPEGDCTables and JPEGACTables with bare scans in the strips or tiles;
  three samples are YCbCr converted by libtiff's RGBA interface, one is
  grey as stored;
* fill order 2: each stored byte's bits reversed before decompression
  (not for JPEG, whose codec libtiff exempts), in the modes Pillow keeps a
  fill-order-2 entry for;
* grey (min-is-black, or min-is-white, inverted as Pillow inverts it):
  1 bit -> mode "1", bool [H, W]; 2 and 4 bits -> "L", the sample times 85
  or 17; 8 bits -> uint8 [H, W]; 12 bits -> "I;16" uint16; 16 bits ->
  "I;16", uint16 [H, W] (its big-endian twin "I;16B", dtype >u2, for a
  big-endian min-is-black file); grey + unassociated alpha -> "LA";
  SampleFormat 2 (signed) 8 bits -> "L", the bytes as stored; 16 and 32
  bits -> "I", int32; SampleFormat 3 (IEEE) 32 bits -> "F", float32;
  unsigned 32 bits (little-endian) -> "I", the bits as int32.  A
  big-endian signed or float file that libtiff decompresses comes out
  byte-swapped, as Pillow reads it (libtiff hands it the samples in native
  order, and Pillow unpacks them as big-endian);
* RGB: 8-bit -> uint8 [H, W, 3]; a fourth sample that is unassociated
  alpha (or unnamed) -> RGBA [H, W, 4]; associated alpha (ExtraSamples 1)
  -> RGBA unpremultiplied as Pillow's "RGBa" unpacker does it (c * 255 //
  a, 0 where a is 0); further samples dropped; 16-bit samples -> their
  high byte, as Pillow's "RGB;16L/B" unpack;
* YCbCr (photometric 6) of three 8-bit samples under LZW, deflate,
  PackBits, LZMA or zstd at the subsamplings libtiff's RGBA interface
  reads (1x1, 1x2, 2x1, 2x2, 4x1, 4x2, 4x4 contiguous, 1x1 in planes),
  predictor 2 as libtiff applies it to data units: through libtiff's
  TIFFYCbCrtoRGB tables in float32, as Pillow reads it, chroma replicated
  over each unit; uncompressed YCbCr as Pillow's raw decoder reads it: 4
  bytes a pixel from each strip's offset, or each plane's bytes as R, G
  and B, unconverted;
* CMYK (8 bits, or 16 -> their high byte) and CIELab as stored;
* palette, 1-8 bits -> "P": the indices, uint8 [H, W]; with alpha ->
  "PA" [H, W, 2].

What Pillow refuses raises ValueError: compressions outside its
COMPRESSION_INFO, SGILog and WebP, CCITT or ThunderScan at other depths,
the YCbCr forms libtiff's RGBA interface has no reader for, and so on.
Old-style JPEG in planes is not read (ROADMAP A6 (j) 3): ValueError too.
"""

from __future__ import annotations

import functools
import lzma
import struct
import zlib

import numpy as np

from . import imgdec

_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 17: "q",
          18: "Q", 7: "B", 13: "I", 11: "f", 12: "d"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
# the modes with a fill-order-2 entry in Pillow's OPEN_INFO: (photometric,
# bits per sample); 16-bit grey only little-endian
_FILL_ORDER_2 = {(0, (1,)), (1, (1,)), (0, (2,)), (1, (2,)), (0, (4,)),
                 (1, (4,)), (0, (8,)), (1, (8,)), (1, (16,)), (2, (8, 8, 8)),
                 (3, (1,)), (3, (2,)), (3, (4,)), (3, (8,))}
# Pillow's COMPRESSION_INFO, less SGILog (34676, 34677: no mode for its
# photometric 32844/32845) and WebP (50001: its libtiff has no WebP codec)
_COMPRESSIONS = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34925,
                 50000}
_REFUSED_COMPRESSIONS = {34676: "SGILog", 34677: "SGILog24",
                         50001: "WebP"}
# the YCbCrSubsampling values libtiff's RGBA interface reads: any of these
# contiguous (putcontig8bitYCbCr*tile), 1x1 in planes
_YCBCR_CONTIG = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}
# CCITT compressions -> imgdec.fax's mode (Group 3 by T4Options bit 0)
_FAX = {2: imgdec.FAX_MH, 32771: imgdec.FAX_MH_WORD, 3: imgdec.FAX_G3_1D,
        4: imgdec.FAX_G4}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                     np.uint8)


def _refused(what: str):
    return ValueError(f"TIFF {what} (Pillow reads none)")


def _ifd(data: bytes, bo: str, pos: int, big: bool) -> dict:
    """{tag: tuple of its values} of the IFD at pos (rationals as floats)."""
    count_fmt, entry, inline = ("Q", 20, 8) if big else ("H", 12, 4)
    (n,) = struct.unpack_from(bo + count_fmt, data, pos)
    pos += struct.calcsize(count_fmt)
    tags = {}
    for i in range(n):
        at = pos + entry * i
        tag, typ = struct.unpack_from(bo + "HH", data, at)
        (count,) = struct.unpack_from(bo + ("Q" if big else "I"), data, at + 4)
        if typ not in _SIZES or typ == 2:
            continue
        size = _SIZES[typ] * count
        at += 12 if big else 8
        if size > inline:
            (at,) = struct.unpack_from(bo + ("Q" if big else "I"), data, at)
        if typ in (5, 10):
            v = struct.unpack_from(f"{bo}{2 * count}{'I' if typ == 5 else 'i'}",
                                   data, at)
            tags[tag] = tuple(a / b if b else 0.0 for a, b in
                              zip(v[::2], v[1::2]))
        else:
            tags[tag] = struct.unpack_from(f"{bo}{count}{_TYPES[typ]}", data,
                                           at)
    return tags


def decode_tiff(data: bytes) -> np.ndarray:
    try:
        return _decode(data)
    except (struct.error, zlib.error, lzma.LZMAError, KeyError, IndexError,
            TypeError) as e:
        raise ValueError(f"corrupt TIFF ({type(e).__name__}: {e})") from e


def _decode(data: bytes) -> np.ndarray:
    head = data[:4]
    if head in (b"II*\0", b"MM\0*"):
        big = False
    elif head == b"II+\0":
        big = True
    elif head == b"MM\0+":
        raise _refused("big-endian BigTIFF (its reader takes the header's "
                       "third byte for the version)")
    else:
        raise ValueError("not a TIFF file")
    bo = "<" if head[:2] == b"II" else ">"
    if big:
        if struct.unpack_from(bo + "HH", data, 4) != (8, 0):
            raise ValueError("BigTIFF with offsets of other than 8 bytes")
        (first,) = struct.unpack_from(bo + "Q", data, 8)
    else:
        (first,) = struct.unpack_from(bo + "I", data, 4)
    tags = _ifd(data, bo, first, big)

    def one(tag, default=None):
        return tags[tag][0] if tag in tags else default

    W, H = one(256), one(257)
    imgdec.check_size(W, H, "TIFF")
    spp = one(277, 1)
    bits = tags.get(258, (1,))
    if len(bits) == 1:
        bits = bits * spp
    comp, photo = one(259, 1), one(262)
    planar, pred = one(284, 1), one(317, 1)
    extra = tags.get(338, ())
    fill = one(266, 1)
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    if comp == 6:
        # Pillow takes photometric 6 for any old-style JPEG file
        if (fill != 1 or fmt != (1,) or extra or spp not in (1, 3)
                or bits != (8,) * spp):
            raise _refused(f"old-style JPEG of {bits}-bit samples, fill "
                           f"order {fill}, extra samples {extra}")
        return _old_jpeg(data, tags, W, H, spp, photo)
    if photo is None:
        raise ValueError("TIFF without PhotometricInterpretation")
    if comp in _REFUSED_COMPRESSIONS:
        raise _refused(f"{_REFUSED_COMPRESSIONS[comp]} compression ({comp})")
    if comp not in _COMPRESSIONS:
        raise _refused(f"compression {comp}")
    fax = _FAX.get(comp)
    if fax == imgdec.FAX_G3_1D and one(292, 0) & 1:
        fax = imgdec.FAX_G3_2D
    if fax is not None and (bits != (1,) or spp != 1):
        raise _refused(f"CCITT compression of {bits}-bit samples (libtiff's "
                       "fax codec takes 1 bit)")
    if comp == 32809 and bits != (4,):
        raise _refused(f"ThunderScan compression of {bits}-bit samples "
                       "(libtiff's codec takes 4 bits)")
    if len(set(bits)) != 1:
        raise _refused(f"bits per sample {bits}")
    b = bits[0]
    if b not in (1, 2, 4, 8, 12, 16, 32) or (b < 8 and spp != 1) or (
            b in (12, 32) and spp != 1):
        raise _refused(f"{b}-bit samples ({spp} a pixel)")
    if b == 12 and (photo != 1 or bo == ">" or fmt != (1,)):
        raise _refused(f"12-bit samples, photometric {photo}")
    if pred not in (1, 2, 3) or (pred == 2 and b < 8) or (
            pred == 3 and (b != 32 or fmt != (3,))):
        raise _refused(f"predictor {pred} at {b} bits")
    if fill == 2 and ((photo, tuple(bits)) not in _FILL_ORDER_2 or extra
                      or fmt != (1,)
                      or (b == 16 and bo == ">")
                      or (comp == 1 and photo == 0 and b == 8)):
        raise _refused(f"with fill order 2, photometric {photo} and {bits} "
                       "bits")
    if fmt != (1,) and fmt not in ((2,), (3,)):
        raise _refused(f"sample format {fmt}")
    if tuple(extra[:1]) == (1,) and not (photo == 2 and spp >= 4
                                         and b in (8, 16)):
        raise _refused(f"photometric {photo} with associated alpha")
    if photo == 6 and comp != 1 and (b != 8 or spp != 3):
        raise _refused(f"YCbCr of {spp} samples of {b} bits (libtiff's RGBA "
                       "interface converts 3 of 8)")
    if comp == 7 and b != 8:
        raise _refused(f"JPEG with {b}-bit samples")

    if photo == 6 and comp == 1:
        return _raw_ycbcr(data, tags, W, H)
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
    sub = tuple(tags.get(530, (2, 2))) if photo == 6 and comp != 7 else (1, 1)
    if sub not in _YCBCR_CONTIG or (planar == 2 and sub != (1, 1)):
        raise _refused(f"YCbCr subsampling {sub}"
                       + (" in planes" if planar == 2 else "")
                       + " (libtiff's RGBA interface has no reader for it)")
    if comp == 7:
        row_bytes = tw * per
        tables = bytes(tags.get(347, ()))
    elif sub != (1, 1):                      # data units of Y, Cb and Cr
        row_bytes = -(-tw // sub[0]) * (sub[0] * sub[1] + 2)
    else:
        row_bytes = (tw * b * per + 7) // 8
    dt = (np.dtype(bo + {16: "u2", 32: "u4"}[b]) if b in (16, 32) else
          np.dtype(np.uint16) if b == 12 else np.dtype(np.uint8))
    img = np.zeros((planes, down * th, across * tw, per), dt)
    k = 0
    for p in range(planes):
        for ty in range(down):
            rows = th if 322 in tags else min(th, H - ty * th)
            for tx in range(across):
                raw = data[offs[k]:offs[k] + counts[k]]
                k += 1
                if comp == 7:
                    tile = _jpeg_tile(tables, raw, photo, rows, tw, per)
                else:
                    if fill == 2:
                        raw = _REVERSED[np.frombuffer(raw, np.uint8)]
                    units = -(-rows // sub[1])
                    buf = _decompress(raw, comp, units * row_bytes, fax, tw,
                                      rows)
                    if sub != (1, 1):
                        if pred == 2:
                            _unpredict_units(buf, row_bytes // sub[1])
                        tile = _ycbcr_units(buf, units, row_bytes, sub, rows,
                                            tw)
                    else:
                        if pred == 2:
                            _unpredict(buf, rows, tw, per, b, bo)
                        elif pred == 3:
                            buf = _unpredict_float(buf, rows, tw * per, per,
                                                   bo)
                        tile = (buf.view(dt).reshape(rows, tw, per)
                                if b in (8, 16, 32) else
                                _unpack(buf.reshape(rows, row_bytes), b,
                                        tw)[..., None])
                img[p, ty * th:ty * th + rows, tx * tw:(tx + 1) * tw] = tile
    img = img[:, :H, :W]
    samples = img[0] if planes == 1 else np.concatenate(list(img), axis=-1)
    if photo == 6:
        if comp != 7 or planar == 2:         # JPEG planes: the RGBA interface
            samples = _ycbcr_rgb(samples, tags.get(529), tags.get(532))
        photo = 2                            # converted to RGB
    if fmt != (1,) or b in (12, 32):
        return _sample_mode(samples, photo, b, fmt, bo, comp)
    return _pillow_mode(samples, photo, b, spp, extra, bo)


def _raw_ycbcr(data: bytes, tags: dict, W: int, H: int) -> np.ndarray:
    """Uncompressed YCbCr as Pillow's own raw decoder reads it (OPEN_INFO's
    "RGBX" rawmode, no conversion): each strip's rows taken as 4 bytes a
    pixel from the strip's offset on, whatever the data, the fourth byte
    dropped; the file must hold that many bytes."""
    if 322 in tags or tags.get(258, (8,))[0] != 8 or tags.get(
            277, (1,))[0] != 3:
        raise _refused("uncompressed YCbCr other than 8-bit strips")
    rps = min(tags.get(278, (H,))[0], H)
    if tags.get(284, (1,))[0] == 2:          # planes: "R", "G", "B" of RGBX
        strips = -(-H // rps)
        offs, out = tags[273], np.empty((H, W, 3), np.uint8)
        for k, off in enumerate(offs[:3 * strips]):
            p, i = divmod(k, strips)
            rows = min(rps, H - i * rps)
            px = np.frombuffer(data[off:off + rows * W], np.uint8)
            if px.size < rows * W:
                raise _refused("uncompressed YCbCr planes past the end of "
                               "the file")
            out[i * rps:i * rps + rows, :, p] = px.reshape(rows, W)
        return out
    offs = tags[273][-1:] if rps == H else tags[273]
    out = np.empty((H, W, 3), np.uint8)
    for i, off in enumerate(offs):
        rows = min(rps, H - i * rps)
        px = np.frombuffer(data[off:off + rows * W * 4], np.uint8)
        if px.size < rows * W * 4:
            raise _refused("uncompressed YCbCr past the end of the file "
                           "(read as 4 bytes a pixel)")
        out[i * rps:i * rps + rows] = px.reshape(rows, W, 4)[..., :3]
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _old_jpeg(data: bytes, tags: dict, W: int, H: int, spp: int,
              photo) -> np.ndarray:
    """Old-style JPEG (compression 6) as libtiff's tif_ojpeg.c hands it to
    libjpeg, and the RGBA interface to Pillow.

    libtiff reads the markers at JPEGInterchangeFormat (513, for
    JPEGInterchangeFormatLength bytes), or else at the start of the first
    strip, through the SOS; without markers it builds the header from the
    tags (one table a sample from JPEGQTables, JPEGDCTables and
    JPEGACTables; the SOF's sampling from YCbCrSubsampling).  The scan data
    is what follows in that stream, then each strip with an RSTn marker
    between strips (and a restart interval of a strip's MCUs when there is
    more than one strip, unless the stream has its own DRI).  Three
    samples are YCbCr whatever the photometric tag says (the sampling in
    the SOF wins over the tag's, as OJPEGSubsamplingCorrect has it): the
    raw planes, chroma replicated over each data unit, converted by
    TIFFYCbCrtoRGB; one sample is grey as stored."""
    from .jpeg import COLOUR_NONE, COLOUR_RAW, decode_jpeg_tables

    def one(tag, default=None):
        return tags[tag][0] if tag in tags else default

    if one(284, 1) == 2:
        raise ValueError("TIFF old-style JPEG in planes is not read (ROADMAP "
                         "A6 (j) 3)")
    if (spp == 1 and photo not in (0, 1)) or (spp == 3 and photo not in (
            None, 2, 6)):
        raise _refused(f"old-style JPEG of {spp} samples, photometric "
                       f"{photo}")
    # a strip or tile ("strile") is rps rows of a frame sw wide and fh high
    if 322 in tags:
        sw, rps = one(322), one(323)
        across, down = -(-W // sw), -(-H // rps)
        offs, counts = tags[324], tags.get(325, (0,) * len(tags[324]))
    else:
        sw, rps, across = W, min(one(278, 2 ** 32 - 1), H), 1
        down = -(-H // rps)
        offs, counts = tags[273], tags.get(279, (0,) * len(tags[273]))
    nstrips, fh = across * down, down * rps if 322 in tags else H
    offs, counts = offs[:nstrips], counts[:nstrips]
    strips = []
    for off, cnt in zip(offs, counts):
        off = off if off < len(data) else 0
        strips.append(data[off:off + cnt if cnt else len(data)] if off
                      else b"")
    sub = tuple(tags.get(530, (2, 2))) if spp == 3 else (1, 1)
    restart = one(515, 0)
    if rps < H:
        if sub[0] not in (1, 2, 4) or sub[1] not in (1, 2, 4) or (
                rps % (8 * sub[1])):
            raise _refused(f"old-style JPEG strips of {rps} rows at "
                           f"subsampling {sub}")
        restart = -(-sw // (8 * sub[0])) * (rps // (8 * sub[1]))
    jif = one(513, 0)
    if jif >= len(data):
        jif = 0
    stream = b""
    if jif:
        n = one(514, 0)
        stream = data[jif:jif + n if n and jif + n <= len(data) else
                      len(data)]
    rst = b"".join(st + (bytes([0xFF, 0xD0 + k % 8]) if k + 1 < len(strips)
                         else b"") for k, st in enumerate(strips))
    stream += rst
    # the markers, through the SOS (OJPEGReadHeaderInfoSec)
    tables, sof, sos, pos = [], None, None, 0
    while sos is None and pos < len(stream) and stream[pos] == 0xFF:
        while pos < len(stream) and stream[pos] == 0xFF:
            pos += 1
        m = stream[pos]
        pos += 1
        if m == 0xD8:
            continue
        (n,) = struct.unpack_from(">H", stream, pos)
        body = stream[pos + 2:pos + n]
        pos += n
        if m == 0xDD:
            (restart,) = struct.unpack_from(">H", body)
        elif m in (0xDB, 0xC4):
            tables.append(_segment(m, body))
        elif m in (0xC0, 0xC1, 0xC3):
            sof = _segment(m, body)
        elif m == 0xDA:
            if n != 6 + 2 * body[0]:
                raise _refused("old-style JPEG with a corrupt SOS")
            sos = _segment(m, body)
        elif not (0xE0 <= m <= 0xEF or m == 0xFE):
            raise _refused(f"old-style JPEG with marker {m:#x} in its header")
    if sof is None:                          # the tables from the tags
        sof, sos = _ojpeg_tag_tables(data, tags, sw, fh, spp, sub, tables)
    header = (b"\xff\xd8" + b"".join(tables)
              + (_segment(0xDD, struct.pack(">H", restart)) if restart
                 else b"") + sof + sos)
    nf, comps = sof[9], sof[10:]
    fy, fx = struct.unpack_from(">HH", sof, 5)
    if sof[4] != 8 or nf != spp or not (min(W, sw) <= fx <= sw
                                        and min(H, fh) <= fy <= fh):
        raise _refused(f"old-style JPEG whose frame ({fx}x{fy}x{nf}) is not "
                       f"its {sw}x{fh}x{spp} strips' of 8-bit samples")
    body = header + stream[pos:] + b"\xff\xd9"
    if spp == 1:
        frame = decode_jpeg_tables(b"", body, COLOUR_NONE)[..., None]
    else:
        h, v = comps[1] >> 4, comps[1] & 15
        raw = (h in (1, 2, 4) and v in (1, 2, 4)
               and comps[4] == comps[7] == 0x11)
        frame = decode_jpeg_tables(b"", body, COLOUR_RAW if raw
                                   else COLOUR_NONE)
    # the striles, in order, are the frame's bands of rps rows
    img = np.zeros((down * rps, across * sw, spp), np.uint8)
    for k in range(nstrips):
        ty, tx = divmod(k, across)
        band = frame[k * rps:(k + 1) * rps, :sw]
        if band.shape[0] < min(rps, H - ty * rps):
            raise _refused("old-style JPEG strips or tiles past its frame")
        img[ty * rps:ty * rps + band.shape[0],
            tx * sw:tx * sw + band.shape[1]] = band
    img = img[:H, :W]
    if spp == 1:
        return np.ascontiguousarray(img[..., 0])
    return _ycbcr_rgb(img, tags.get(529), tags.get(532))


def _ojpeg_tag_tables(data: bytes, tags: dict, W: int, H: int, spp: int,
                      sub, tables: list) -> tuple:
    """The DQT and DHT segments (appended to `tables`), SOF0 and SOS that
    libtiff builds from JPEGQTables, JPEGDCTables and JPEGACTables: a table
    a sample, one that repeats the sample before's offset shared."""
    ids = []
    for tag, kind in ((519, None), (520, 0), (521, 1)):
        offs = tags.get(tag, ())
        if len(offs) < 1 or not offs[0]:
            raise _refused("old-style JPEG without its tables")
        got = []
        for m in range(spp):
            o = offs[m] if m < len(offs) else 0
            if m and (not o or o == offs[m - 1]):
                got.append(got[-1])
                continue
            if kind is None:
                body = bytes([m]) + data[o:o + 64]
            else:
                counts = data[o:o + 16]
                body = bytes([kind << 4 | m]) + data[o:o + 16 + sum(counts)]
            tables.append(_segment(0xDB if kind is None else 0xC4, body))
            got.append(m)
        ids.append(got)
    q, dc, ac = ids
    comps = b"".join(bytes([m, (sub[0] << 4 | sub[1]) if m == 0 else 0x11,
                            q[m]]) for m in range(spp))
    sof = _segment(0xC0, struct.pack(">BHHB", 8, H, W, spp) + comps)
    sos = _segment(0xDA, bytes([spp]) + b"".join(
        bytes([m, dc[m] << 4 | ac[m]]) for m in range(spp)) + b"\x00\x3f\x00")
    return sof, sos


def _decompress(raw, comp: int, size: int, fax, cols: int, rows: int
                ) -> np.ndarray:
    if comp == 1:
        out = np.frombuffer(raw, np.uint8)[:size]
    elif comp == 5:
        out = imgdec.lzw_tiff(raw, size)
    elif comp == 32773:
        out = imgdec.packbits(raw, size)
    elif fax is not None:
        out = imgdec.fax(raw, fax, cols, rows).reshape(-1)
    elif comp == 32809:
        out = imgdec.thunderscan(raw, cols, rows).reshape(-1)
    elif comp == 34925:                      # libtiff's liblzma: .xz streams
        out = np.frombuffer(lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
            bytes(raw), size), np.uint8)
    elif comp == 50000:
        from ..utils.zstd import decompress_array
        out = decompress_array(raw)[:size]
    else:
        out = np.frombuffer(zlib.decompressobj().decompress(bytes(raw), size),
                            np.uint8)
    if out.size < size:
        raise ValueError(f"TIFF strip or tile of {out.size} bytes, not "
                         f"{size}")
    return np.array(out, np.uint8)


def _unpredict(buf: np.ndarray, rows: int, cols: int, per: int, b: int,
               bo: str) -> None:
    """Undo horizontal predictor 2 in place."""
    if b < 32:
        imgdec.unpredict(buf, rows, cols, per, b // 8, bo == ">")
        return
    v = buf.view(bo + "u4").reshape(rows, cols, per)
    v[:] = np.cumsum(v.astype(np.uint32), axis=1, dtype=np.uint32)


def _unpredict_units(buf: np.ndarray, size: int) -> None:
    """Undo predictor 2 on subsampled YCbCr as libtiff does, in place: over
    rows of TIFFScanlineSize bytes (a row of data units over the vertical
    subsampling), three bytes a step, whatever the units' layout."""
    if size % 3 or buf.size % size:
        raise _refused("subsampled YCbCr with predictor 2 over rows of "
                       f"{size} bytes (libtiff's predictor fails)")
    imgdec.unpredict(buf, buf.size // size, size // 3, 3, 1, False)


def _unpredict_float(buf: np.ndarray, rows: int, words: int, per: int,
                     bo: str) -> np.ndarray:
    """Undo floating-point predictor 3 (tif_predict.c fpAcc) on rows of
    `words` 4-byte samples: the bytes summed with a stride of a pixel, then
    the byte planes (most significant first) put back together, here in
    the file's byte order."""
    rb = words * 4
    x = buf[:rows * rb].reshape(rows, rb // per, per)
    x = np.cumsum(x, axis=1, dtype=np.uint8).reshape(rows, 4, words)
    if bo == "<":
        x = x[:, ::-1]
    return np.ascontiguousarray(x.transpose(0, 2, 1)).reshape(-1)


def _jpeg_tile(tables: bytes, raw, photo: int, rows: int, cols: int,
               per: int) -> np.ndarray:
    """A JPEG-compressed strip or tile, as libtiff decodes it for Pillow:
    YCbCr to RGB (JPEGCOLORMODE_RGB), anything else as stored."""
    from .jpeg import COLOUR_NONE, COLOUR_YCBCR, decode_jpeg_tables
    colour = COLOUR_YCBCR if photo == 6 else COLOUR_NONE
    img = decode_jpeg_tables(tables, bytes(raw), colour)
    img = img.reshape(img.shape[:2] + (-1,))
    if img.shape[0] < rows or img.shape[1] < cols or img.shape[2] != per:
        raise ValueError(f"TIFF JPEG strip or tile of {img.shape}, not "
                         f"{(rows, cols, per)}")
    return img[:rows, :cols]


def _ycbcr_units(buf: np.ndarray, units: int, row_bytes: int, sub, rows: int,
                 cols: int) -> np.ndarray:
    """Subsampled YCbCr data units (h * v Y samples, Cb, Cr each) -> [rows,
    cols, 3] samples, the chroma replicated over its unit (libtiff's
    putcontig8bitYCbCr*tile)."""
    h, v = sub
    n = row_bytes // (h * v + 2)
    u = buf[:units * row_bytes].reshape(units, n, h * v + 2)
    y = u[..., :h * v].reshape(units, n, v, h).transpose(0, 2, 1, 3)
    y = y.reshape(units * v, n * h)
    c = np.repeat(np.repeat(u[..., h * v:], v, axis=0), h, axis=1)
    return np.concatenate([y[..., None], c], -1)[:rows, :cols]


def _fix(x) -> int:
    """tif_color.c's FIX: (int32_t)(x * (1L << 16) + 0.5) of a float x."""
    return int(float(np.float32(x) * np.float32(65536)) + 0.5)


def _code2v(c: np.ndarray, rb, rw, cr) -> np.ndarray:
    """tif_color.c's Code2V in float32, clamped as CLAMPw and cast as the
    tables are (toward zero)."""
    f32 = np.float32
    rb, rw = f32(rb), f32(rw)
    d = rw - rb
    v = (c - np.int32(rb)).astype(f32) * f32(cr) / (d if d != 0 else f32(1))
    return np.clip(v, f32(-128 * 32), f32(128 * 32)).astype(np.int32)


def _ycbcr_rgb(ycc: np.ndarray, luma, refbw) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB on [H, W, 3] uint8."""
    y_tab, cr_r, cb_g, cr_g, cb_b = _ycbcr_tables(
        tuple(luma or (0.299, 0.587, 0.114)),
        tuple(refbw or (0, 255, 128, 255, 128, 255)))
    y, b, r = (ycc[..., i].astype(np.intp) for i in range(3))
    yt = y_tab[y]
    out = np.stack([yt + cr_r[r], yt + ((cb_g[b] + cr_g[r]) >> 16),
                    yt + cb_b[b]], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=16)
def _ycbcr_tables(luma: tuple, refbw: tuple) -> tuple:
    """TIFFYCbCrToRGBInit's tables for YCbCrCoefficients `luma` and
    ReferenceBlackWhite `refbw`: Y, Cr -> R, Cb -> G, Cr -> G, Cb -> B."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    rbw = [f32(v) for v in refbw]
    f1 = f32(2) - f32(2) * lr
    d1 = _fix(np.clip(f1, 0, 2))
    d2 = -_fix(np.clip(lr * f1 / lg, 0, 2))
    f3 = f32(2) - f32(2) * lb
    d3 = _fix(np.clip(f3, 0, 2))
    d4 = -_fix(np.clip(lb * f3 / lg, 0, 2))
    x = np.arange(-128, 128, dtype=np.int64)
    cr = _code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127).astype(
        np.int64)
    cb = _code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127).astype(
        np.int64)
    y_tab = _code2v(x + 128, rbw[0], rbw[1], 255).astype(np.int64)
    cr_r = (d1 * cr + (1 << 15)) >> 16
    cb_b = (d3 * cb + (1 << 15)) >> 16
    cr_g = d2 * cr
    cb_g = d4 * cb + (1 << 15)
    return y_tab, cr_r, cb_g, cr_g, cb_b


def _unpack(rows: np.ndarray, b: int, w: int) -> np.ndarray:
    """Rows of packed b-bit samples, most significant bits first -> [rows,
    w] (uint16 at 12 bits, Pillow's "I;12" unpacker)."""
    if b == 12:
        n = (w + 1) // 2 * 3                 # whole pairs of samples
        r = np.zeros((rows.shape[0], n), np.uint16)
        r[:, :min(n, rows.shape[1])] = rows[:, :n]
        r = r.reshape(rows.shape[0], -1, 3)
        pair = np.stack([(r[..., 0] << 4) | (r[..., 1] >> 4),
                         ((r[..., 1] & 15) << 8) | r[..., 2]], -1)
        return pair.reshape(rows.shape[0], -1)[:, :w]
    shifts = np.arange(8 - b, -1, -b, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << b) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w]


def _sample_mode(s: np.ndarray, photo: int, b: int, fmt: tuple, bo: str,
                 comp: int) -> np.ndarray:
    """Signed, float, 12- and 32-bit grey [H, W, 1] -> Pillow's "L", "I",
    "I;16" or "F" array."""
    g = s[..., 0]
    if b == 12:
        return np.ascontiguousarray(g.astype(np.uint16))
    if fmt == (3,) and b == 32 and photo in (0, 1):
        out = g.view(bo + "f4")
    elif fmt == (2,) and b == 8 and photo == 1:
        return np.ascontiguousarray(g)
    elif fmt == (2,) and b in (16, 32) and photo == 1:
        out = g.view(bo + ("i2" if b == 16 else "i4"))
    elif fmt == (1,) and b == 32 and photo == 1 and bo == "<":
        return np.ascontiguousarray(g.view("<i4")).astype(np.int32)
    else:
        raise _refused(f"photometric {photo} with sample format {fmt} and "
                       f"{b} bits")
    if bo == ">" and comp != 1:
        # libtiff decompresses to native order, Pillow unpacks big-endian
        out = out.byteswap()
    return out.astype(np.float32 if fmt == (3,) else np.int32)


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
        assoc = spp >= 4 and tuple(extra[:1]) == (1,)
        alpha = spp >= 4 and (not extra or extra[0] in (1, 2, 999))
        if spp > 4 and not extra:
            raise ValueError(f"TIFF RGB with {spp} samples and no "
                             "ExtraSamples (Pillow reads none)")
        s = s[..., :4 if alpha else 3]
        if b == 16:
            s = (s.astype(np.uint16) >> 8).astype(np.uint8)
        if assoc:                            # Pillow's "RGBa" unpacker
            a = s[..., 3:].astype(np.int32)
            rgb = np.minimum(s[..., :3].astype(np.int32) * 255
                             // np.maximum(a, 1), 255)
            s = np.concatenate([np.where(a == 0, 0, rgb), a], -1).astype(
                np.uint8)
        return np.ascontiguousarray(s)
    if photo == 3 and spp == 1 and b <= 8:
        return np.ascontiguousarray(s[..., 0].astype(np.uint8))
    if photo == 3 and spp == 2 and b == 8 and tuple(extra) in ((0,), (2,)):
        return np.ascontiguousarray(s if extra[0] == 2 else s[..., 0])
    if photo == 5 and spp >= 4 and b in (8, 16) and (
            spp == 4 or tuple(extra) == (0,) * (spp - 4)) and (
            b == 8 or spp == 4):
        s = s[..., :4]
        if b == 16:
            s = (s.astype(np.uint16) >> 8).astype(np.uint8)
        return np.ascontiguousarray(s)
    if photo == 8 and spp == 3 and b == 8:
        return np.ascontiguousarray(s)
    raise _refused(f"photometric {photo} with {spp} samples of {b} bits")
