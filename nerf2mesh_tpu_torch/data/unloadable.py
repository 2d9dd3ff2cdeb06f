"""The formats Pillow 12.1 identifies but cannot load here, refused as it
refuses them: ``np.asarray(Image.open(path))`` raises, so
data/png.read_image raises ValueError naming the format and the reason.

* BUFR, GRIB and HDF5: stub plugins with no handler installed ("cannot find
  loader for this ... file");
* MPEG: the plugin reads the sequence header's size and no tile ("cannot
  load this image"); fewer than 7 bytes or a size of 0 hand the file on;
* EPS: loading needs Ghostscript, which is not installed; the plugin's
  header parse (``EpsImageFile._open``, ported below) decides first
  whether Pillow takes the file at all, or hands it on, or raises;
* WMF and EMF: the stub plugin's handler exists on Windows only; a
  placeable WMF whose header is not Pillow's hands the file on, one with an
  inch of 0 and an EMF with an empty frame raise in Pillow's _open;
* an OLE compound file (FlashPix, Microsoft Image Composer): those plugins
  need ``olefile``, which is not installed, so no plugin takes the file
  (UnidentifiedImageError).
"""

from __future__ import annotations

import re
import struct

from . import imgdec

OLE_MAGIC = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"


def _stub(name: str):
    raise ValueError(f"{name} file: Pillow identifies it but has no loader "
                     f"for it here (cannot find loader for this {name} "
                     f"file)")


def accepts_bufr(data: bytes) -> bool:
    return data[:4] in (b"BUFR", b"ZCZC")


def accepts_grib(data: bytes) -> bool:
    return len(data) >= 8 and data[:4] == b"GRIB" and data[7] == 1


def accepts_hdf5(data: bytes) -> bool:
    return data[:8] == b"\x89HDF\r\n\x1a\n"


def refuse_bufr(data: bytes):
    _stub("BUFR")


def refuse_grib(data: bytes):
    _stub("GRIB")


def refuse_hdf5(data: bytes):
    _stub("HDF5")


def accepts_mpeg(data: bytes) -> bool:
    return data[:4] == b"\x00\x00\x01\xb3"


def refuse_mpeg(data: bytes):
    if len(data) < 7:
        raise imgdec.NotThisFormat("MPEG sequence header cut short")
    W, H = (data[4] << 4) | (data[5] >> 4), ((data[5] & 15) << 8) | data[6]
    if not W or not H:
        raise imgdec.NotThisFormat("MPEG size of 0")
    raise ValueError(f"MPEG stream ({W}x{H}): Pillow identifies it but reads "
                     f"no frame (cannot load this image)")


# ------------------------------------------------------------------ EPS
_EPS_SPLIT = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
_EPS_FIELD = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")


def accepts_eps(data: bytes) -> bool:
    return data[:4] == b"%!PS" or (
        len(data) >= 4 and struct.unpack_from("<I", data)[0] == 0xC6D3D0C5)


def _eps_size(data: bytes) -> tuple:
    """EpsImageFile._open: the size Pillow gives the file; NotThisFormat
    where it hands the file on, ValueError where it raises."""
    if data[:4] == b"%!PS":
        pos = 0
    elif len(data) < 12:
        raise imgdec.NotThisFormat("DOS EPS header cut short")
    else:
        pos = struct.unpack_from("<I", data, 4)[0]
    info, bbox, image_size = {}, None, None
    buf, n = bytearray(255), 0
    header, trailer_comments, trailer = True, False, False

    def check():
        if "PS-Adobe" not in info or "BoundingBox" not in info:
            raise imgdec.NotThisFormat("EPS header missing a required "
                                       "comment")

    def comment(s: str) -> bool:
        nonlocal bbox, trailer_comments
        m = _EPS_SPLIT.match(s)
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer_comments = True
            elif not bbox or (trailer and trailer_comments):
                try:
                    bbox = [int(float(i)) for i in v.split()]
                except Exception:
                    pass
        return True

    while True:
        byte = data[pos:pos + 1]
        pos += len(byte)
        if not byte:
            if n == 0:
                if header:
                    check()
                break
        elif byte in b"\r\n":
            if n == 0:
                continue
        else:
            if n >= 255:
                if buf[0] == ord("%"):
                    raise imgdec.NotThisFormat("not an EPS file")
                if header:
                    check()
                    header = False
                n = 0
            buf[n] = byte[0]
            n += 1
            continue
        if header:
            if buf[0] != ord("%") or buf[:13] == b"%%EndComments":
                check()
                header = False
                continue
            s = str(buf[:n], "latin-1")
            if not comment(s):
                m = _EPS_FIELD.match(s)
                if m:
                    k = m.group(1)
                    info["PS-Adobe" if k.startswith("PS-Adobe") else k] = ""
                elif s[0] != "%":
                    raise ValueError("bad EPS header")
        elif buf[:11] == b"%ImageData:":
            if image_size:
                n = 0
                continue
            fields = buf[11:n].split(None, 7)
            if len(fields) < 4:
                raise ValueError("EPS %ImageData with fewer than 4 values")
            cols, rows, depth, mode_id = (int(v) for v in fields[:4])
            if depth == 8 and mode_id not in (1, 2, 3, 4):
                raise imgdec.NotThisFormat("EPS %ImageData mode")
            if depth not in (1, 8):
                break
            image_size = cols, rows
        elif buf[:5] == b"%%EOF":
            break
        elif trailer and trailer_comments:
            comment(str(buf[:n], "latin-1"))
        elif buf[:9] == b"%%Trailer":
            trailer = True
        elif buf[:14] == b"%%BeginBinary:":
            pos += int(buf[14:n])
            if pos < 0:
                raise ValueError("EPS %%BeginBinary before the file's start")
        n = 0
    if not bbox:
        raise ValueError("cannot determine EPS bounding box")
    if image_size:
        return image_size
    if len(bbox) < 4:
        raise imgdec.NotThisFormat("EPS bounding box of fewer than 4 values")
    return bbox[2] - bbox[0], bbox[3] - bbox[1]


def refuse_eps(data: bytes):
    W, H = _eps_size(data)
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("EPS size not positive")
    imgdec.check_size(W, H, "EPS")
    raise ValueError(f"EPS file ({W}x{H}): Pillow loads it through "
                     f"Ghostscript, which is not installed (Unable to locate "
                     f"Ghostscript on paths)")


# ------------------------------------------------------------------ WMF
def accepts_wmf(data: bytes) -> bool:
    return data[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or data[:4] == \
        b"\x01\x00\x00\x00"


def refuse_wmf(data: bytes):
    s = data[:44]
    if s[:6] == b"\xd7\xcd\xc6\x9a\x00\x00":
        if len(s) < 16:
            raise imgdec.NotThisFormat("WMF header cut short")
        (inch,) = struct.unpack_from("<H", s, 14)
        if inch == 0:
            raise ValueError("WMF file with an inch of 0 (Pillow: Invalid "
                             "inch)")
        x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
        W, H = (x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch
        if s[22:26] != b"\x01\x00\t\x00":
            raise imgdec.NotThisFormat("Unsupported WMF file format")
    elif s[:4] == b"\x01\x00\x00\x00" and s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        W, H = x1 - x0, y1 - y0
        if f2 == f0 or f3 == f1:
            raise ValueError("EMF file with an empty frame (Pillow: float "
                             "division by zero)")
    else:
        raise imgdec.NotThisFormat("Unsupported file format")
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("WMF size not positive")
    imgdec.check_size(W, H, "WMF")
    raise ValueError(f"WMF/EMF file ({W}x{H}): Pillow's handler exists on "
                     f"Windows only (cannot find loader for this WMF file)")


def refuse_ole(data: bytes):
    raise ValueError("OLE compound file (FlashPix or Microsoft Image "
                     "Composer): Pillow's plugins for it need olefile, which "
                     "is not installed, so no plugin takes it (cannot "
                     "identify image file)")
