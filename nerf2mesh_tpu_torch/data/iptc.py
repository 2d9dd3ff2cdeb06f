"""An IPTC/NAA image reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's IptcImagePlugin reads.

IPTC has no _accept: Image.open tries it on every file no earlier plugin
took.  The file is 0x1C records (record 1-9 or 240, a tag, a two-byte size
or 0x80 + n and an n-byte size; five zero bytes or the file's end stop
them) up to the first (8, 10) record.  (3, 60) holds the layers and a
component flag: one layer and no flag is mode "L"; three or four with the
flag "RGB" or "CMYK", with (3, 65) the band (1-based, default 1) the image
goes into.  (3, 20) and (3, 30) are the width and height, (3, 120) the
compression: 1 raw, 5 "jpeg".

The (8, 10) records' payload is read as Pillow reads it: "raw" gets the
"P5 W H 255" header Pillow prepends, then the payload goes back through
``png.decode_image`` whatever its format (Image.open reads it by content).
In "L" the payload's core is taken as is; in RGB and CMYK it is the given
band and the others are zero (Image.merge), which takes one-band images
only, and in any band but the first mode "L" only (Pillow: image has wrong
mode, mode mismatch).  np.asarray then packs Pillow's core in the file's
mode: for "L" each row's first W bytes of the payload's pixel memory (a
grey byte, "1" as 0/255, RGB as R, G, B, 255, LA as L, L, L, A, 16-bit
samples byte by byte), shaped to the file's size; a payload smaller than
the file's size (Pillow reads past its buffer) raises ValueError.

A record that is not 0x1C or of another record number, a header cut short,
no (3, 60), or a size or mode it does not give hands the file on (Image.open
passes over the plugin); a record size byte above 132, a compression other
than 1 or 5 or none, no (8, 10) record (cannot load this image), a band
past the mode's, a payload no reader takes or that ends first raise
ValueError.  A band image beyond the first must read as grey from a JPEG,
PNG or netpbm payload, whose mode the port knows to be "L".
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


class _Fields:
    """IptcImageFile.field() over the file's bytes."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        s = self.data[self.pos:self.pos + n]
        self.pos += len(s)
        return s

    def field(self) -> tuple:
        s = self.read(5)
        if not s.strip(b"\0"):
            return None, 0
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in _RECORDS:
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise ValueError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _int(self.read(size - 128))
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        return tag, size


def _int(c) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _open(data: bytes):
    """IptcImageFile._open: (mode, band, (W, H), compression, the (8, 10)
    record's offset or None)."""
    fp, info = _Fields(data), {}
    while True:
        offset = fp.pos
        tag, size = fp.field()
        if not tag or tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = None, None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _int(info[(3, 20)]), _int(info[(3, 30)])
    if (3, 120) not in info:
        raise ValueError("Unknown IPTC image compression")
    compression = {1: "raw", 5: "jpeg"}.get(_int(info[(3, 120)]))
    if compression is None:
        raise ValueError("Unknown IPTC image compression")
    return mode, band, size, compression, offset if tag == (8, 10) else None


def _payload(data: bytes, offset: int, size: tuple, compression: str
             ) -> bytes:
    fp = _Fields(data, offset)
    out = [b"P5\n%d %d\n255\n" % size] if compression == "raw" else []
    while True:
        try:
            kind, n = fp.field()
        except (SyntaxError, IndexError, struct.error) as e:
            raise ValueError(f"IPTC record after the image: {e}") from e
        if kind != (8, 10):
            break
        out.append(fp.read(n))
    return b"".join(out)


def _memory(a: np.ndarray) -> tuple:
    """(Pillow's core bytes of a decoded array, [H, W * pixel size], and
    its band count)."""
    if a.ndim == 2:
        mem = (a.astype(np.uint8) * 255 if a.dtype == bool else a)
        return np.ascontiguousarray(mem).view(np.uint8).reshape(
            a.shape[0], -1), 1
    H, W, C = a.shape
    if C == 2:
        a = a[..., [0, 0, 0, 1]]
    elif C == 3:
        a = np.concatenate([a, np.full((H, W, 1), 255, np.uint8)], -1)
    return np.ascontiguousarray(a, np.uint8).reshape(H, -1), C


def _is_grey(payload: bytes, a: np.ndarray) -> bool:
    """Whether a payload read as uint8 [H, W] is mode "L" (JPEG, PNG of
    colour type 0, netpbm P2/P5) rather than "P"."""
    if a.dtype != np.uint8 or a.ndim != 2:
        return False
    if payload[:2] == b"\xff\xd8" or payload[:2] in (b"P2", b"P5"):
        return True
    return payload[:8] == b"\x89PNG\r\n\x1a\n" and payload[25:26] == b"\0"


def decode_iptc(data: bytes) -> np.ndarray:
    from .png import decode_image
    try:
        mode, band, (W, H), compression, offset = _open(data)
    except (SyntaxError, IndexError, TypeError, KeyError,
            struct.error) as e:
        raise imgdec.NotThisFormat(f"not an IPTC/NAA image: {e}") from e
    if mode is None or W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("IPTC/NAA without a mode or size")
    imgdec.check_size(W, H, "IPTC/NAA")
    if offset is None:
        raise ValueError("IPTC/NAA without image data (cannot load this "
                         "image)")
    payload = _payload(data, offset, (W, H), compression)
    img = decode_image(payload)
    mem, bands = _memory(img)
    if mode == "L":
        flat = mem[:, :img.shape[1]].reshape(-1)
        if flat.size < W * H:
            raise ValueError("IPTC/NAA payload smaller than the image "
                             "(Pillow reads past its buffer)")
        return flat[:W * H].reshape(H, W).copy()
    n = 3 if mode == "RGB" else 4
    if not -n <= band < n:
        raise ValueError("IPTC/NAA band past the mode's (list assignment "
                         "index out of range)")
    band %= n
    if band and not _is_grey(payload, img):
        raise ValueError("IPTC/NAA band image not mode L (mode mismatch)")
    if bands != 1:
        raise ValueError("IPTC/NAA band image of several bands (image has "
                         "wrong mode)")
    h, w = img.shape[:2]
    out = np.zeros((h, w, n), np.uint8)
    out[..., band] = mem[:, :w]
    flat = out.reshape(-1)
    if flat.size < W * H * n:
        raise ValueError("IPTC/NAA payload smaller than the image (Pillow "
                         "reads past its buffer)")
    return flat[:W * H * n].reshape(H, W, n).copy()
