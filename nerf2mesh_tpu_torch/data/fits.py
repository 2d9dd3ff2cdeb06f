"""A FITS reader without Pillow: ``np.asarray(Image.open(path))`` of the
files Pillow 12.1's FitsImagePlugin reads.

The header is 80-byte cards in 2880-byte blocks; the first card must be
"SIMPLE = T" (else the file is handed on, as Image.open passes over the
plugin).  Cards are read as Pillow reads them, each header's cards joining
one dictionary: after an END the reading goes on at the next block, the
first header (primary or extension) with a size chooses the data, and the
data start where a card follows an END outside a header.  NAXIS 1 gives a
1 x NAXIS1 image, more take NAXIS1 x NAXIS2.  A BINTABLE extension with
ZIMAGE = T and ZCMPTYPE 'GZIP_1' is a tile-compressed image (its size from
the Z cards), read by Pillow's fits_gzip decoder: the rest of the file
from the heap is gunzipped and each pixel is the last BITPIX / 8 bytes of
a 4-byte word.

Pillow reads the samples against the FITS standard, and so does this:
the rows come bottom-up; BITPIX 8 is "L"; 16 is "I;16", a little-endian
uint16 (a stored 1 reads as 256); 32 is "I", native int32 (the big-endian
words byte-swapped); -32 is "F", native float32 (byte-swapped); -64 is
"F" too, float32 over the first half of the doubles' bytes.  A
tile-compressed "I;16" and "I" read the words' low bytes the same way;
tile-compressed floats give no bytes (Pillow: not enough image data).
Another BITPIX or a size not above 0 hands the file on; a header that
ends first (Truncated FITS file), no image, a value that is not a number,
gzip data Python's gzip refuses and pixels that end first raise
ValueError.
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from . import imgdec

_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"),
          -32: ("F", "<f4"), -64: ("F", "<f4")}


def accepts_fits(data: bytes) -> bool:
    return data[:6] == b"SIMPLE"


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    """FitsImageFile._parse_headers: (gzip or not, data offset, size,
    BITPIX) or None when this header has no image."""
    prefix, tiled, offset = b"", False, 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, tiled = b"Z", True
    size = _size(headers, prefix)
    if not size:
        return None
    return tiled, offset, size, int(headers[prefix + b"BITPIX"])


def _header(data: bytes):
    headers, in_progress, found, pos = {}, False, None, 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:
                found = _parse(headers)
            in_progress = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (keyword != b"SIMPLE" or value != b"T"):
            raise imgdec.NotThisFormat("Not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("FITS file with no image data")
    tiled, offset, size, bitpix = found
    return tiled, offset + pos - 80, size, bitpix


def decode_fits(data: bytes) -> np.ndarray:
    if not accepts_fits(data):
        raise imgdec.NotThisFormat("not a FITS file")
    try:
        tiled, offset, (W, H), bitpix = _header(data)
    except KeyError as e:
        raise imgdec.NotThisFormat(f"FITS header without {e}") from e
    if bitpix not in _MODES or W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("FITS BITPIX or size Pillow does not "
                                   "take")
    imgdec.check_size(W, H, "FITS")
    mode, dtype = _MODES[bitpix]
    nb = np.dtype(dtype).itemsize
    if tiled:
        try:
            value = gzip.decompress(data[offset:])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"FITS GZIP_1 data: {e}") from e
        keep = min(bitpix // 8, 4)
        words = np.frombuffer(value, np.uint8, len(value) // 4 * 4)
        words = words.reshape(-1, 4)[:, 4 - keep:] if keep > 0 else \
            words.reshape(-1, 4)[:, :0]
        if words.size < W * H * nb:
            raise ValueError("FITS GZIP_1 data short of the image (not "
                             "enough image data)")
        rows = words[:W * H].reshape(H, W * keep)
    else:
        if offset < 0 or len(data) < offset + W * H * nb:
            raise ValueError("FITS data cut short (image file is "
                             "truncated)")
        rows = np.frombuffer(data, np.uint8, W * H * nb, offset).reshape(
            H, W * nb)
    return np.ascontiguousarray(rows[::-1]).view(dtype).reshape(H, W)
