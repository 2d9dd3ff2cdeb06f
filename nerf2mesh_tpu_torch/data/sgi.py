"""An SGI image reader without Pillow: ``np.asarray(Image.open(path))`` of
the files Pillow's SgiImagePlugin reads.

* magic 474; 1 or 2 bytes a sample; dimension 1 or 2 with one channel
  (mode "L") or dimension 3 with 3 ("RGB") or 4 ("RGBA") channels; 2-byte
  samples come out as their high byte, as Pillow's "L;16B", "RGB;16B" and
  "RGBA;16B" unpack them;
* verbatim (each channel's plane in turn) or RLE (native/imgdec.cpp, as
  SgiRleDecode.c reads it: a run past its row or the data is refused, a
  row whose runs stop short keeps the row before's samples, and a row
  whose last byte is not the zero count ends the decode there);
* rows bottom up.

What Pillow refuses raises ValueError; a header too short to parse raises
imgdec.NotThisFormat, as Image.open then tries the next plugin.
"""

from __future__ import annotations

import struct

import numpy as np

from . import imgdec

# (bytes a sample, dimension, channels) -> channels of Pillow's mode
_MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1,
          (1, 3, 3): 3, (2, 3, 3): 3, (1, 3, 4): 4, (2, 3, 4): 4}


def decode_sgi(data: bytes) -> np.ndarray:
    if len(data) < 12:
        raise imgdec.NotThisFormat("SGI header truncated")
    magic, comp, bpc, dim, W, H, Z = struct.unpack_from(">HBBHHHH", data)
    if magic != 474:
        raise ValueError("not an SGI file")
    C = _MODES.get((bpc, dim, Z))
    if C is None:
        raise ValueError(f"SGI of {bpc} bytes a sample, dimension {dim} and "
                         f"{Z} channels (Pillow reads none)")
    imgdec.check_size(W, H, "SGI")
    if comp == 1:
        rows, _ = imgdec.sgi_rle(data[512:], W, H, C, bpc)
        px = rows.reshape(H, W, C, bpc)[..., 0]
    elif comp == 0:
        page = W * H * bpc
        raw = np.frombuffer(data, np.uint8, min(C * page, max(
            len(data) - 512, 0)), 512)
        if raw.size < C * page:
            raise ValueError("SGI image data truncated")
        px = raw.reshape(C, H, W, bpc)[..., 0].transpose(1, 2, 0)
    else:
        raise ValueError(f"SGI storage {comp} (Pillow reads none)")
    img = px[::-1]
    return np.ascontiguousarray(img[..., 0] if C == 1 else img)
