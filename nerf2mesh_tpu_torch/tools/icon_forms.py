"""Test-side writers (numpy only) for the icon and small raster forms that
Pillow reads but does not write, or writes in one form only: ICNS from any
entries (RLE and raw 24-bit RGB, masks, PNG and JPEG 2000 entries, a table
of contents, duplicate blocks), IM in every "Image type" of Pillow's OPEN
table, MSP version 2 (RLE), SPIDER in either byte order and as a stack,
and X10/X11 XBM.  Used by tests/test_torch_iconforms.py and its committed
fixtures, never by the port's readers.
"""

from __future__ import annotations

import struct

import numpy as np


# ------------------------------------------------------------------ ICNS
def icns(entries, toc: bool = False, filesize: int | None = None) -> bytes:
    """An ICNS file of `entries` [(4-byte type, payload)], in order; with
    `toc` a "TOC " block first listing them; `filesize` overrides the
    header's size."""
    blocks = [k + struct.pack(">I", len(v) + 8) + v for k, v in entries]
    if toc:
        body = b"".join(k + struct.pack(">I", len(v) + 8) for k, v in entries)
        blocks.insert(0, b"TOC " + struct.pack(">I", len(body) + 8) + body)
    body = b"".join(blocks)
    size = len(body) + 8 if filesize is None else filesize
    return b"icns" + struct.pack(">I", size) + body


def icns_rle(band) -> bytes:
    """One band in the RLE Pillow's read_32 decodes: runs of 3-130 equal
    bytes as (count + 125, byte), the rest as literals of 1-128 bytes
    (length - 1, bytes)."""
    b = np.asarray(band, np.uint8).reshape(-1).tobytes()
    out, lit, i = bytearray(), bytearray(), 0

    def flush():
        for j in range(0, len(lit), 128):
            chunk = lit[j:j + 128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()

    while i < len(b):
        j = i
        while j < len(b) and j - i < 130 and b[j] == b[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([j - i + 125, b[i]])
            i = j
        else:
            lit.append(b[i])
            i += 1
    flush()
    return bytes(out)


def icns_rgb(rgb: np.ndarray, rle: bool = True) -> bytes:
    """A 24-bit entry (is32, il32, ih32): three RLE bands, or the raw
    interleaved pixels (3 * W * H bytes)."""
    rgb = np.asarray(rgb, np.uint8)
    if not rle:
        return rgb.tobytes()
    return b"".join(icns_rle(rgb[..., c]) for c in range(3))


# -------------------------------------------------------------------- IM
def im_header(image_type: str, W: int, H: int, lut: bytes | None = None,
              lines=(), eol: bytes = b"\r\n", end: bytes = b"\0") -> bytes:
    """An IM header as Pillow writes it (type, size, frames, padded with
    `end` bytes to 511, then ^Z), with `lines` ("Key: value") after the
    size and a "Lut" line and the 768-byte planar LUT when given."""
    h = (f"Image type: {image_type}".encode() + eol +
         f"Image size (x*y): {W}*{H}".encode() + eol +
         b"".join(ln.encode("latin-1") + eol for ln in lines) +
         b"File size (no of images): 1" + eol)
    if lut is not None:
        h += b"Lut: 1" + eol
    h += end * (511 - len(h)) + b"\x1a"
    return h + (lut if lut is not None else b"")


def im_rows(rows: np.ndarray) -> bytes:
    """[H, ...] rows stored bottom to top."""
    return np.ascontiguousarray(np.asarray(rows)[::-1]).tobytes()


def im_lines(img: np.ndarray) -> bytes:
    """[H, W, C] uint8 as line-interleaved rows (a row's bands one after
    the other), bottom to top."""
    return im_rows(np.asarray(img, np.uint8).transpose(0, 2, 1))


def im_packed(vals: np.ndarray, bits: int, lsb_first: bool = False
              ) -> bytes:
    """[H, W] samples of `bits` bits packed in rows from a byte boundary,
    MSB first (P;2, P;4, 1) or LSB first (Pillow's bit decoder), bottom to
    top."""
    v = np.asarray(vals, np.uint64)
    H, W = v.shape
    shifts = np.arange(bits, dtype=np.uint64)
    if not lsb_first:
        shifts = shifts[::-1]
    b = ((v[..., None] >> shifts) & np.uint64(1)).astype(np.uint8)
    b = b.reshape(H, W * bits)
    rows = np.packbits(b, axis=1, bitorder="little" if lsb_first else "big")
    return im_rows(rows)


# ------------------------------------------------------------------- MSP
def msp_header(magic: bytes, W: int, H: int) -> bytes:
    """The 32-byte header whose 16 words XOR to 0."""
    h = bytearray(magic + struct.pack("<HHHHHHHH", W, H, 1, 1, 1, 1, W, H)
                  + bytes(12))
    check = 0
    for i in range(0, 30, 2):
        check ^= struct.unpack_from("<H", h, i)[0]
    struct.pack_into("<H", h, 30, check)
    return bytes(h)


def msp_rle_row(row: bytes) -> bytes:
    """A row in MSP version 2's RLE: runs of 3-255 equal bytes as (0,
    count, byte), the rest as literals of 1-255 bytes (count, bytes)."""
    out, lit, i = bytearray(), bytearray(), 0

    def flush():
        for j in range(0, len(lit), 255):
            out.append(len(lit[j:j + 255]))
            out.extend(lit[j:j + 255])
        lit.clear()

    while i < len(row):
        j = i
        while j < len(row) and j - i < 255 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([0, j - i, row[i]])
            i = j
        else:
            lit.append(row[i])
            i += 1
    flush()
    return bytes(out)


def msp2(mask: np.ndarray, rows=None) -> bytes:
    """A version-2 (LinS) MSP of a bool [H, W] mask (True a set bit);
    `rows` replaces the encoded rows (a row of b"" is a blank line)."""
    m = np.asarray(mask, bool)
    H, W = m.shape
    if rows is None:
        packed = np.packbits(m, axis=1)
        rows = [msp_rle_row(r.tobytes()) for r in packed]
    return (msp_header(b"LinS", W, H)
            + struct.pack(f"<{H}H", *[len(r) for r in rows]) + b"".join(rows))


# ---------------------------------------------------------------- SPIDER
def spider(img: np.ndarray, big_endian: bool = False, stack: int = 0
           ) -> bytes:
    """A SPIDER 2D image (iform 1) of float32 [H, W], its header as
    Pillow's makeSpiderHeader lays it out; with `stack` images, a stack
    header (word 24 > 0, word 26 the count) and each image after its own
    header (the first is `img`, the rest its negation)."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    lenbyt = W * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    order = ">" if big_endian else "<"

    def header(istack, maxim, imgnum):
        hdr = [0.0] * (labbyt // 4 + 1)
        hdr[1], hdr[2], hdr[3], hdr[5] = 1.0, float(H), float(H), 1.0
        hdr[12], hdr[13] = float(W), float(labrec)
        hdr[22], hdr[23] = float(labbyt), float(lenbyt)
        hdr[24], hdr[26], hdr[27] = float(istack), float(maxim), float(imgnum)
        return struct.pack(f"{order}{len(hdr) - 1}f", *hdr[1:])

    data = img.astype(order + "f4").tobytes()
    if not stack:
        return header(0, 0, 0) + data
    out = header(2, stack, 0)
    for i in range(stack):
        out += header(0, 0, i + 1) + (data if i == 0 else (-img).astype(
            order + "f4").tobytes())
    return out


# ------------------------------------------------------------------- XBM
def xbm(mask: np.ndarray, x10: bool = False, hotspot=None,
        lead: bytes = b"", name: str = "t") -> bytes:
    """An XBM of a bool [H, W] mask: X11 bytes ("0x%02x", first pixel in
    the low bit) or X10 shorts ("0x%04x", first pixel in the low bit of the
    low byte), an optional hot spot, `lead` before the first define."""
    m = np.asarray(mask, bool)
    H, W = m.shape
    rows = np.packbits(m, axis=1, bitorder="little")
    head = (lead + f"#define {name}_width {W}\n#define {name}_height {H}\n"
            .encode())
    if hotspot:
        head += (f"#define {name}_x_hot {hotspot[0]}\n"
                 f"#define {name}_y_hot {hotspot[1]}\n").encode()
    if x10:
        if rows.shape[1] % 2:
            rows = np.concatenate([rows, np.zeros((H, 1), np.uint8)], 1)
        words = rows.reshape(H, -1, 2).astype(np.uint16)
        vals = (words[..., 0] | (words[..., 1] << 8)).reshape(-1)
        toks = [f"0x{v:04x}" for v in vals]
        decl = f"static short {name}_bits[] = {{\n"
    else:
        toks = [f"0x{v:02x}" for v in rows.reshape(-1)]
        decl = f"static char {name}_bits[] = {{\n"
    lines = [", ".join(toks[i:i + 12]) for i in range(0, len(toks), 12)]
    return head + decl.encode() + (",\n".join(lines) + " };\n").encode()
