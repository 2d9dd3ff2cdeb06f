"""Test-side writers of the formats the port reads without Pillow since
ROADMAP A6 (j) 9's second part, none of which Pillow writes: SUN rasters
(raw and RLE), XPM, PIXAR, McIdas areas, GIMP brushes, IM Tools (IMT), XV
thumbnails, FITS (plain and GZIP_1 tile-compressed), FLI/FLC frames, Kodak
PhotoCD (PCD) and IPTC/NAA records, and JP2 files with a ``pclr`` palette
(ICNS's palette JPEG 2000 entries).  Each lays its bytes out as the
reading plugin of Pillow 12.1 expects them (tests/test_torch_rareforms.py
holds every writer to Pillow's reading); none of them is used by the
package itself.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

SUN_MAGIC = 0x59A66A95


# ------------------------------------------------------------------ SUN
def sun_rle(raw: bytes) -> bytes:
    """Sun raster RLE of a byte stream: runs of 3 or more as 0x80 c v
    (c + 1 bytes), a lone 0x80 as 0x80 0, other bytes as they are."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        v = raw[i]
        j = i + 1
        while j < n and raw[j] == v and j - i < 256:
            j += 1
        run = j - i
        if run >= 3 or (v == 0x80 and run >= 2):
            out += bytes([0x80, run - 1, v])
        elif v == 0x80:
            out += b"\x80\x00"
        else:
            out += bytes([v]) * run
        i = j
    return bytes(out)


def sun_rows(a: np.ndarray, depth: int, rgb_order: bool = False,
             pad: bool = True) -> bytes:
    """The rows of `a` (bool [H, W] for depth 1, values 0-15 for 4, uint8
    [H, W] for 8, [H, W, 3] for 24 and 32) as SUN stores them, each padded
    to 16 bits when `pad`."""
    H, W = a.shape[:2]
    if depth == 1:
        rows = np.packbits(~a.astype(bool), axis=1)
    elif depth == 4:
        v = np.zeros((H, W + W % 2), np.uint8)
        v[:, :W] = a
        rows = (v[:, 0::2] << 4) | v[:, 1::2]
    elif depth == 8:
        rows = a.astype(np.uint8)
    else:
        px = a if rgb_order else a[..., ::-1]
        if depth == 32:
            px = np.concatenate([px, np.full((H, W, 1), 0x5A, np.uint8)], -1)
        rows = px.reshape(H, -1)
    rows = np.ascontiguousarray(rows)
    if pad and rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((H, 1), np.uint8)], 1)
    return rows.tobytes()


def sun(a: np.ndarray, depth: int, ftype: int = 1,
        palette: bytes | None = None, ptype: int = 1) -> bytes:
    """A SUN raster of `a` at `depth`: file type 2 RLE-codes unpadded rows
    (as Pillow's decoder reads them), 3 stores RGB order, others BGR."""
    H, W = a.shape[:2]
    if ftype == 2:
        body = sun_rle(sun_rows(a, depth, pad=False))
    else:
        body = sun_rows(a, depth, rgb_order=ftype == 3)
    pal = palette or b""
    return struct.pack(">8I", SUN_MAGIC, W, H, depth, len(body), ftype,
                       ptype if pal else 0, len(pal)) + pal + body


# ------------------------------------------------------------------ XPM
XPM_CHARS = (b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
             b"0123456789+@$%&*=-;:>,<')!~^/(_`|]}[{")


def xpm_keys(n: int, cpp: int) -> list:
    """n distinct keys of cpp characters."""
    chars = XPM_CHARS
    keys = []
    for i in range(n):
        k = b""
        for _ in range(cpp):
            k = chars[i % len(chars):i % len(chars) + 1] + k
            i //= len(chars)
        keys.append(k)
    return keys


def xpm(idx: np.ndarray, colours: np.ndarray, cpp: int = 1,
        none: int | None = None, pixels_comment: bool = True,
        comments: bool = True) -> bytes:
    """An XPM of indices `idx` [H, W] into `colours` [n, 3] uint8 ("c
    #rrggbb" each; index `none` as "c None"), keys of cpp characters."""
    H, W = idx.shape
    keys = xpm_keys(len(colours), cpp)
    lines = [b"/* XPM */", b"static char *image[] = {"]
    if comments:
        lines.append(b"/* columns rows colors chars-per-pixel */")
    lines.append(b'"%d %d %d %d",' % (W, H, len(colours), cpp))
    for i, (k, c) in enumerate(zip(keys, colours)):
        spec = b"None" if i == none else b"#%02x%02x%02x" % tuple(
            int(v) for v in c)
        lines.append(b'"' + k + b" c " + spec + b'",')
    if pixels_comment:
        lines.append(b"/* pixels */")
    table = np.array([list(k) for k in keys], np.uint8)
    for y in range(H):
        row = table[idx[y]].tobytes()
        lines.append(b'"' + row + (b'"' if y == H - 1 else b'",'))
    lines.append(b"};")
    return b"\n".join(lines) + b"\n"


# ---------------------------------------------------------------- PIXAR
def pixar(rgb: np.ndarray, mode: tuple = (14, 2)) -> bytes:
    """A PIXAR raster: the 512-byte header (width at 418, height at 416,
    its mode words at 424 and 426), zeros to 1024, RGB rows."""
    H, W = rgb.shape[:2]
    h = bytearray(1024)
    h[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", h, 416, H, W)
    struct.pack_into("<HH", h, 424, *mode)
    return bytes(h) + np.ascontiguousarray(rgb, np.uint8).tobytes()


# --------------------------------------------------------------- McIdas
def mcidas(a: np.ndarray, nbytes: int, prefix: int = 0, bands: int = 1,
           offset: int = 256) -> bytes:
    """A McIdas area of `a` [H, W] (nbytes 1, 2 or 4 big-endian a sample):
    the 64-word directory (word 9 lines, 10 elements, 11 bytes a sample,
    14 bands, 15 the line prefix's bytes, 34 the data's offset), each line
    `prefix` bytes, then the samples, then filler for the other bands
    (Pillow reads the first)."""
    H, W = a.shape
    w = [0] * 65
    w[2] = 4
    w[9], w[10], w[11], w[14], w[15], w[34] = H, W, nbytes, bands, prefix, \
        offset
    head = struct.pack("!64i", *w[1:])
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    rows = np.ascontiguousarray(a).astype(dt).view(np.uint8).reshape(H, -1)
    body = np.concatenate([
        np.full((H, prefix), 0xEE, np.uint8), rows,
        np.full((H, W * nbytes * (bands - 1)), 0xDD, np.uint8)], 1)
    return head + bytes(max(offset - 256, 0)) + body.tobytes()


# ------------------------------------------------------------------ GBR
def gbr(a: np.ndarray, version: int = 2, comment: bytes = b"brush") -> bytes:
    """A GIMP brush: "L" from [H, W], "RGBA" from [H, W, 4]."""
    H, W = a.shape[:2]
    depth = 1 if a.ndim == 2 else 4
    name = comment + b"\0"
    size = (20 if version == 1 else 28) + len(name)
    head = struct.pack(">5I", size, version, W, H, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 25)
    return head + name + np.ascontiguousarray(a, np.uint8).tobytes()


# ------------------------------------------------------------------ IMT
def imt(grey: np.ndarray, comments: bool = True) -> bytes:
    """An IM Tools file: "width", "height" and "pixel n8" lines (and "*"
    comments), then a form feed and the rows."""
    H, W = grey.shape
    lines = [b"* IM tools image"] if comments else []
    lines += [b"width %d" % W, b"height %d" % H, b"pixel n8"]
    return b"\n".join(lines) + b"\n\x0c" + grey.astype(np.uint8).tobytes()


# ------------------------------------------------------------ XV thumb
def xv_thumb(idx: np.ndarray, comments=(b"#XVVERSION:Version 3.10a",
                                        b"#END_OF_COMMENTS")) -> bytes:
    """An XV thumbnail ("P7 332"): comment lines, "W H 255", then the 3:3:2
    indices."""
    H, W = idx.shape
    head = b"P7 332\n" + b"".join(c + b"\n" for c in comments)
    return head + b"%d %d 255\n" % (W, H) + idx.astype(np.uint8).tobytes()


# ----------------------------------------------------------------- FITS
def fits_card(key: str, value) -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
    elif isinstance(value, str):
        v = f"'{value:<8}'"
    else:
        v = str(value)
    return f"{key:<8}= {v:>20}".encode().ljust(80)


def fits_header(cards: list) -> bytes:
    """Cards (each (key, value) or 80 bytes) + END, padded to 2880."""
    out = b"".join(c if isinstance(c, bytes) else fits_card(*c)
                   for c in cards) + b"END".ljust(80)
    return out + b" " * (-len(out) % 2880)


def fits(data: np.ndarray, bitpix: int, extra_cards=()) -> bytes:
    """A primary FITS image of `data` [H, W] (rows as stored: the first
    row is the image's bottom in Pillow), big-endian, padded to 2880."""
    H, W = data.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    head = fits_header([("SIMPLE", True), ("BITPIX", bitpix), ("NAXIS", 2),
                        ("NAXIS1", W), ("NAXIS2", H), *extra_cards])
    body = np.ascontiguousarray(data).astype(dt).tobytes()
    return head + body + bytes(-len(body) % 2880)


def fits_gzip(values: np.ndarray, bitpix: int, pad: bool = False) -> bytes:
    """A GZIP_1 tile-compressed image (one tile, a BINTABLE of one row)
    whose gzip member holds `values` [H, W] as big-endian int32 words, as
    Pillow's fits_gzip decoder reads them; `pad` pads the heap to 2880."""
    H, W = values.shape
    member = gzip.compress(np.ascontiguousarray(values).astype(
        ">i4").tobytes(), mtime=0)
    primary = fits_header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
                           ("EXTEND", True)])
    ext = fits_header([
        ("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
        ("NAXIS1", 8), ("NAXIS2", 1), ("PCOUNT", len(member)),
        ("GCOUNT", 1), ("TFIELDS", 1), ("TTYPE1", "COMPRESSED_DATA"),
        ("TFORM1", "1PB"), ("ZIMAGE", True), ("ZBITPIX", bitpix),
        ("ZNAXIS", 2), ("ZNAXIS1", W), ("ZNAXIS2", H), ("ZTILE1", W),
        ("ZTILE2", H), ("ZCMPTYPE", "GZIP_1")])
    table = struct.pack(">ii", len(member), 0)
    body = table + member
    return primary + ext + body + (bytes(-len(body) % 2880) if pad else b"")


# ------------------------------------------------------------------ FLI
def fli_header(W: int, H: int, frames: int = 1, magic: int = 0xAF12,
               flags: int = 3) -> bytes:
    h = bytearray(128)
    struct.pack_into("<IHHHHHHI", h, 0, 0, magic, frames, W, H, 8, flags,
                     5)
    return bytes(h)


def fli_chunk(kind: int, body: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_frame(chunks: list, size: int | None = None) -> bytes:
    body = b"".join(chunks)
    return struct.pack("<IHH8x", 16 + len(body) if size is None else size,
                       0xF1FA, len(chunks)) + body


def fli_colour(palette: np.ndarray, kind: int = 4) -> bytes:
    """A COLOR256 (4) or COLOR64 (11) chunk setting all 256 entries."""
    return fli_chunk(kind, struct.pack("<HBB", 1, 0, 0) + np.ascontiguousarray(
        palette, np.uint8).tobytes())


def fli_brun(img: np.ndarray) -> bytes:
    """BRUN: each row a count byte, then runs (n < 128, value) and
    literals (256 - n, n bytes)."""
    out = bytearray()
    for row in img.astype(np.uint8):
        packets, x, W = bytearray(), 0, len(row)
        n = 0
        while x < W:
            j = x + 1
            while j < W and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 3 or W - x == 1:
                packets += bytes([j - x, row[x]])
                x = j
            else:
                k = x + 1
                while k < W and k - x < 127 and not (
                        k + 2 < W and row[k] == row[k + 1] == row[k + 2]):
                    k += 1
                packets += bytes([256 - (k - x)]) + row[x:k].tobytes()
                x = k
            n += 1
        out += bytes([n & 255]) + packets
    return fli_chunk(15, bytes(out))


def fli_lc(img: np.ndarray, prev: np.ndarray, runs: bool = True) -> bytes:
    """LC (byte delta) from `prev` to `img`: the first changed line, the
    count of lines, each a packet count and (skip, count, bytes) or (skip,
    256 - count, byte) packets."""
    H, W = img.shape
    changed = np.flatnonzero((img != prev).any(1))
    y0 = int(changed[0]) if changed.size else 0
    y1 = int(changed[-1]) + 1 if changed.size else 0
    out = bytearray(struct.pack("<HH", y0, y1 - y0))
    for y in range(y0, y1):
        row, old = img[y].astype(np.uint8), prev[y]
        packets, x, last = bytearray(), 0, 0
        n = 0
        while x < W:
            if row[x] == old[x]:
                x += 1
                continue
            skip = x - last
            while skip > 255:
                packets += bytes([255, 0])
                skip -= 255
                n += 1
            j = x + 1
            while j < W and row[j] == row[x] and j - x < 127:
                j += 1
            if runs and j - x >= 3:
                packets += bytes([skip, 256 - (j - x), row[x]])
            else:
                j = x + 1
                while j < W and j - x < 127 and row[j] != old[j]:
                    j += 1
                packets += bytes([skip, j - x]) + row[x:j].tobytes()
            n += 1
            x = last = j
        out += bytes([n]) + packets
    return fli_chunk(12, bytes(out))


def fli_ss2(img: np.ndarray, prev: np.ndarray) -> bytes:
    """SS2 (word delta) from `prev` to `img` (W even but for the odd last
    byte word): lines with a change, skipped lines as 0xC000 words, each
    line's packets (skip, word count, words) or (skip, 256 - n, word)."""
    H, W = img.shape
    ww = W // 2 * 2
    lines = []
    skip_lines = 0
    for y in range(H):
        row, old = img[y].astype(np.uint8), prev[y]
        if (row == old).all():
            skip_lines += 1
            continue
        words = bytearray()
        if skip_lines:
            words += struct.pack("<H", (65536 - skip_lines) & 0xFFFF)
        skip_lines = 0
        if W % 2 and row[W - 1] != old[W - 1]:
            words += struct.pack("<H", 0x8000 | int(row[W - 1]))
        packets, n, x, last = bytearray(), 0, 0, 0
        while x < ww:
            if row[x] == old[x] and row[x + 1] == old[x + 1]:
                x += 2
                continue
            skip = x - last
            while skip > 255:
                packets += bytes([254, 0])
                skip -= 254
                n += 1
            j = x + 2
            while (j < ww and row[j] == row[x] and row[j + 1] == row[x + 1]
                   and (j - x) // 2 < 127):
                j += 2
            if (j - x) // 2 >= 2:
                packets += bytes([skip, 256 - (j - x) // 2, row[x],
                                  row[x + 1]])
            else:
                j = x + 2
                while j < ww and (j - x) // 2 < 127 and not (
                        row[j] == old[j] and row[j + 1] == old[j + 1]):
                    j += 2
                packets += bytes([skip, (j - x) // 2]) + row[x:j].tobytes()
            n += 1
            x = last = j
        lines.append(bytes(words) + struct.pack("<H", n) + bytes(packets))
    return fli_chunk(7, struct.pack("<H", len(lines)) + b"".join(lines))


def fli(W: int, H: int, chunks: list, prefix: bytes | None = None,
        frames: int = 1, magic: int = 0xAF12, tail: bytes = b"") -> bytes:
    """An FLI/FLC file of one frame of `chunks` (a prefix chunk 0xF100
    before it when `prefix` is given), then `tail`."""
    pre = b""
    if prefix is not None:
        pre = struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    return fli_header(W, H, frames, magic) + pre + fli_frame(chunks) + tail


# ------------------------------------------------------------------ PCD
PCD_W, PCD_H = 768, 512


def pcd(planes: bytes, orientation: int = 0) -> bytes:
    """A PhotoCD file whose base image (offset 96 * 2048) is `planes`:
    256 chunks of two luma rows (768 bytes each) then the pair's two chroma
    rows (384 bytes each); byte 2048 + 1538 holds the orientation."""
    head = bytearray(96 * 2048)
    head[2048:2048 + 7] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    return bytes(head) + planes


def pcd_planes(y: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> bytes:
    """y [512, 768], c1 and c2 [256, 384] -> the base image's bytes."""
    out = np.empty((256, 3 * PCD_W), np.uint8)
    out[:, :PCD_W] = y[0::2]
    out[:, PCD_W:2 * PCD_W] = y[1::2]
    out[:, 2 * PCD_W:2 * PCD_W + PCD_W // 2] = c1
    out[:, 2 * PCD_W + PCD_W // 2:] = c2
    return out.tobytes()


# ----------------------------------------------------------------- IPTC
def iptc_record(rec: int, tag: int, data: bytes, ext: int = 0) -> bytes:
    """One 0x1C record: a two-byte size, or with `ext` bytes an extended
    size (0x80 + ext, then the size in ext bytes)."""
    if ext:
        return bytes([0x1C, rec, tag, 0x80 + ext]) + len(data).to_bytes(
            ext, "big") + data
    return bytes([0x1C, rec, tag]) + struct.pack(">H", len(data)) + data


def iptc(W: int, H: int, layers: int, component: int, payload: bytes,
         compression: int = 1, band: int | None = None,
         chunk: int = 30000, trailer: bytes = b"") -> bytes:
    """An IPTC/NAA image: (3,20) width, (3,30) height, (3,60) layers and
    component flag, (3,65) the band (1-based) when given, (3,120) the
    compression (1 raw, 5 JPEG), then (8,10) records of at most `chunk`
    bytes of the payload."""
    recs = [iptc_record(1, 90, b"\x1b%G"), iptc_record(2, 5, b"frame"),
            iptc_record(3, 20, struct.pack(">H", W)),
            iptc_record(3, 30, struct.pack(">H", H)),
            iptc_record(3, 60, bytes([layers, component]))]
    if band is not None:
        recs.append(iptc_record(3, 65, bytes([band])))
    recs.append(iptc_record(3, 120, bytes([compression])))
    for i in range(0, max(len(payload), 1), chunk):
        part = payload[i:i + chunk]
        recs.append(iptc_record(8, 10, part, ext=4 if len(part) > 32767
                                else 0))
    return b"".join(recs) + trailer


# ------------------------------------------------------- JP2 with a pclr
def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_palette(codestream: bytes, W: int, H: int, entries: np.ndarray,
                alpha: bool = False, cmap: bool = True) -> bytes:
    """A JP2 file around a one-component (two with `alpha`) codestream of
    W x H with a pclr box of `entries` [n, npc] 8-bit values (and a cmap
    box), colr sRGB: Pillow reads it as "P" ("PA"), the indices."""
    nc = 2 if alpha else 1
    ne, npc = entries.shape
    pclr = struct.pack(">HB", ne, npc) + bytes([7] * npc) + np.ascontiguousarray(
        entries, np.uint8).tobytes()
    boxes = jp2_box(b"ihdr", struct.pack(">IIHBBBB", H, W, nc, 7, 7, 0, 0))
    boxes += jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
    boxes += jp2_box(b"pclr", pclr)
    if cmap:
        boxes += jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                           for i in range(npc)))
    return (jp2_box(b"jP  ", b"\r\n\x87\n")
            + jp2_box(b"ftyp", b"jp2 " + b"\0\0\0\0" + b"jp2 ")
            + jp2_box(b"jp2h", boxes) + jp2_box(b"jp2c", codestream))
