"""Writers for the legacy image forms Pillow reads but does not write: the
test side of the readers in data/tiff.py, sgi.py, pcx.py and ico.py
(tests/test_torch_legacyforms.py and its committed fixtures), never used by
``main``.

* ``tiff_file``: a little-endian TIFF of one image from its tags, strips and
  the blocks its offset tags point at;
* ``fax_mh``: ITU-T T.4 one-dimensional (modified Huffman) rows, each
  aligned to 8 or 16 bits (TIFF compression 2 and 32771, RLEW);
* ``thunderscan``: 4-bit rows in ThunderScan's run, delta and raw codes;
* ``old_jpeg_jif`` and ``old_jpeg_tables``: old-style JPEG TIFF
  (compression 6), a whole JPEG stream at JPEGInterchangeFormat, or the
  tables in JPEGQTables/JPEGDCTables/JPEGACTables and bare scan data in
  each strip (one restart interval a strip);
* ``sgi``: SGI files, verbatim or RLE, 8 or 16 bits a sample;
* ``pcx`` and ``dcx``: PCX at 1 bit in 1, 2 or 4 planes or 8 bits in 1 or
  3 planes, and DCX around PCX pages;
* ``dib`` and ``icon``: ICO and CUR files of BMP (DIB) entries at 1, 4, 8,
  24 and 32 bits a pixel with their AND masks, or of PNG entries.

Every writer is numpy and plain Python; the JPEG scans come from
data/jpeg.py's baseline encoder.
"""

from __future__ import annotations

import struct

import numpy as np

_FORMATS = {1: "B", 3: "H", 4: "I", 7: "B"}


def tiff_file(tags: dict, strips: list, blobs: dict | None = None,
              tiles: bool = False) -> bytes:
    """tags {tag: (type, values)} (3 SHORT, 4 LONG, 5 RATIONAL as (num,
    den) pairs, 7 UNDEFINED bytes); StripOffsets and StripByteCounts are
    set from `strips`, each bytes or (blob tag, index, start, end): a slice
    of a block of `blobs` {tag: [bytes, ...]}, which are written first with
    their tag set to their offsets; with `tiles`, TileOffsets and
    TileByteCounts instead."""
    out = bytearray(b"II*\0\0\0\0\0")
    tags = dict(tags)

    def put(b: bytes) -> int:
        if len(out) % 2:
            out.append(0)
        off = len(out)
        out.extend(b)
        return off

    where = {}
    for tag, blocks in (blobs or {}).items():
        where[tag] = [put(b) for b in blocks]
        tags[tag] = (4, where[tag])
    offs, counts = [], []
    for s in strips:
        if isinstance(s, tuple):
            tag, i, start, end = s
            offs.append(where[tag][i] + start)
            counts.append(end - start)
        else:
            offs.append(put(s))
            counts.append(len(s))
    at = (324, 325) if tiles else (273, 279)
    tags[at[0]], tags[at[1]] = (4, offs), (4, counts)
    if len(out) % 2:
        out.append(0)
    ifd = len(out)
    struct.pack_into("<I", out, 4, ifd)
    entries = sorted(tags.items())
    tail_at = ifd + 2 + 12 * len(entries) + 4
    tail = bytearray()
    body = bytearray(struct.pack("<H", len(entries)))
    for tag, (typ, values) in entries:
        values = list(values)
        if typ == 5:
            raw = b"".join(struct.pack("<II", *v) for v in values)
        else:
            raw = struct.pack(f"<{len(values)}{_FORMATS[typ]}", *values)
        count = len(values)
        if len(raw) <= 4:
            body += struct.pack("<HHI", tag, typ, count) + raw.ljust(4, b"\0")
        else:
            body += struct.pack("<HHII", tag, typ, count, tail_at + len(tail))
            tail += raw + b"\0" * (len(raw) % 2)
    body += b"\0\0\0\0"
    return bytes(out + body + tail)


def image_tags(width: int, height: int, bits, photometric: int,
               compression: int, rows_per_strip: int | None = None,
               **more) -> dict:
    """The usual tags of a strip TIFF; `more` {name: (type, values)} with
    names t<tag> add or replace tags."""
    bits = tuple(bits)
    tags = {256: (4, [width]), 257: (4, [height]), 258: (3, list(bits)),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [len(bits)]),
            278: (4, [rows_per_strip or height])}
    for k, v in more.items():
        tags[int(k[1:])] = v
    return tags


# ------------------------------------------------------------- CCITT fax
# ITU-T T.4 tables 2 and 3 (terminating codes 0-63, make-up codes 64-1728,
# and the make-up codes of both colours 1792-2560)
_WHITE = """
00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000
001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 0010111
0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010 00000011
00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111
00101000 00101001 00101010 00101011 00101100 00101101 00000100 00000101
00001010 00001011 01010010 01010011 01010100 01010101 00100100 00100101
01011000 01011001 01011010 01011011 01001010 01001011 00110010 00110011
00110100""".split()
_BLACK = """
0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101
0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000
00001100111 00001101000 00001101100 00000110111 00000101000 00000010111
00000011000 000011001010 000011001011 000011001100 000011001101
000001101000 000001101001 000001101010 000001101011 000011010010
000011010011 000011010100 000011010101 000011010110 000011010111
000001101100 000001101101 000011011010 000011011011 000001010100
000001010101 000001010110 000001010111 000001100100 000001100101
000001010010 000001010011 000000100100 000000110111 000000111000
000000100111 000000101000 000001011000 000001011001 000000101011
000000101100 000001011010 000001100110 000001100111""".split()
_WHITE_MAKEUP = """
11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000
01100111 011001100 011001101 011010010 011010011 011010100 011010101
011010110 011010111 011011000 011011001 011011010 011011011 010011000
010011001 010011010 011000 010011011""".split()
_BLACK_MAKEUP = """
0000001111 000011001000 000011001001 000001011011 000000110011
000000110100 000000110101 0000001101100 0000001101101 0000001001010
0000001001011 0000001001100 0000001001101 0000001110010 0000001110011
0000001110100 0000001110101 0000001110110 0000001110111 0000001010010
0000001010011 0000001010100 0000001010101 0000001011010 0000001011011
0000001100100 0000001100101""".split()
_EXT_MAKEUP = """
00000001000 00000001100 00000001101 000000010010 000000010011 000000010100
000000010101 000000010110 000000010111 000000011100 000000011101
000000011110 000000011111""".split()


def _run_code(n: int, black: bool) -> str:
    term = _BLACK if black else _WHITE
    makeup = _BLACK_MAKEUP if black else _WHITE_MAKEUP
    out = ""
    while n > 2560:
        out += _EXT_MAKEUP[-1]
        n -= 2560
    if n >= 1792:
        out += _EXT_MAKEUP[(n - 1792) // 64]
        n %= 64
    elif n >= 64:
        out += makeup[n // 64 - 1]
        n %= 64
    return out + term[n]


def fax_mh(black: np.ndarray, align: int = 8) -> bytes:
    """T.4 one-dimensional coding of a bool [H, W] image (True black), each
    row starting on a multiple of `align` bits (8: compression 2, 16:
    RLEW, 32771), most significant bit first."""
    bits = []
    for row in np.asarray(black, bool):
        change = np.flatnonzero(row[1:] != row[:-1]) + 1
        runs = list(np.diff(np.r_[0, change, row.size]))
        if row[0]:
            runs = [0] + runs
        code = "".join(_run_code(int(n), k % 2 == 1)
                       for k, n in enumerate(runs))
        code += "0" * (-len(code) % align)
        bits.append(code)
    s = "".join(bits)
    return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


# ------------------------------------------------------------ ThunderScan
def thunderscan(g: np.ndarray) -> bytes:
    """[H, W] 4-bit samples (0-15) as ThunderScan rows: runs of the last
    pixel (up to 63), two 3-bit or three 2-bit deltas where they fit, raw
    codes otherwise."""
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in np.asarray(g, np.int64):
        last, x, w = 0, 0, row.size
        while x < w:
            n = 0
            while x + n < w and row[x + n] == last and n < 63:
                n += 1
            if n >= 2:
                out.append(n)
                x += n
                continue
            d = [int(v) - int(p) for p, v in zip(
                np.r_[last, row[x:x + 2]], row[x:x + 3])]
            if len(d) == 3 and all(v in two for v in d):
                out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
                x, last = x + 3, int(row[x + 2])
            elif len(d) >= 2 and all(v in three for v in d[:2]):
                out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                x, last = x + 2, int(row[x + 1])
            else:
                out.append(0xC0 | int(row[x]))
                x, last = x + 1, int(row[x])
    return bytes(out)


# -------------------------------------------------------- old-style JPEG
def _jpeg_parts(jpeg: bytes) -> tuple:
    """(DQT bodies, DHT bodies, the offset of the scan data, of the EOI)
    of a baseline file from data/jpeg.py's encoder."""
    dqt, dht, pos = [], [], 2
    while True:
        m, n = jpeg[pos + 1], struct.unpack_from(">H", jpeg, pos + 2)[0]
        body = jpeg[pos + 4:pos + 2 + n]
        if m == 0xDB:
            dqt.append(body)
        elif m == 0xC4:
            dht.append(body)
        pos += 2 + n
        if m == 0xDA:
            return dqt, dht, pos, len(jpeg) - 2


_SAMPLING = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0"}


def old_jpeg_jif(rgb: np.ndarray, sampling=(2, 2), quality: int = 85,
                 tag_sampling=None, photometric: int = 6) -> bytes:
    """An old-style JPEG TIFF whose JPEGInterchangeFormat holds a whole
    JFIF stream of `rgb` (one strip, its offset at the scan data);
    YCbCrSubsampling is `tag_sampling` (None: no tag)."""
    from ..data.jpeg import encode_jpeg
    H, W = rgb.shape[:2]
    jpeg = encode_jpeg(rgb, quality, _SAMPLING[tuple(sampling)])
    _, _, scan, eoi = _jpeg_parts(jpeg)
    more = {"t512": (3, [1]), "t514": (4, [len(jpeg)])}
    if tag_sampling is not None:
        more["t530"] = (3, list(tag_sampling))
    tags = image_tags(W, H, (8, 8, 8), photometric, 6, H, **more)
    return tiff_file(tags, [(513, 0, scan, eoi)], {513: [jpeg]})


def old_jpeg_tables(img: np.ndarray, sampling=(2, 2), quality: int = 85,
                    rows_per_strip: int | None = None,
                    restart_tag: bool = False) -> bytes:
    """An old-style JPEG TIFF of `img` (RGB, or [H, W] grey) with its
    tables in JPEGQTables, JPEGDCTables and JPEGACTables (one a sample:
    luma, then chroma for Cb and Cr) and each strip of `rows_per_strip`
    rows a bare scan, one restart interval (libtiff puts RSTn between the
    strips); JPEGRestartInterval written when `restart_tag`."""
    from ..data.jpeg import encode_jpeg
    H, W = img.shape[:2]
    rps = rows_per_strip or H
    grey = img.ndim == 2
    strips, dqt, dht = [], None, None
    for y in range(0, H, rps):
        jpeg = encode_jpeg(img[y:y + rps], quality,
                           "4:4:4" if grey else _SAMPLING[tuple(sampling)])
        q, h, scan, eoi = _jpeg_parts(jpeg)
        dqt, dht = dqt or q, dht or h
        strips.append(jpeg[scan:eoi])
    # data/jpeg.py writes one DQT of both tables, and the four DHTs
    qtab = [b[1:65] for b in [dqt[0][:65], dqt[0][65:130]]] if len(
        dqt) == 1 else [b[1:65] for b in dqt]
    hts = {}
    for body in dht:
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            n = 16 + sum(body[pos + 1:pos + 17])
            hts[tc_th] = body[pos + 1:pos + 1 + n]
            pos += 1 + n
    nc = 1 if grey else 3
    pick = [0] + [1] * (nc - 1)
    blobs = {519: [qtab[k] for k in pick],
             520: [hts[k] for k in pick],
             521: [hts[0x10 | k] for k in pick]}
    more = {"t512": (3, [1])}
    if not grey:
        more["t530"] = (3, list(sampling))
    if restart_tag:
        more["t515"] = (3, [0])
    tags = image_tags(W, H, (8,) * nc, 1 if grey else 6, 6, rps, **more)
    return tiff_file(tags, strips, blobs)


# ---------------------------------------------------------------- SGI
def _sgi_rle_row(v: np.ndarray) -> bytes:
    """SGI RLE of one channel's row of 1- or 2-byte samples: runs of up to
    127 equal samples, literals of up to 127, a zero count at the end."""
    wide = v.dtype.itemsize == 2
    out = bytearray()

    def unit(c: int) -> bytes:
        return struct.pack(">H", c) if wide else bytes([c])

    x, n = 0, v.size
    while x < n:
        r = 1
        while x + r < n and v[x + r] == v[x] and r < 127:
            r += 1
        if r >= 3:
            out += unit(r) + unit(int(v[x]))
            x += r
            continue
        start = x
        while x < n and x - start < 127:
            if x + 2 < n and v[x] == v[x + 1] == v[x + 2]:
                break
            x += 1
        out += unit(0x80 | (x - start))
        for s in v[start:x]:
            out += unit(int(s))
    return bytes(out + unit(0))


def sgi(img: np.ndarray, rle: bool = True, name: bytes = b"") -> bytes:
    """An SGI file of `img`: uint8 or uint16 (2 bytes a sample), [H, W]
    (dimension 2), [W] as [1, W] (dimension 1) or [H, W, C] (dimension 3),
    rows bottom up, verbatim or RLE."""
    img = np.asarray(img)
    dim = 1 if img.ndim == 1 else 2 if img.ndim == 2 else 3
    a = img.reshape(1, -1, 1) if dim == 1 else (
        img[..., None] if dim == 2 else img)
    H, W, C = a.shape
    bpc = a.dtype.itemsize
    a = a[::-1].astype(">u2" if bpc == 2 else np.uint8)
    head = struct.pack(">hBBHHHHii4s", 474, int(rle), bpc, dim, W, H, C, 0,
                       255 if bpc == 1 else 65535, b"\0" * 4)
    head = head + name[:79].ljust(80, b"\0") + struct.pack(">i", 0)
    head = head.ljust(512, b"\0")
    if not rle:
        return head + np.ascontiguousarray(a.transpose(2, 0, 1)).tobytes()
    rows = [[_sgi_rle_row(a[y, :, c]) for y in range(H)] for c in range(C)]
    starts, lens = [], []
    pos = 512 + 8 * H * C
    body = bytearray()
    for c in range(C):
        for y in range(H):
            starts.append(pos + len(body))
            lens.append(len(rows[c][y]))
            body += rows[c][y]
    return head + struct.pack(f">{H * C}I", *starts) + struct.pack(
        f">{H * C}I", *lens) + bytes(body)


# ------------------------------------------------------------ PCX, DCX
def _pcx_rle(line: bytes) -> bytes:
    out = bytearray()
    x, n = 0, len(line)
    while x < n:
        r = 1
        while x + r < n and line[x + r] == line[x] and r < 63:
            r += 1
        if r > 1 or line[x] >= 0xC0:
            out += bytes([0xC0 | r, line[x]])
        else:
            out.append(line[x])
        x += r
    return bytes(out)


def pcx(img: np.ndarray, bits: int = 1, planes: int = 1,
        palette: bytes = b"", version: int = 5,
        end_palette: bytes | None = None, even: bool = True) -> bytes:
    """A PCX file: `img` [H, W] indices (1 bit in `planes` 1, 2 or 4: plane
    k holds bit k; 8 bits in one plane) or [H, W, 3] (8 bits, 3 planes); a
    16-colour header `palette` and, for 8 bits, the 769-byte palette at
    the end (`end_palette`: 768 bytes).  Each plane's line is padded to an
    even length unless `even` is False."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    stride = (W * bits + 7) // 8
    stride += stride % 2 if even else 0
    lines = []
    for y in range(H):
        if img.ndim == 3:
            ps = [img[y, :, k] for k in range(3)]
        elif bits == 1:
            ps = [np.packbits((img[y] >> k) & 1) for k in range(planes)]
        else:
            ps = [img[y]]
        lines.append(b"".join(bytes(p).ljust(stride, b"\0") for p in ps))
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, W - 1,
                       H - 1, 72, 72)
    head += palette[:48].ljust(48, b"\0") + bytes([0, planes])
    head += struct.pack("<HH", stride, 1)
    head = head.ljust(128, b"\0")
    out = head + b"".join(_pcx_rle(l) for l in lines)
    if end_palette is not None:
        out += b"\x0c" + end_palette
    return out


def dcx(pages: list) -> bytes:
    """A DCX file of PCX pages."""
    head = struct.pack("<I", 0x3ADE68B1)
    pos = 4 + 4 * (len(pages) + 1)
    offs = []
    for p in pages:
        offs.append(pos)
        pos += len(p)
    return head + struct.pack(f"<{len(pages) + 1}I", *offs, 0) + b"".join(
        pages)


# ------------------------------------------------------------- ICO, CUR
def dib(img: np.ndarray, bpp: int, palette: np.ndarray | None = None,
        mask: np.ndarray | None = None) -> bytes:
    """A BMP entry of an icon: BITMAPINFOHEADER with the height doubled,
    the palette (BGRX) for bpp <= 8, the XOR bitmap and the AND mask (1
    where transparent), both rows bottom up.  `img`: [H, W] indices for
    bpp <= 8, [H, W, 3] RGB for 24, [H, W, 4] RGBA for 32."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    colours = 0 if bpp > 8 else 1 << bpp
    head = struct.pack("<IiiHHIIiiII", 40, W, 2 * H, 1, bpp, 0, 0, 0, 0,
                       colours, 0)
    pal = b""
    if bpp <= 8:
        p = np.zeros((colours, 4), np.uint8)
        p[:len(palette), :3] = np.asarray(palette, np.uint8)[:colours, ::-1]
        pal = p.tobytes()
    stride = ((W * bpp + 31) >> 3) & ~3
    rows = []
    for y in range(H - 1, -1, -1):
        r = img[y]
        if bpp <= 8:
            per = 8 // bpp
            v = np.zeros(-(-W // per) * per, np.uint8)
            v[:W] = r
            v = v.reshape(-1, per)
            shifts = np.arange(8 - bpp, -1, -bpp)
            raw = (v << shifts).sum(1).astype(np.uint8).tobytes()
        elif bpp == 24:
            raw = r[:, ::-1].tobytes()
        else:
            raw = r[:, [2, 1, 0, 3]].tobytes()
        rows.append(raw.ljust(stride, b"\0"))
    m = np.zeros((H, W), bool) if mask is None else np.asarray(mask, bool)
    mstride = ((W + 31) >> 3) & ~3
    mrows = [np.packbits(m[y]).tobytes().ljust(mstride, b"\0")
             for y in range(H - 1, -1, -1)]
    return head + pal + b"".join(rows) + b"".join(mrows)


def icon(entries: list, kind: int = 1) -> bytes:
    """An ICO (`kind` 1) or CUR (2) file: entries (width, height, colours,
    planes or hotspot x, bpp or hotspot y, data) written in order, a width
    or height of 256 as 0."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    pos = 6 + 16 * len(entries)
    body = b""
    for w, h, colours, planes, bpp, data in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, planes,
                           bpp, len(data), pos + len(body))
        body += data
    return out + body
