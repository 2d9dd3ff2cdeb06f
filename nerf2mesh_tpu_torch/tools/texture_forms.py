"""Writers for the texture and layered-image forms Pillow reads but writes
only in part: the test side of the readers in data/dds.py, ftex.py,
blp.py and psd.py (tests/test_torch_textureforms.py and its committed
fixtures), never used by ``main``.

* ``dds``: a DDS header for any pixel format (legacy masks, luminance,
  palette, FourCC, DX10) with the surface behind it;
* ``ftex``: an FTEX file of one format and its mipmaps;
* ``blp1_jpeg``, ``blp1_palette`` and ``blp2``: BLP files, the JPEG's
  tables in BLP1's header block and its scan as the first mipmap;
* ``psd``: a Photoshop file of any mode, raw or PackBits, with colour-mode
  data, image resources and, when asked, a layer section;
* block encoders: ``bc7_mode6`` (one subset, 7-bit endpoints with p-bits,
  4-bit indices), ``bc6h_mode3`` (the one-region mode of 10-bit
  endpoints, in BC6H's unsigned half space), ``bc4`` and ``bc6h_block``
  (any BC6H mode from endpoint values, through native/bcndec.cpp's
  packing table), and ``random_bc7``/``random_bc6h`` (random bytes with
  the mode bits set: every 8- or 16-byte string is a valid block).

Every writer is numpy and plain Python.
"""

from __future__ import annotations

import struct

import numpy as np

_WEIGHTS4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                      60, 64])


# ------------------------------------------------------------------- DDS
def dds(width: int, height: int, pfflags: int, fourcc: bytes = b"\0" * 4,
        bitcount: int = 0, masks=(0, 0, 0, 0), dxgi: int | None = None,
        body: bytes = b"", header_size: int = 124, mipmaps: int = 0,
        caps2: int = 0) -> bytes:
    """A DDS file: the 128-byte header (flags CAPS | HEIGHT | WIDTH |
    PIXELFORMAT, MIPMAPCOUNT when mipmaps), the DX10 header when `dxgi` is
    given (a 2-D texture, one array slice), then `body`."""
    flags = 0x1007 | (0x20000 if mipmaps else 0)
    caps = 0x1000 | (0x400008 if mipmaps else 0)
    head = b"DDS " + struct.pack("<7I", header_size, flags, height, width,
                                 0, 0, mipmaps)
    head += struct.pack("<11I", *(0,) * 11)
    head += struct.pack("<2I", 32, pfflags) + fourcc + struct.pack(
        "<I", bitcount) + struct.pack("<4I", *masks)
    head += struct.pack("<5I", caps, caps2, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def mask_pixels(img: np.ndarray, bitcount: int, masks) -> bytes:
    """Pixels of `bitcount` bits, channel c (uint8) scaled into masks[c]
    (the field's top bits), little-endian."""
    img = np.asarray(img, np.uint64)
    v = np.zeros(img.shape[:2], np.uint64)
    for c, m in enumerate(masks):
        if not m:
            continue
        shift = (m & -m).bit_length() - 1
        width = (m >> shift).bit_length()
        v |= ((img[..., c] >> np.uint64(max(8 - width, 0)))
              << np.uint64(shift)) & np.uint64(m)
    nbytes = bitcount // 8
    return v.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :nbytes].tobytes()


# ------------------------------------------------------------- BC blocks
def _blocks(img: np.ndarray) -> np.ndarray:
    """[H, W, C] -> [blocks, 16, C], the image padded to whole blocks by
    repeating its last row and column."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W = img.shape[:2]
    ph, pw = -H % 4, -W % 4
    img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    bh, bw = img.shape[0] // 4, img.shape[1] // 4
    return img.reshape(bh, 4, bw, 4, -1).transpose(0, 2, 1, 3, 4).reshape(
        bh * bw, 16, -1)


def _pack(fields: list, nblocks: int) -> np.ndarray:
    """[(values [blocks] or scalar, bits), ...] LSB first -> [blocks, 16]."""
    acc = [0] * nblocks
    pos = 0
    for vals, bits in fields:
        vals = np.broadcast_to(np.asarray(vals, np.int64), (nblocks,))
        for b in range(nblocks):
            acc[b] |= (int(vals[b]) & ((1 << bits) - 1)) << pos
        pos += bits
    assert pos == 128, pos
    return np.array([list(a.to_bytes(16, "little")) for a in acc], np.uint8)


def _choose(target: np.ndarray, e0: np.ndarray, e1: np.ndarray,
            interp) -> np.ndarray:
    """Per pixel the 4-bit index whose interpolation of the endpoints
    (interp(e0, e1, w) -> [blocks, C]) is nearest the target [blocks, 16,
    C]; the anchor (pixel 0) below 8 by swapping the endpoints."""
    cand = np.stack([interp(e0, e1, w) for w in _WEIGHTS4], 1)
    err = ((target[:, :, None, :].astype(np.int64)
            - cand[:, None, :, :]) ** 2).sum(-1)
    return err.argmin(-1)


def bc7_mode6(rgba: np.ndarray) -> bytes:
    """BC7 mode 6 blocks of an [H, W, 4] uint8 image: endpoints the
    block's per-channel minimum and maximum (7 bits and a p-bit each), the
    nearest of the 16 interpolations a pixel."""
    px = _blocks(rgba).astype(np.int64)
    lo, hi = px.min(1), px.max(1)

    def quant(e):
        p = (np.round((e & 1).mean(1))).astype(np.int64)
        return e >> 1, p, (e >> 1 << 1) | p[:, None]

    q0, p0, e0 = quant(lo)
    q1, p1, e1 = quant(hi)

    def lerp(a, b, w):
        return ((64 - w) * a + w * b + 32) >> 6

    idx = _choose(px, e0, e1, lerp)
    swap = idx[:, 0] >= 8
    q0, q1 = np.where(swap[:, None], q1, q0), np.where(swap[:, None], q0, q1)
    p0, p1 = np.where(swap, p1, p0), np.where(swap, p0, p1)
    idx = np.where(swap[:, None], 15 - idx, idx)
    fields = [(1 << 6, 7)]
    for c in range(4):
        fields += [(q0[:, c], 7), (q1[:, c], 7)]
    fields += [(p0, 1), (p1, 1), (idx[:, 0], 3)]
    fields += [(idx[:, i], 4) for i in range(1, 16)]
    return _pack(fields, len(px)).tobytes()


def _half_q10(rgb: np.ndarray) -> np.ndarray:
    """uint8 channels -> BC6H unsigned 10-bit endpoint units: the half
    float of v / 255 through the decoder's finalize (half = U * 31 >> 6,
    U = q * 64 + 32)."""
    h = (rgb.astype(np.float32) / 255).astype(np.float16).view(np.uint16)
    return np.clip(np.round(h.astype(np.float64) / 31 - 0.5), 1, 1022
                   ).astype(np.int64)


def bc6h_mode3(rgb: np.ndarray) -> bytes:
    """BC6H blocks of an [H, W, 3] uint8 image in the one-region mode of
    raw 10-bit endpoints (mode bits 00011): endpoints the block's minimum
    and maximum in unsigned half space, the nearest of 16
    interpolations."""
    q = _half_q10(_blocks(rgb))
    q0, q1 = q.min(1), q.max(1)

    def lerp(a, b, w):
        return ((a * 64 + 32) * (64 - w) + (b * 64 + 32) * w) >> 6

    idx = _choose(q * 64 + 32, q0, q1, lerp)
    swap = idx[:, 0] >= 8
    q0, q1 = np.where(swap[:, None], q1, q0), np.where(swap[:, None], q0, q1)
    idx = np.where(swap[:, None], 15 - idx, idx)
    fields = [(3, 5)] + [(q0[:, c], 10) for c in range(3)] + [
        (q1[:, c], 10) for c in range(3)]
    fields += [(idx[:, 0], 3)] + [(idx[:, i], 4) for i in range(1, 16)]
    return _pack(fields, len(q)).tobytes()


def bc4(grey: np.ndarray) -> bytes:
    """BC4 blocks of an [H, W] uint8 image: endpoints the block's maximum
    and minimum (the eight-value form when they differ), the nearest of
    the eight values a pixel."""
    px = _blocks(grey)[..., 0].astype(np.int64)
    a0, a1 = px.max(1), px.min(1)
    k = np.arange(1, 7)
    inner = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    vals = np.concatenate([a0[:, None], a1[:, None], inner], 1)
    idx = np.abs(px[:, :, None] - vals[:, None, :]).argmin(-1)
    fields = [(a0, 8), (a1, 8)] + [(idx[:, i], 3) for i in range(16)]
    fields.append((0, 64))
    return _pack(fields, len(px))[:, :8].tobytes()


# BC6H: Pillow's mode index -> its mode bits and their count
BC6H_MODE_BITS = [(0, 2), (1, 2)] + [(2 + 4 * i, 5) for i in range(8)] + [
    (3 + 4 * i, 5) for i in range(4)]
BC6H_RESERVED = (19, 23, 27, 31)
# per mode: regions, endpoint bits (the deltas' bits are in _BC6H_DELTA)
BC6H_REGIONS = [2] * 10 + [1] * 4
BC6H_EPB = [10, 7, 11, 11, 11, 9, 8, 8, 8, 6, 10, 11, 12, 16]
_BC6H_DELTA = [(5, 5, 5), (6, 6, 6), (5, 4, 4), (4, 5, 4), (4, 4, 5),
               (5, 5, 5), (6, 5, 5), (5, 6, 5), (5, 5, 6), None, None,
               (9, 9, 9), (8, 8, 8), (4, 4, 4)]
_ANCHOR2 = [15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
            15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2]


def bc6h_block(mode: int, words: list, partition: int,
               indices: list) -> bytes:
    """One BC6H block of `mode` from its stored endpoint words (r0 g0 b0
    r1 g1 b1 [r2 ... b3]: the first endpoint, then the deltas or
    endpoints, as the mode stores them, two's complement within their
    bits), the partition (two-region modes) and the 16 indices (the
    anchors' top bit dropped)."""
    code, nbits = BC6H_MODE_BITS[mode]
    fields = [(code, nbits)]
    from ..data.dds import bc6h_layout
    for w, b in bc6h_layout(mode):
        fields.append(((words[w] >> b) & 1, 1))
    two = BC6H_REGIONS[mode] == 2
    if two:
        fields.append((partition, 5))
    ib = 3 if two else 4
    for i, v in enumerate(indices):
        anchor = i == 0 or (two and i == _ANCHOR2[partition])
        fields.append((v, ib - 1 if anchor else ib))
    return _pack(fields, 1).tobytes()


def bc6h_inband(mode: int, signed: bool, rng) -> bytes:
    """A BC6H block of `mode` whose endpoints decode to halves inside (0,
    1): the first endpoint in [3/8, 1/2) of its magnitude's range (top
    bits 011, after a sign bit of 0 when signed: the halves from about
    0.1 to a little over 1), small deltas (or, in the modes without
    deltas, every endpoint drawn so), random partition and indices."""
    epb = BC6H_EPB[mode]
    k = epb - 1 if signed else epb
    nw = 12 if BC6H_REGIONS[mode] == 2 else 6

    def endpoint():
        return (3 << (k - 3)) | int(rng.integers(0, 1 << (k - 3)))

    words = [endpoint() for _ in range(3)]
    delta = _BC6H_DELTA[mode]
    for i in range(3, nw):
        if delta is None:
            words.append(endpoint())
        else:
            bits = delta[i % 3]
            d = int(rng.integers(-(1 << max(bits - 3, 0)),
                                 1 << max(bits - 3, 0)))
            words.append(d & ((1 << bits) - 1))
    two = BC6H_REGIONS[mode] == 2
    partition = int(rng.integers(0, 32)) if two else 0
    ib = 3 if two else 4
    idx = [int(v) for v in rng.integers(0, 1 << ib, 16)]
    for i in range(16):
        if i == 0 or (two and i == _ANCHOR2[partition]):
            idx[i] &= (1 << (ib - 1)) - 1
    return bc6h_block(mode, words, partition, idx)


def random_bc7(nblocks: int, rng, modes=range(9)) -> bytes:
    """Random BC7 blocks whose modes cycle through `modes` (8: a first
    byte of 0)."""
    b = rng.integers(0, 256, (nblocks, 16), dtype=np.uint8)
    m = np.asarray(list(modes))[np.arange(nblocks) % len(modes)]
    first = b[:, 0].astype(np.int64)
    b[:, 0] = np.where(m == 8, 0, ((first << (m + 1)) | (1 << np.minimum(
        m, 7))) & 0xFF).astype(np.uint8)
    return b.tobytes()


def random_bc6h(nblocks: int, rng, modes=tuple(range(14)) + (
        BC6H_RESERVED[0],)) -> bytes:
    """Random BC6H blocks whose modes cycle through `modes` (Pillow's mode
    index 0-13, or a reserved five-bit code 19, 23, 27 or 31)."""
    b = rng.integers(0, 256, (nblocks, 16), dtype=np.uint8)
    for i in range(nblocks):
        m = modes[i % len(modes)]
        code, nbits = (m, 5) if m >= 14 else BC6H_MODE_BITS[m]
        b[i, 0] = (int(b[i, 0]) >> nbits << nbits) | code
    return b.tobytes()


# ------------------------------------------------------------------ FTEX
def ftex(width: int, height: int, fmt: int, mips: list, formats: int = 1,
         version: int = 1) -> bytes:
    """An FTEX file: the header, one format entry and its mipmaps (each a
    byte count and the bytes)."""
    head = b"FTEX" + struct.pack("<5i", version, width, height, len(mips),
                                 formats)
    head += struct.pack("<2i", fmt, len(head) + 8)
    return head + b"".join(struct.pack("<i", len(m)) + m for m in mips)


# ------------------------------------------------------------------- BLP
def _blp_dir(first: int, mips: list) -> bytes:
    offs, lens, at = [], [], first
    for m in mips:
        offs.append(at)
        lens.append(len(m))
        at += len(m)
    pad = [0] * (16 - len(mips))
    return struct.pack("<16I", *offs, *pad) + struct.pack("<16I", *lens, *pad)


def blp1_jpeg(width: int, height: int, jpeg: bytes, alpha: int = 0,
              gap: bytes = b"") -> bytes:
    """A BLP1 file of JPEG content: the stream's tables (everything before
    its SOS marker) in the header block, `gap` after it, the scan (SOS
    on) as the only mipmap."""
    sos = jpeg.index(b"\xff\xda")
    head, scan = jpeg[:sos], jpeg[sos:]
    hdr = b"BLP1" + struct.pack("<iIIIii", 0, alpha, width, height, 5, 0)
    first = len(hdr) + 128 + 4 + len(head) + len(gap)
    return hdr + _blp_dir(first, [scan]) + struct.pack(
        "<I", len(head)) + head + gap + scan


def _bgra(palette: np.ndarray) -> bytes:
    p = np.zeros((256, 4), np.uint8)
    pal = np.asarray(palette, np.uint8)
    p[:len(pal), :pal.shape[1]] = pal[:256]
    if pal.shape[1] == 3:
        p[:, 3] = 255
    return p[:, [2, 1, 0, 3]].tobytes()


def blp1_palette(indices: np.ndarray, palette: np.ndarray, alpha: int = 0,
                 encoding: int = 5) -> bytes:
    """A BLP1 palette file: [256, 3|4] RGB(A) palette, [H, W] indices."""
    H, W = indices.shape
    hdr = b"BLP1" + struct.pack("<iIIIii", 1, alpha, W, H, encoding, 0)
    mip = np.asarray(indices, np.uint8).tobytes()
    first = len(hdr) + 128 + 1024
    return hdr + _blp_dir(first, [mip]) + _bgra(palette) + mip


def blp2(width: int, height: int, encoding: int, alpha_depth: int,
         alpha_encoding: int, mip: bytes, palette=None,
         compression: int = 1) -> bytes:
    """A BLP2 file: the header, the 1024-byte BGRA palette (zeros when
    none) and one mipmap (palette indices, or DXT blocks)."""
    hdr = b"BLP2" + struct.pack("<ibbbbII", compression, encoding,
                                alpha_depth, alpha_encoding, 0, width,
                                height)
    pal = b"\0" * 1024 if palette is None else _bgra(palette)
    first = len(hdr) + 128 + 1024
    return hdr + _blp_dir(first, [mip]) + pal + mip


# ------------------------------------------------------------------- PSD
def packbits(row: bytes) -> bytes:
    """PackBits of one row: runs of 3 or more as run packets, the rest as
    literals of at most 128 bytes."""
    out, i, n = bytearray(), 0, len(row)
    lit = bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            chunk = lit[k:k + 128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()

    while i < n:
        j = i
        while j < n and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            flush()
            out.append(257 - (j - i))
            out.append(row[i])
            i = j
        else:
            lit.append(row[i])
            i += 1
    flush()
    return bytes(out)


def psd_layers(width: int, height: int, rgba: np.ndarray) -> bytes:
    """A layer and mask section of one raw RGBA layer covering the image
    (the layer record PsdImagePlugin._layerinfo parses, its channels'
    data, an empty global mask)."""
    chans = [(0, rgba[..., 0]), (1, rgba[..., 1]), (2, rgba[..., 2]),
             (65535, rgba[..., 3])]
    rec = struct.pack(">4iH", 0, 0, height, width, len(chans))
    for cid, _ in chans:
        rec += struct.pack(">hI", cid - 65536 if cid > 32767 else cid,
                           2 + width * height)
    name = b"layer"
    extra = struct.pack(">II", 0, 0) + bytes([len(name)]) + name
    extra += b"\0" * (-len(extra) % 4)
    rec += b"8BIMnorm" + bytes([255, 0, 1, 0]) + struct.pack(
        ">I", len(extra)) + extra
    data = b"".join(struct.pack(">H", 0) + np.ascontiguousarray(
        p, np.uint8).tobytes() for _, p in chans)
    info = struct.pack(">h", 1) + rec + data
    info += b"\0" * (len(info) & 1)
    section = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
    return struct.pack(">I", len(section)) + section


def psd(planes: list, mode: int, bits: int = 8, compression: int = 1,
        colour_data: bytes = b"", resources=(), layers: bytes | None = None,
        channels: int | None = None, width: int | None = None,
        version: int = 1) -> bytes:
    """A PSD file whose image data holds `planes` ([H, rowbytes] uint8
    each: 8-bit samples, or 1-bit rows packed MSB first), raw or PackBits;
    the header's channel count `channels` (default len(planes)),
    colour-mode data, (id, name, data) image resources and a layer section
    (``psd_layers``; None: none)."""
    H = planes[0].shape[0]
    W = width if width is not None else planes[0].shape[1]
    n = len(planes) if channels is None else channels
    head = b"8BPS" + struct.pack(">H6xHIIHH", version, n, H, W, bits, mode)
    head += struct.pack(">I", len(colour_data)) + colour_data
    res = b""
    for rid, name, data in resources:
        nm = bytes([len(name)]) + name
        nm += b"\0" * (len(nm) & 1)
        res += b"8BIM" + struct.pack(">H", rid) + nm + struct.pack(
            ">I", len(data)) + data + b"\0" * (len(data) & 1)
    head += struct.pack(">I", len(res)) + res
    head += layers if layers is not None else struct.pack(">I", 0)
    if compression == 0:
        body = b"".join(np.ascontiguousarray(p, np.uint8).tobytes()
                        for p in planes)
    else:
        rows = [[packbits(bytes(r)) for r in np.asarray(p, np.uint8)]
                for p in planes]
        counts = b"".join(struct.pack(">H", len(r)) for p in rows for r in p)
        body = counts + b"".join(r for p in rows for r in p)
    return head + struct.pack(">H", compression) + body
