"""The port's JPEG 2000 reader (nerf2mesh_tpu_torch/data/jpeg2000.py and
native/j2kdec.cpp) against Pillow 12.1.0 and its OpenJPEG 2.5.4, on the
CPU.

The oracle is ``np.asarray(Image.open(p))``, the array the JAX package's
providers see: every case must give its dtype, shape and bytes exactly.
Pillow's writer makes most cases: the six modes as JP2 and as raw
codestreams, reversible and irreversible with and without the colour
transform, 1 to 6 resolutions, 4x4 to 64x64 code-blocks, precincts,
odd-sized tiles with tile and image offsets, the five progression orders,
quality layers by rate and by dB, signed samples, comments and PLT, and a
512^2 irreversible frame at rate 20.  Pillow's writer cannot make the rest,
so the writers here do, from Pillow's codestreams: JP2 boxes around them
(a ``pclr``/``cmap`` palette, sYCC with alpha, a ``jpx `` brand, a box of
64-bit length), and edits of their marker segments that OpenJPEG must
read as the standard says (scalar derived quantization, POC changes that
split or repeat the progression, TLM, COM and an unknown marker, COC/QCC
and a tile-part COD/QCD, tile-parts split three ways, SOP markers placed
by the PLT lengths, other sample precisions, and, with packet headers
found by a tier-2 parser here, SOP and EPH markers and PPM and PPT
segments).  What Pillow refuses, the
port refuses with ValueError; HT code-blocks, which no writer here makes,
raise NotImplementedError naming ROADMAP A6 (j) 1.  The coding modes
Pillow's writer cannot set are test_torch_jpeg2000_modes.py's.  The
committed files under fixtures/formats/jpeg2000 and the COLMAP capture
fixtures/colmap_jp2 (``python tests/test_torch_jpeg2000.py`` writes them;
its odd views in the modes of nerf2mesh_tpu_torch/tools/j2k_forms.py) hash
to Pillow's arrays in fixtures/formats.json.
"""

import contextlib
import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu_torch.data import png

REPO = Path(__file__).resolve().parent.parent
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
FIXTURES = REPO / "nerf2mesh_tpu_torch" / "fixtures"
FORMAT_HASHES = FIXTURES / "formats.json"
FORMAT_DIR = "formats/jpeg2000"
# the COLMAP capture chip_smoke.py's phase 14 (g) trains on: view i in
# CAPTURE_KINDS[i], Pillow's writer on even views and j2k_forms's coding
# modes on odd ones
CAPTURE = FIXTURES / "colmap_jp2"
PILLOW_KINDS = ["jp2_rgb", "jp2_sycc", "j2k_layers_db", "j2k_cblk4_layers"]
MODES_KINDS = ["jp2_sycc420", "jp2_sycc422", "j2k_archival",
               "j2k_termall_reset", "j2k_vsc_segsym_pterm", "j2k_roi",
               "j2k_all_modes_tiles", "j2k_sycc420_odd_offset"]
CAPTURE_KINDS = [k for pair in zip(PILLOW_KINDS * 2, MODES_KINDS)
                 for k in pair]


@contextlib.contextmanager
def no_pillow():
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] == "PIL"}
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)


def pillow_array(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def port_array(data: bytes, tmp_path: Path, name: str) -> np.ndarray:
    path = tmp_path / name
    path.write_bytes(data)
    with no_pillow():
        return png.read_image(str(path))


def sha(a) -> dict:
    a = np.asarray(a)
    return {"sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest(), "dtype": str(a.dtype), "shape": list(a.shape)}


def picture(h=37, w=29, seed=0) -> dict:
    """A smooth picture with noise: RGB, RGBA, grey and 16-bit grey."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 4 % 256], -1).astype(np.int32)
    rgb = np.clip(rgb + rng.integers(-20, 21, rgb.shape), 0, 255).astype(
        np.uint8)
    alpha = ((xx * 7 + yy * 5) % 256).astype(np.uint8)
    i16 = ((xx * 2000 + yy * 700) % 65536 + rng.integers(0, 64, (h, w)))
    return {"RGB": rgb, "RGBA": np.concatenate([rgb, alpha[..., None]], -1),
            "L": rgb.mean(-1).astype(np.uint8), "I;16": i16.astype(np.uint16)}


def image(mode: str, h=37, w=29, seed=0) -> Image.Image:
    p = picture(h, w, seed)
    if mode in p:
        return Image.fromarray(p[mode])
    return Image.fromarray(p["RGB"]).convert(mode)      # LA, CMYK, YCbCr


def pillow_j2k(im: Image.Image, raw: bool, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, "JPEG2000", no_jp2=raw, **kw)
    return b.getvalue()


# ------------------------------------------ writers: codestreams and boxes
def split_codestream(cs: bytes):
    """(main header [(marker, body)], tile-parts [[Isot, TPsot, TNsot,
    [(marker, body)], data]]) of a codestream written by Pillow."""
    def segments(pos, stop):
        out = []
        while True:
            (m,) = struct.unpack_from(">H", cs, pos)
            if m in stop:
                return out, pos
            (n,) = struct.unpack_from(">H", cs, pos + 2)
            out.append((m, cs[pos + 4:pos + 2 + n]))
            pos += 2 + n

    assert cs[:2] == b"\xff\x4f"
    main, pos = segments(2, (0xFF90,))
    parts = []
    while cs[pos:pos + 2] == b"\xff\x90":
        _, isot, psot, tpsot, tnsot = struct.unpack_from(">HHIBB", cs, pos + 2)
        end = pos + psot if psot else len(cs) - 2
        segs, q = segments(pos + 12, (0xFF93,))
        parts.append([isot, tpsot, tnsot, segs, cs[q + 2:end]])
        pos = end
    assert cs[pos:] == b"\xff\xd9"
    return main, parts


def join_codestream(main, parts) -> bytes:
    def segs(ss):
        return b"".join(struct.pack(">HH", m, len(b) + 2) + b for m, b in ss)

    out = [b"\xff\x4f", segs(main)]
    for isot, tpsot, tnsot, ss, data in parts:
        head = segs(ss)
        out += [struct.pack(">HHHIBB", 0xFF90, 10, isot,
                            12 + len(head) + 2 + len(data), tpsot, tnsot),
                head, b"\xff\x93", data]
    return b"".join(out + [b"\xff\xd9"])


def edit_main(cs: bytes, fn) -> bytes:
    main, parts = split_codestream(cs)
    return join_codestream(fn(main), parts)


def segment(main, marker: int) -> bytes:
    return next(b for m, b in main if m == marker)


def replace_segment(main, marker: int, body: bytes):
    return [(m, body if m == marker else b) for m, b in main]


def derived_quantization(cs: bytes) -> bytes:
    """QCD rewritten to scalar derived: the LL band's step only."""
    def fn(main):
        q = segment(main, 0xFF5C)
        assert q[0] & 0x1F == 2
        return replace_segment(main, 0xFF5C, bytes([(q[0] & 0xE0) | 1])
                               + q[1:3])
    return edit_main(cs, fn)


def with_poc(cs: bytes, entries) -> bytes:
    """A POC segment of (RS, CS, LYE, RE, CE, P) entries after the main
    header's other segments."""
    body = b"".join(struct.pack(">BBHBBB", *e) for e in entries)
    return edit_main(cs, lambda main: main + [(0xFF5F, body)])


def cod_fields(cs: bytes):
    """(progression, layers, levels, components) of a codestream."""
    main, _ = split_codestream(cs)
    cod, siz = segment(main, 0xFF52), segment(main, 0xFF51)
    return cod[1], struct.unpack_from(">H", cod, 2)[0], cod[5], \
        struct.unpack_from(">H", siz, 34)[0]


def with_informative(cs: bytes) -> bytes:
    """TLM (the tile-parts' lengths), COM and a marker OpenJPEG does not
    know, skipped two bytes at a time, in the main header."""
    main, parts = split_codestream(cs)
    lengths = [len(join_codestream([], [p])) - 4 for p in parts]
    tlm = bytes([0, 0x50]) + b"".join(struct.pack(">BI", p[0], n)
                                      for p, n in zip(parts, lengths))
    extra = [(0xFF55, tlm), (0xFF64, b"\x00\x01made by the test writer"),
             (0xFF6F, bytes(8))]
    return join_codestream(main + extra, parts)


def with_coc_qcc_tile_cod(cs: bytes) -> bytes:
    """The main COD and QCD repeated as COC and QCC of component 1, and as
    the first tile-part's own COD and QCD."""
    main, parts = split_codestream(cs)
    cod, qcd = segment(main, 0xFF52), segment(main, 0xFF5C)
    coc = bytes([1, cod[0] & 1]) + cod[5:]
    main = main + [(0xFF53, coc), (0xFF5D, bytes([1]) + qcd)]
    parts[0][3] = parts[0][3] + [(0xFF52, cod), (0xFF5C, qcd)]
    return join_codestream(main, parts)


def split_tile_parts(cs: bytes, k: int) -> bytes:
    """Each tile's data cut into k tile-parts (TNsot = k)."""
    main, parts = split_codestream(cs)
    out = []
    for isot, _, _, segs, data in parts:
        cuts = [len(data) * i // k for i in range(k + 1)]
        for i in range(k):
            out.append([isot, i, k, segs if i == 0 else [],
                        data[cuts[i]:cuts[i + 1]]])
    return join_codestream(main, out)


def plt_lengths(body: bytes) -> list:
    """The packet lengths of a PLT segment's body (after Zplt)."""
    out, v = [], 0
    for b in body[1:]:
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            out.append(v)
            v = 0
    return out


def with_sop(cs: bytes) -> bytes:
    """SOP markers before every packet, placed by the PLT segments' packet
    lengths (Pillow's plt=True), Scod's SOP bit set, the PLT dropped."""
    main, parts = split_codestream(cs)
    cod = segment(main, 0xFF52)
    main = replace_segment(main, 0xFF52, bytes([cod[0] | 2]) + cod[1:])
    for p in parts:
        lengths = sum((plt_lengths(b) for m, b in p[3] if m == 0xFF58), [])
        assert sum(lengths) == len(p[4])
        data, pos = [], 0
        for i, n in enumerate(lengths):
            data.append(struct.pack(">HHH", 0xFF91, 4, i % 65536)
                        + p[4][pos:pos + n])
            pos += n
        p[3] = [(m, b) for m, b in p[3] if m != 0xFF58]
        p[4] = b"".join(data)
    return join_codestream(main, parts)


class _Bits:
    """Packet-header bits (T.800 B.10.1): after a 0xFF byte, 7 bits."""

    def __init__(self, data: bytes, pos: int):
        self.d, self.p, self.buf, self.ct = data, pos, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.p < len(self.d):
                self.buf |= self.d[self.p]
                self.p += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        if self.buf & 0xFF == 0xFF:
            self.ct = 0
            self.bit()
        self.ct = 0


class _TagTree:
    def __init__(self, w: int, h: int):
        self.sizes = [(w, h)]
        while w * h > 1:
            w, h = (w + 1) // 2, (h + 1) // 2
            self.sizes.append((w, h))
        self.val = [[999] * (a * b) for a, b in self.sizes]
        self.low = [[0] * (a * b) for a, b in self.sizes]

    def decode(self, bits: _Bits, x: int, y: int, threshold: int) -> bool:
        low = 0
        for k in range(len(self.sizes) - 1, -1, -1):     # root to leaf
            i = (y >> k) * self.sizes[k][0] + (x >> k)
            low = max(low, self.low[k][i])
            while low < threshold and low < self.val[k][i]:
                if bits.bit():
                    self.val[k][i] = low
                else:
                    low += 1
            self.low[k][i] = low
        return self.val[0][(y * self.sizes[0][0]) + x] < threshold


def packet_spans(cs: bytes) -> list:
    """(header, body) byte strings of every packet of a one-tile, one
    tile-part codestream in LRCP or RLCP order with the default precincts
    and code-block style, read by T.800's tier 2 on the test side."""
    main, parts = split_codestream(cs)
    assert len(parts) == 1
    siz, cod = segment(main, 0xFF51), segment(main, 0xFF52)
    X1, Y1, X0, Y0 = struct.unpack_from(">IIII", siz, 2)
    nc = struct.unpack_from(">H", siz, 34)[0]
    prog, layers, levels = cod[1], struct.unpack_from(">H", cod, 2)[0], cod[5]
    xcb, ycb = cod[6] + 2, cod[7] + 2
    assert prog in (0, 1) and not cod[0] & 1 and cod[8] == 0
    bands = {}        # r -> [(cw, ch, cblks)] of its non-empty bands
    for r in range(levels + 1):
        lv = levels - r
        out = []
        for b in ([0] if r == 0 else [1, 2, 3]):
            sh = lv if r == 0 else lv + 1
            ox, oy = (0, 0) if r == 0 else ((b & 1) << lv, (b >> 1) << lv)
            bx0, bx1 = (-((ox - X0) >> sh), -((ox - X1) >> sh))
            by0, by1 = (-((oy - Y0) >> sh), -((oy - Y1) >> sh))
            if bx0 >= bx1 or by0 >= by1:
                continue
            cw = -(-bx1 >> xcb) - (bx0 >> xcb)
            ch = -(-by1 >> ycb) - (by0 >> ycb)
            out.append((cw, ch))
        bands[r] = out
    state = {(r, c, k): [_TagTree(cw, ch), _TagTree(cw, ch), {}]
             for r, bs in bands.items() for c in range(nc)
             for k, (cw, ch) in enumerate(bs)}
    order = [(l, r, c) for l in range(layers) for r in range(levels + 1)
             for c in range(nc)]
    if prog == 1:
        order.sort(key=lambda p: (p[1], p[0], p[2]))
    data, pos, spans = parts[0][4], 0, []
    for l, r, c in order:
        bits, lens = _Bits(data, pos), []
        if bits.bit():
            for k, (cw, ch) in enumerate(bands[r]):
                incl, imsb, seen = state[(r, c, k)]
                for j in range(cw * ch):
                    x, y = j % cw, j // cw
                    if j in seen:
                        included = bits.bit()
                    else:
                        included = incl.decode(bits, x, y, l + 1)
                    if not included:
                        continue
                    if j not in seen:
                        i = 0
                        while not imsb.decode(bits, x, y, i):
                            i += 1
                        seen[j] = 3
                    n = 1 + bits.bit()
                    if n == 2 and bits.bit():
                        n = 3 + bits.read(2)
                        if n == 6:
                            n += bits.read(5)
                            if n == 37:
                                n += bits.read(7)
                    while bits.bit():
                        seen[j] += 1
                    lens.append(bits.read(seen[j] + n.bit_length() - 1))
        bits.align()
        spans.append((data[pos:bits.p], data[bits.p:bits.p + sum(lens)]))
        pos = bits.p + sum(lens)
    assert pos == len(data)
    return spans


def repack(cs: bytes, sop=False, eph=False, headers=None) -> bytes:
    """The codestream with SOP before every packet and EPH after every
    packet header, and (headers "ppt" or "ppm") the headers moved into PPT
    or PPM segments (at most 1000 bytes of them a segment; SOP then comes
    before each packet's body in the tile's data)."""
    spans = packet_spans(cs)
    main, parts = split_codestream(cs)
    cod = segment(main, 0xFF52)
    main = replace_segment(main, 0xFF52,
                           bytes([cod[0] | 2 * sop | 4 * eph]) + cod[1:])
    heads = [h + b"\xff\x92" * eph for h, _ in spans]
    sops = [struct.pack(">HHH", 0xFF91, 4, i) * sop for i in range(len(spans))]
    part = parts[0]
    part[3] = [(m, b) for m, b in part[3] if m != 0xFF58]
    if headers is None:         # SOP, the header, EPH, the body
        part[4] = b"".join(m + h + b for m, h, (_, b) in
                           zip(sops, heads, spans))
        return join_codestream(main, parts)
    part[4] = b"".join(m + b for m, (_, b) in zip(sops, spans))
    stream = b"".join(heads)
    if headers == "ppm":
        stream = struct.pack(">I", len(stream)) + stream
    chunks = [stream[i:i + 1000] for i in range(0, len(stream), 1000)]
    segs = [(0xFF60 if headers == "ppm" else 0xFF61, bytes([z]) + ch)
            for z, ch in enumerate(chunks)]
    if headers == "ppm":
        main = main + segs
    else:
        part[3] = part[3] + segs
    return join_codestream(main, parts)


def with_precision(cs: bytes, prec: int, sgnd: bool = False) -> bytes:
    """Every component's SIZ precision (and sign) rewritten; on a
    reversible codestream only the DC shift and the clamp change."""
    def fn(main):
        siz = bytearray(segment(main, 0xFF51))
        (nc,) = struct.unpack_from(">H", siz, 34)
        for i in range(nc):
            siz[36 + 3 * i] = (sgnd << 7) | (prec - 1)
        return replace_segment(main, 0xFF51, bytes(siz))
    return edit_main(cs, fn)


def box(kind: bytes, body: bytes, xl: bool = False) -> bytes:
    if xl:
        return struct.pack(">I4sQ", 1, kind, 16 + len(body)) + body
    return struct.pack(">I4s", 8 + len(body), kind) + body


def jp2_file(cs: bytes, enumcs=16, nc=None, bpc=7, brand=b"jp2 ",
             compat=(b"jp2 ",), extra=b"", colr=None, xl=False) -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr, colr
    or `colr`'s body, `extra` sub-boxes) and jp2c."""
    main, _ = split_codestream(cs)
    siz = segment(main, 0xFF51)
    X1, Y1, X0, Y0 = struct.unpack_from(">IIII", siz, 2)
    nc = struct.unpack_from(">H", siz, 34)[0] if nc is None else nc
    ihdr = struct.pack(">IIHBBBB", Y1 - Y0, X1 - X0, nc, bpc, 7, 0, 0)
    if colr is None:
        colr = struct.pack(">BBBI", 1, 0, 0, enumcs)
    head = box(b"ihdr", ihdr) + (box(b"colr", colr) if colr else b"") + extra
    return (box(b"jP  ", b"\r\n\x87\n")
            + box(b"ftyp", brand + b"\0\0\0\0" + b"".join(compat))
            + box(b"jp2h", head) + box(b"jp2c", cs, xl))


def palette_jp2(cs: bytes, colours: np.ndarray, alpha: bool = False
                ) -> bytes:
    """pclr (8-bit RGB entries) and cmap around an L (or, with alpha, LA)
    codestream of palette indices: OpenJPEG's tile decoding applies
    neither, so Pillow reads the indices (mode P or PA)."""
    ne = len(colours)
    pclr = struct.pack(">HB", ne, 3) + bytes([7, 7, 7]) + \
        colours.astype(np.uint8).tobytes()
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(3))
    if alpha:
        cmap += struct.pack(">HBB", 1, 0, 0)
    return jp2_file(cs, 16, extra=box(b"pclr", pclr) + box(b"cmap", cmap))


# ---------------------------------------------------------------- the cases
MODES = ["L", "LA", "RGB", "RGBA", "I;16", "CMYK"]


def pillow_cases() -> dict:
    c = {}
    for mode in MODES:
        name = mode.lower().replace(";", "")
        c[f"{name}_jp2"] = pillow_j2k(image(mode), False)
        c[f"{name}_j2k"] = pillow_j2k(image(mode), True)
    rgb, rgba = image("RGB"), image("RGBA")
    c["rgb_irreversible_jp2"] = pillow_j2k(rgb, False, irreversible=True)
    c["rgb_irreversible_mct"] = pillow_j2k(rgb, True, irreversible=True,
                                           mct=1)
    c["rgb_reversible_mct"] = pillow_j2k(rgb, True, mct=1)
    c["rgba_irreversible_mct"] = pillow_j2k(rgba, True, irreversible=True,
                                            mct=1)
    c["l_irreversible"] = pillow_j2k(image("L"), True, irreversible=True)
    c["i16_irreversible"] = pillow_j2k(image("I;16"), True,
                                       irreversible=True)
    c["rgb_res1_irreversible"] = pillow_j2k(rgb, True, num_resolutions=1,
                                            irreversible=True, mct=1)
    c["rgb_res6_48x64"] = pillow_j2k(image("RGB", 48, 64), True,
                                     num_resolutions=6, irreversible=True,
                                     mct=1)
    c["rgb_cblk4"] = pillow_j2k(rgb, True, codeblock_size=(4, 4), mct=1)
    c["rgb_cblk64_64x64"] = pillow_j2k(image("RGB", 64, 64), True,
                                       codeblock_size=(64, 64),
                                       irreversible=True, mct=1)
    c["rgb_cblk4x64"] = pillow_j2k(rgb, True, codeblock_size=(4, 64))
    c["rgb_precincts"] = pillow_j2k(rgb, True, precinct_size=(16, 16),
                                    num_resolutions=4)
    c["rgb_precincts_cblk8"] = pillow_j2k(rgb, True, precinct_size=(32, 32),
                                          codeblock_size=(8, 8),
                                          irreversible=True, mct=1)
    for irr in (False, True):
        c[f"rgb_tiles{'_irreversible' if irr else ''}"] = pillow_j2k(
            rgb, True, tile_size=(13, 11), tile_offset=(3, 2),
            offset=(4, 5), irreversible=irr, mct=1)
    c["l_tiles_jp2"] = pillow_j2k(image("L"), False, tile_size=(13, 11),
                                  tile_offset=(3, 2), offset=(4, 5))
    c["rgb_offset"] = pillow_j2k(rgb, True, offset=(4, 5),
                                 tile_size=(64, 64), irreversible=True)
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        c[f"rgb_{prog.lower()}"] = pillow_j2k(
            rgb, True, progression=prog, precinct_size=(16, 16),
            quality_layers=[30, 10, 3], irreversible=True, mct=1)
        c[f"rgb_{prog.lower()}_tiles"] = pillow_j2k(
            rgb, True, progression=prog, precinct_size=(16, 16),
            quality_layers=[20, 4], offset=(3, 1), tile_size=(20, 16),
            tile_offset=(1, 1), mct=1)
    c["rgb_layers_rates"] = pillow_j2k(rgb, True, quality_layers=[40, 10, 2],
                                       irreversible=True, mct=1)
    c["rgb_rlcp_layers"] = pillow_j2k(rgb, True, progression="RLCP",
                                      quality_layers=[20, 5], mct=1)
    c["rgb_layers_db"] = pillow_j2k(rgb, True, quality_layers=[25, 35, 45],
                                    quality_mode="dB", irreversible=True,
                                    mct=1)
    c["rgb_layers_reversible"] = pillow_j2k(rgb, True,
                                            quality_layers=[40, 10, 2])
    c["i16_signed"] = pillow_j2k(image("I;16"), True, signed=True)
    c["i16_signed_jp2"] = pillow_j2k(image("I;16"), False, signed=True,
                                     irreversible=True)
    c["l_signed"] = pillow_j2k(image("L"), True, signed=True)
    c["rgb_comment_plt"] = pillow_j2k(rgb, True, comment="a comment",
                                      plt=True)
    c["sycc_jp2"] = pillow_j2k(image("YCbCr"), False)
    c["ycbcr_j2k"] = pillow_j2k(image("YCbCr"), True)
    c["rgb_512_irreversible"] = pillow_j2k(image("RGB", 512, 512, 1), False,
                                           irreversible=True, mct=1,
                                           quality_layers=[20])
    return c


def writer_cases(base: dict) -> dict:
    """Cases Pillow's writer cannot make, edited from its codestreams."""
    c = {}
    idx = np.random.default_rng(1).integers(0, 40, (37, 29)).astype(np.uint8)
    colours = np.random.default_rng(2).integers(0, 256, (40, 3))
    la = np.stack([idx, picture()["RGBA"][..., 3]], -1)
    c["palette_jp2"] = palette_jp2(
        pillow_j2k(Image.fromarray(idx), True), colours)
    c["palette_alpha_jp2"] = palette_jp2(
        pillow_j2k(Image.fromarray(la), True), colours, alpha=True)
    c["sycc_alpha_jp2"] = jp2_file(base["rgba_j2k"], 18)
    c["jpx_brand"] = jp2_file(base["rgb_irreversible_mct"], 16,
                              brand=b"jpx ", compat=(b"jpx ", b"jp2 "))
    c["xl_box"] = jp2_file(base["rgb_j2k"], 16, xl=True)
    c["grey_codestream_rgb_header"] = jp2_file(base["l_j2k"], 17, nc=3)
    c["derived_quantization"] = derived_quantization(
        base["rgb_irreversible_mct"])
    c["derived_quantization_tiles"] = derived_quantization(
        base["rgb_tiles_irreversible"])
    _, layers, levels, nc = cod_fields(base["rgb_rlcp"])
    c["poc_rlcp_split"] = with_poc(base["rgb_rlcp"], [
        (0, 0, layers, 2, nc, 1), (2, 0, layers, levels + 1, nc, 1)])
    _, layers, levels, nc = cod_fields(base["rgb_layers_rates"])
    c["poc_lrcp_layer_repeat"] = with_poc(base["rgb_layers_rates"], [
        (0, 0, 1, levels + 1, nc, 0), (0, 0, layers, levels + 1, nc, 0)])
    _, layers, levels, nc = cod_fields(base["rgb_cprl_tiles"])
    c["poc_cprl_split"] = with_poc(base["rgb_cprl_tiles"], [
        (0, 0, layers, levels + 1, 1, 4), (0, 1, layers, levels + 1, nc, 4)])
    c["informative_markers"] = with_informative(base["rgb_tiles"])
    c["coc_qcc_tile_cod"] = with_coc_qcc_tile_cod(base["rgb_tiles"])
    c["tile_parts"] = split_tile_parts(base["rgb_tiles_irreversible"], 3)
    c["tile_parts_one_tile"] = split_tile_parts(base["rgb_layers_db"], 3)
    c["sop"] = with_sop(base["rgb_comment_plt"])
    c["eph"] = repack(base["rgb_layers_rates"], eph=True)
    c["sop_eph_reversible"] = repack(base["rgb_layers_reversible"], sop=True,
                                     eph=True)
    c["ppt"] = repack(base["rgb_layers_rates"], headers="ppt")
    c["ppm"] = repack(base["rgba_j2k"], headers="ppm")
    c["ppm_sop_eph"] = repack(base["rgb_layers_db"], sop=True, eph=True,
                              headers="ppm")
    c["ppt_six_resolutions"] = repack(base["rgb_res6_48x64"], headers="ppt")
    c["ppm_rlcp"] = repack(base["rgb_rlcp_layers"], headers="ppm")
    c["precision_4"] = with_precision(base["l_j2k"], 4)
    c["precision_12"] = with_precision(base["i16_j2k"], 12)
    c["precision_9_jp2"] = jp2_file(with_precision(base["i16_j2k"], 9), 17,
                                    bpc=8)
    c["precision_12_rgb"] = with_precision(base["rgb_reversible_mct"], 12)
    c["precision_20_signed"] = with_precision(base["i16_signed"], 20, True)
    # OpenJPEG takes these JP2 files' colour space as unspecified
    c["no_colr_jp2"] = jp2_file(base["rgb_j2k"], colr=b"")
    c["icc_profile_jp2"] = jp2_file(base["rgba_j2k"],
                                    colr=b"\x02\0\0" + bytes(64))
    good = jp2_file(base["la_j2k"], 17)
    c["jp2c_past_end"] = good[:-len(base["la_j2k"]) - 8] + struct.pack(
        ">I4s", len(base["la_j2k"]) + 100, b"jp2c") + base["la_j2k"]
    return c


def refused_cases(base: dict) -> dict:
    """Bytes Pillow cannot read."""
    c = {}
    # Pillow's writer halves the precincts down to 1x1 at the lowest
    # resolution, which the standard (and OpenJPEG's reader) forbids
    c["precincts_too_small"] = pillow_j2k(image("RGB"), True,
                                          precinct_size=(8, 8),
                                          codeblock_size=(4, 4))
    cs = base["rgb_j2k"]
    c["esycc"] = jp2_file(cs, 24)
    c["grey_as_srgb"] = jp2_file(base["l_j2k"], 16)
    c["cmyk_three_components"] = jp2_file(cs, 12)
    c["truncated"] = cs[:len(cs) // 2]
    c["no_qcd"] = edit_main(cs, lambda m: [s for s in m if s[0] != 0xFF5C])
    c["five_components"] = cs[:40] + b"\x00\x05" + cs[42:]
    good = jp2_file(cs)
    c["ftyp_not_second"] = good[:12] + box(b"free", b"") + good[12:]
    c["jp2h_past_end"] = good[:32] + struct.pack(">I", 10 ** 6) + good[36:]
    at = good.index(b"ihdr") + 4
    h, w = struct.unpack_from(">II", good, at)
    for name, (dh, dw) in (("ihdr_larger", (3, 5)), ("ihdr_smaller", (-3, 0))):
        c[name] = good[:at] + struct.pack(">II", h + dh, w + dw) + good[at + 8:]
    c["six_components_jp2"] = jp2_file(edit_main(cs, lambda m: replace_segment(
        m, 0xFF51, segment(m, 0xFF51)[:34] + struct.pack(">H", 6)
        + segment(m, 0xFF51)[36:] + segment(m, 0xFF51)[-3:] * 3)), nc=3)
    c["tile_offset_past_image"] = edit_main(cs, lambda m: replace_segment(
        m, 0xFF51, segment(m, 0xFF51)[:26] + struct.pack(">II", 5, 5)
        + segment(m, 0xFF51)[34:]))
    return c


def cod_style(cs: bytes, style: int) -> bytes:
    """The codestream with COD's code-block style byte set to `style`."""
    return edit_main(cs, lambda m: replace_segment(
        m, 0xFF52, segment(m, 0xFF52)[:8] + bytes([style])
        + segment(m, 0xFF52)[9:]))


def not_ported_cases(base: dict) -> dict:
    """HT code-blocks (style bit 0x40), which no writer here makes: they
    raise NotImplementedError naming ROADMAP A6 (j) 1."""
    return {"cblk_ht": cod_style(base["rgb_j2k"], 0x40)}


BASE = pillow_cases()
CASES = {**BASE, **writer_cases(BASE)}
REFUSED = refused_cases(BASE)
NOT_PORTED = not_ported_cases(BASE)


def ext(data: bytes) -> str:
    return "jp2" if data[:4] == b"\0\0\0\x0c" else "j2k"


def fixture_name(name: str) -> str:
    return f"{FORMAT_DIR}/{name}.{ext(CASES[name])}"


def test_case_sizes():
    """Each variant is at most 64^2 but the 512^2 frame, and the committed
    set stays small."""
    for name, data in CASES.items():
        h, w = pillow_array(data).shape[:2]
        assert h * w <= 64 * 64 or name == "rgb_512_irreversible", name
    assert sum(len(d) for d in CASES.values()) < 300_000


@pytest.mark.parametrize("name", sorted(CASES))
def test_reads_as_pillow(name, tmp_path):
    data = CASES[name]
    got = port_array(data, tmp_path, f"{name}.{ext(data)}")
    assert sha(got) == sha(pillow_array(data)), name


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_as_pillow_refuses(name, tmp_path):
    data = REFUSED[name]
    with pytest.raises(Exception):
        pillow_array(data)
    with pytest.raises(ValueError):
        port_array(data, tmp_path, f"{name}.{ext(data)}")


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_not_ported_raises(name, tmp_path):
    with pytest.raises(NotImplementedError, match=r"A6 \(j\) 1"):
        port_array(NOT_PORTED[name], tmp_path, f"{name}.j2k")


@pytest.mark.parametrize("name,base", [
    ("poc_rlcp_split", "rgb_rlcp"),
    ("poc_lrcp_layer_repeat", "rgb_layers_rates"),
    ("poc_cprl_split", "rgb_cprl_tiles"),
    ("informative_markers", "rgb_tiles"), ("coc_qcc_tile_cod", "rgb_tiles"),
    ("tile_parts", "rgb_tiles_irreversible"),
    ("tile_parts_one_tile", "rgb_layers_db"), ("sop", "rgb_comment_plt"),
    ("eph", "rgb_layers_rates"), ("sop_eph_reversible", "rgb_layers_reversible"),
    ("ppt", "rgb_layers_rates"), ("ppm", "rgba_j2k"),
    ("ppm_sop_eph", "rgb_layers_db"),
    ("ppt_six_resolutions", "rgb_res6_48x64"), ("ppm_rlcp", "rgb_rlcp_layers"),
    ("jpx_brand", "rgb_irreversible_mct"), ("xl_box", "rgb_j2k"),
    ("sycc_alpha_jp2", None), ("palette_jp2", None)])
def test_writers_hold_to_pillow(name, base):
    """The writers' check: an edit that only restates the codestream reads
    in Pillow to the array of the file it was made from, and a JP2 box a
    writer adds gives Pillow's mode for it."""
    if base is not None:
        np.testing.assert_array_equal(pillow_array(CASES[name]),
                                      pillow_array(CASES[base]))
        main, parts = split_codestream(BASE[base])
        assert join_codestream(main, parts) == BASE[base]
    else:
        with Image.open(io.BytesIO(CASES[name])) as im:
            assert im.mode == {"sycc_alpha_jp2": "RGBA",
                               "palette_jp2": "P"}[name]


SPACES = [None, 16, 17, 18, 12, 24, 14]


@pytest.mark.parametrize("comps,nc,enumcs", [
    (c, n, e) for c in (1, 2, 3, 4) for n in (1, 2, 3, 4) for e in SPACES])
def test_jp2_mode_and_colour_space_table(comps, nc, enumcs):
    """A codestream of `comps` components in a JP2 file whose ihdr says
    `nc` and whose colr says `enumcs` (None: no colr): Pillow's mode from
    the header, OpenJPEG's colour space and Pillow's unpacker for the
    three; the port reads what Pillow reads and refuses what it refuses."""
    from nerf2mesh_tpu_torch.data.jpeg2000 import decode_jpeg2000
    cs = BASE[{1: "l_j2k", 2: "la_j2k", 3: "rgb_j2k", 4: "rgba_j2k"}[comps]]
    data = jp2_file(cs, nc=nc, **({"colr": b""} if enumcs is None
                                   else {"enumcs": enumcs}))
    try:
        want = pillow_array(data)
    except Exception:
        with pytest.raises(ValueError):
            decode_jpeg2000(data)
        return
    assert sha(decode_jpeg2000(data)) == sha(want)


def test_derived_quantization_changes_the_steps():
    """Scalar derived quantization reads, in Pillow, to another array than
    the expounded file it was made from: the derived steps are in use."""
    assert not np.array_equal(pillow_array(CASES["derived_quantization"]),
                              pillow_array(CASES["rgb_irreversible_mct"]))


def test_ycbcr_conversion_is_pillows():
    """The sYCC unpacker's YCbCr -> RGB against Pillow's convert() over
    every (Y, Cb, Cr) on a grid of Y."""
    from nerf2mesh_tpu_torch.data.jpeg2000 import ycbcr_to_rgb
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 37, 128, 200, 255):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
        np.testing.assert_array_equal(ycbcr_to_rgb(ycc), want)


def test_decoder_is_built_without_fma_contraction():
    from nerf2mesh_tpu_torch.utils import native
    assert "-ffp-contract=off" in native.flags("j2kdec")
    assert native.flags("meshops") == native.CXXFLAGS


# ------------------------------------------------------- captures and masks
def modes_frame(rgb: np.ndarray, kind: str) -> bytes:
    """A capture's RGB frame in a coding mode Pillow's writer cannot set,
    through tools/j2k_forms.py."""
    from nerf2mesh_tpu_torch.tools import j2k_forms as jf
    planes = [rgb[..., i] for i in range(3)]
    if "sycc" in kind:               # Pillow's YCbCr, chroma sub-sampled
        ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
        dx, dy = (2, 1) if kind == "jp2_sycc422" else (2, 2)
        off = (1, 1) if kind.endswith("odd_offset") else (0, 0)
        if off != (0, 0):    # the picture on a grid offset by one sample
            ycc = np.pad(ycc, ((1, 0), (1, 0), (0, 0)), mode="edge")
        h, w = rgb.shape[:2]
        # chroma sample (u, v) sits at (u dx, v dy) on the reference grid
        y0, x0 = -(-off[1] // dy), -(-off[0] // dx)
        chroma = [ycc[y0 * dy::dy, x0 * dx::dx, i][
            :-(-(h + off[1]) // dy) - y0, :-(-(w + off[0]) // dx) - x0]
            for i in (1, 2)]
        luma = ycc[off[1]:, off[0]:, 0]
        cs = jf.encode([luma] + chroma, size=(w, h), offset=off, comps=[
            jf.Component(levels=4)] + [jf.Component(levels=3, dx=dx, dy=dy)
                                       for _ in range(2)])
        return cs if kind.startswith("j2k") else jp2_file(cs, 18)
    if kind == "j2k_archival":       # bypass, RPCL, precincts, 9/7
        comps = [jf.Component(levels=4, style=jf.BYPASS, reversible=False,
                              step=2.0, precincts=[(6, 6)] * 5)
                 for _ in range(3)]
        return jf.encode(planes, comps=comps, mct=True, layers=3,
                         progression="RPCL")
    if kind == "j2k_termall_reset":
        comps = [jf.Component(levels=3, cblk=(5, 5),
                              style=jf.TERMALL | jf.RESET) for _ in range(3)]
        return jf.encode(planes, comps=comps, mct=True, layers=2)
    if kind == "j2k_vsc_segsym_pterm":
        comps = [jf.Component(levels=5, style=jf.VSC | jf.SEGSYM | jf.PTERM,
                              reversible=False, step=1.5) for _ in range(3)]
        return jf.encode(planes, comps=comps, mct=True)
    if kind == "j2k_roi":
        return jf.encode(planes, comps=[jf.Component(levels=3)
                                        for _ in range(3)],
                         roi={0: (24, 24, 72, 72)}, mct=True, layers=2)
    assert kind == "j2k_all_modes_tiles"
    comps = [jf.Component(levels=2, cblk=(4, 4), style=63, reversible=False,
                          step=1.0) for _ in range(3)]
    return jf.encode(planes, comps=comps, mct=True, layers=4, tiles=(40, 36),
                     offset=(5, 7), tile_offset=(3, 2), progression="RLCP")


def encode_frame(img: np.ndarray, kind: str) -> bytes:
    """A capture's frame (RGB) or mask ([H, W] grey, .j2k) in one of the
    variants."""
    im = Image.fromarray(img)
    if img.ndim == 2:
        return pillow_j2k(im, True)
    if kind in MODES_KINDS:
        return modes_frame(img, kind)
    return {
        "jp2_rgb": lambda: pillow_j2k(im, False),
        "jp2_sycc": lambda: pillow_j2k(im.convert("YCbCr"), False),
        "j2k_layers_db": lambda: pillow_j2k(im, True,
                                            quality_layers=[30, 40, 50],
                                            quality_mode="dB",
                                            irreversible=True, mct=1),
        "j2k_cblk4_layers": lambda: pillow_j2k(
            im, True, codeblock_size=(4, 4), quality_layers=[10, 3],
            mct=1),
    }[kind]()


def make_capture(root: str) -> None:
    """A 16-view 96^2 COLMAP capture whose i-th frame is in
    CAPTURE_KINDS[i] (renamed in images.bin) with a grey .j2k mask
    a frame under the name the providers look for (mask/<stem>.png: both
    packages read a file by its content)."""
    import dataclasses
    from nerf2mesh_tpu_torch.data import colmap_utils as tcu
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    generate_colmap_dataset(root, H=96, W=96, n_images=16, n_points=400)
    sp = os.path.join(root, "sparse", "0", "images.bin")
    ims = tcu.read_images_binary(sp)
    os.makedirs(os.path.join(root, "mask"), exist_ok=True)
    for i, k in enumerate(sorted(ims)):
        im = ims[k]
        src = os.path.join(root, "images", im.name)
        with Image.open(src) as f:
            rgb = np.asarray(f.convert("RGB"))
        kind = CAPTURE_KINDS[i % len(CAPTURE_KINDS)]
        stem = os.path.splitext(im.name)[0]
        name = f"{stem}.{kind[:3]}"
        Path(root, "images", name).write_bytes(encode_frame(rgb, kind))
        os.remove(src)
        ims[k] = dataclasses.replace(im, name=name)
        mask = ((rgb.astype(int).sum(-1) > 60) * 255).astype(np.uint8)
        Path(root, "mask", stem + ".png").write_bytes(encode_frame(mask, ""))
    tcu.write_images_binary(ims, sp)


def test_capture_loads_as_jax():
    """The committed capture fixtures/colmap_jp2 (frames in the variants
    chip_smoke's phase 14 (g) trains on, the odd views in j2k_forms's
    coding modes: sub-sampled sYCC, bypass, termall, ROI, ...; grey .j2k
    masks): JAX's COLMAP provider (Pillow) and the port's (Pillow blocked)
    load equal images, masks, poses and intrinsics."""
    from nerf2mesh_tpu.config import parse_args as jparse
    from nerf2mesh_tpu.data.colmap import load_colmap_dataset as jload
    from nerf2mesh_tpu_torch.config import parse_args as tparse
    from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset as tload
    argv = [str(CAPTURE), "--bound", "4", "--enable_cam_near_far"]
    for split in ("train", "val"):
        want = jload(jparse(argv), split)
        with no_pillow():
            got = tload(tparse(argv), split)
        assert got.images.shape == want.images.shape
        assert got.images.shape[-1] == 4                 # the masks' alpha
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.poses, want.poses)
        np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
    names = sorted(os.listdir(CAPTURE / "images"))
    assert {n.rsplit(".", 1)[1] for n in names} == {"jp2", "j2k"}
    styles, sampling, rgn = 0, set(), 0
    for n in names:
        data = (CAPTURE / "images" / n).read_bytes()
        main, _ = split_codestream(data[data.index(J2K_SIGNATURE):])
        styles |= segment(main, 0xFF52)[8]
        siz = segment(main, 0xFF51)
        sampling |= {siz[37 + 3 * i:39 + 3 * i] for i in range(3)}
        rgn += any(m == 0xFF5E for m, _ in main)
    # the odd views: every code-block style but HT, 4:2:0, 4:2:2, ROI
    assert styles == 63 and {b"\2\2", b"\2\1"} <= sampling and rgn


def test_blender_mask_in_jpeg2000(tmp_path):
    """A blender scene whose masks are JPEG 2000 (grey .j2k and a palette
    .jp2 under mask/<frame>.png) loads in the port as in JAX."""
    import dataclasses
    from nerf2mesh_tpu.config import Config as JConfig
    from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset as tload
    root = tmp_path / "scene"
    (root / "images").mkdir(parents=True)
    (root / "mask").mkdir()
    rng = np.random.default_rng(3)
    frames = []
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
                        ).save(root / "images" / f"r_{i}.png")
        m = rng.integers(0, 256, (12, 16), dtype=np.uint8)
        data = (pillow_j2k(Image.fromarray(m), True, irreversible=True)
                if i == 0 else palette_jp2(pillow_j2k(
                    Image.fromarray(m), True), np.arange(768).reshape(256, 3)
                    % 256))
        (root / "mask" / f"r_{i}.png").write_bytes(data)
        pose = np.eye(4)
        pose[:3, 3] = [0, 0, 3 + i]
        frames.append({"file_path": f"./images/r_{i}",
                       "transform_matrix": pose.tolist()})
    (root / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.9, "frames": frames}))
    want = jload(dataclasses.replace(JConfig(path=str(root)),
                                     scale=0.8).finalize(), "train")
    with no_pillow():
        got = tload(dataclasses.replace(Config(path=str(root)),
                                        scale=0.8).finalize(), "train")
    assert got.images.shape == want.images.shape == (2, 12, 16, 4)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.poses, want.poses)


# ------------------------------------------------------- committed fixtures
def is_mine(rel: str) -> bool:
    return rel.startswith(FORMAT_DIR + "/") or rel.startswith("colmap_jp2/")


def committed() -> list:
    out = [fixture_name(n) for n in sorted(CASES)]
    for d in ("images", "mask"):
        out += [str(p.relative_to(FIXTURES))
                for p in sorted((CAPTURE / d).iterdir())]
    return out


def write_fixtures() -> None:
    """Writes fixtures/formats/jpeg2000/ (every case), the capture
    fixtures/colmap_jp2/ and their entries in fixtures/formats.json; the
    other modules' entries stay."""
    hashes = json.loads(FORMAT_HASHES.read_text())
    for k in [k for k in hashes if is_mine(k)]:
        del hashes[k]
    shutil.rmtree(FIXTURES / FORMAT_DIR, ignore_errors=True)
    for n in sorted(CASES):
        path = FIXTURES / fixture_name(n)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(CASES[n])
        hashes[fixture_name(n)] = sha(pillow_array(CASES[n]))
    shutil.rmtree(CAPTURE, ignore_errors=True)
    make_capture(str(CAPTURE))
    for d in ("images", "mask"):
        for p in sorted((CAPTURE / d).iterdir()):
            hashes[str(p.relative_to(FIXTURES))] = sha(
                pillow_array(p.read_bytes()))
    FORMAT_HASHES.write_text(json.dumps(dict(sorted(hashes.items())),
                                        indent=1) + "\n")


def test_committed_files_hash_to_pillow(tmp_path):
    """Every committed file of this module hashes to Pillow's array in
    formats.json, and the port reads each to the same hash."""
    want = json.loads(FORMAT_HASHES.read_text())
    files = committed()
    assert set(files) == {k for k in want if is_mine(k)}
    assert len([f for f in files if f.startswith("colmap_jp2/")]) == 32
    for rel in files:
        data = (FIXTURES / rel).read_bytes()
        assert sha(pillow_array(data)) == want[rel], rel
        assert sha(port_array(data, tmp_path, rel.replace("/", "_"))) == \
            want[rel], rel


def test_writers_reproduce_the_committed_bytes():
    """Every case, written again, equals its committed file."""
    for n in sorted(CASES):
        assert (FIXTURES / fixture_name(n)).read_bytes() == CASES[n], n


def test_capture_writer_reproduces_a_frame(tmp_path):
    """The capture's writer gives the committed bytes again from the same
    synthetic frames (frames 0-3, two of them in j2k_forms's modes, and
    their masks)."""
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    root = tmp_path / "c"
    generate_colmap_dataset(str(root), H=96, W=96, n_images=16, n_points=400)
    names = sorted(os.listdir(root / "images"))[:4]
    for i, n in enumerate(names):
        with Image.open(root / "images" / n) as f:
            rgb = np.asarray(f.convert("RGB"))
        stem = os.path.splitext(n)[0]
        kind = CAPTURE_KINDS[i]
        assert encode_frame(rgb, kind) == (
            CAPTURE / "images" / f"{stem}.{kind[:3]}").read_bytes(), n
        mask = ((rgb.astype(int).sum(-1) > 60) * 255).astype(np.uint8)
        assert encode_frame(mask, "") == (
            CAPTURE / "mask" / f"{stem}.png").read_bytes(), n


def _decode_in_child(path: str, want: str, out) -> None:
    from nerf2mesh_tpu_torch.data.jpeg2000 import decode_jpeg2000
    got = decode_jpeg2000(Path(path).read_bytes())
    out.put(sha(got)["sha256"] == want)


@pytest.mark.filterwarnings(
    "ignore:This process .* is multi-threaded:DeprecationWarning")
def test_concurrent_and_forked_decodes_agree():
    """The decoder's thread pool under load: 16 Python threads (ctypes
    drops the interpreter lock) decode three files 8 times each, every
    result equal to its serial decode, within a time bound; then a process
    forked after the pool started decodes too (it starts its own pool)."""
    import concurrent.futures
    import multiprocessing
    from nerf2mesh_tpu_torch.data.jpeg2000 import decode_jpeg2000
    names = ["rgb_512_irreversible", "tile_parts", "rgb_precincts_cblk8"]
    datas = [CASES[n] for n in names]
    want = [sha(decode_jpeg2000(d)) for d in datas]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            futs = [(i, ex.submit(decode_jpeg2000, datas[i]))
                    for _ in range(8) for i in range(3)]
            for i, f in futs:
                assert sha(f.result(timeout=120)) == want[i], names[i]
    finally:
        sys.setswitchinterval(switch)
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    path = FIXTURES / fixture_name(names[0])
    proc = ctx.Process(target=_decode_in_child,
                       args=(str(path), want[0]["sha256"], q))
    proc.start()
    proc.join(timeout=120)
    assert not proc.is_alive() and proc.exitcode == 0
    assert q.get(timeout=5)


def test_reader_imports_no_pillow():
    """The reader decodes a committed JP2 and a raw codestream in a process
    where Pillow cannot be imported, and leaves no PIL module loaded."""
    paths = [str(FIXTURES / fixture_name(n))
             for n in ("sycc_jp2", "rgb_tiles_irreversible", "palette_jp2")]
    code = f"""
import sys
sys.modules["PIL"] = None
from nerf2mesh_tpu_torch.data import jpeg2000, png
for p in {paths!r}:
    assert png.read_image(p).size > 0, p
bad = [k for k in sys.modules if k.split(".")[0] == "PIL" and sys.modules[k]]
assert not bad, bad
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout[-2000:] + res.stderr[-3000:]


if __name__ == "__main__":
    write_fixtures()
