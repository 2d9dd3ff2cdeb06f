"""The legacy image forms the port reads since ROADMAP A6 (j) 3-6 against
Pillow 12.1.0, on the CPU: the TIFF codecs libtiff decodes for Pillow
(CCITT modified Huffman, Group 3 1-D and 2-D, Group 4 and RLEW; LZMA;
zstd; ThunderScan; old-style JPEG in both its forms), planar and every
contiguous YCbCr subsampling libtiff's RGBA interface reads, and the SGI,
PCX, DCX, ICO and CUR readers.

The oracle is ``np.asarray(Image.open(p))``, the array the JAX package's
providers see: every case must give its dtype, shape and bytes exactly.
Pillow writes what it can (CCITT, LZMA and zstd TIFF, SGI verbatim, PCX
at 1 and 8 bits, ICO of PNG entries); nerf2mesh_tpu_torch/tools/
legacy_forms.py writes the rest (RLEW, ThunderScan, old-style JPEG,
planar and subsampled YCbCr, SGI RLE, PCX in 2 and 4 planes, DCX, ICO of
BMP entries, CUR).  What Pillow refuses, the port refuses with ValueError,
and the test shows Pillow refusing the same bytes; where Pillow's plugin
accepts a prefix but its _open fails, the port tries the next reader as
Image.open tries the next plugin.  The port's side runs with Pillow
blocked in sys.modules.  The committed files under nerf2mesh_tpu_torch/
fixtures/formats/{tiff/legacy_*,sgi,pcx,ico} and the COLMAP capture
fixtures/colmap_legacy (written by ``python tests/test_torch_legacyforms.py``)
hash to Pillow's arrays in fixtures/formats.json.
"""

import contextlib
import hashlib
import io
import json
import lzma
import os
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu_torch.data import png
from nerf2mesh_tpu_torch.tools import legacy_forms as lf

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "nerf2mesh_tpu_torch" / "fixtures"
FORMAT_HASHES = FIXTURES / "formats.json"
# the COLMAP capture chip_smoke.py's phase 14 (h) trains on
CAPTURE = FIXTURES / "colmap_legacy"
FRAME_KINDS = ["ojpeg_jif", "ojpeg_tables", "lzma", "zstd", "ycbcr_planar",
               "sgi_rle8", "sgi_rle16", "pcx_rgb", "dcx", "ico_bmp32", "cur"]
MASK_KINDS = ["sgi", "pcx", "lzma", "g4"]


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


def pillow_array(data: bytes, tmp_path: Path, name: str = "p.bin"
                 ) -> np.ndarray:
    """np.asarray(Image.open(path)) of the bytes written to a file, as the
    providers open frames (PCX seeks from the file's end)."""
    path = tmp_path / f"pillow_{name}"
    path.write_bytes(data)
    with Image.open(path) as im:
        return np.asarray(im)


def port_array(data: bytes, tmp_path: Path, name: str = "t.bin"
               ) -> np.ndarray:
    path = tmp_path / f"port_{name}"
    path.write_bytes(data)
    with no_pillow():
        return png.read_image(str(path))


def sha(a) -> dict:
    """SHA-256 of an array's values (bool as 0/1), its dtype and shape."""
    a = np.asarray(a)
    v = a.astype(np.uint8) if a.dtype == bool else a
    return {"sha256": hashlib.sha256(np.ascontiguousarray(v).tobytes())
            .hexdigest(), "dtype": str(a.dtype), "shape": list(a.shape)}


def picture(h=37, w=29, seed=0) -> dict:
    """A smooth picture with noise and flat patches: RGB, RGBA, grey, 4-bit
    grey, 16-bit RGB and a bilevel image (True black)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 4 % 256], -1).astype(np.int32)
    rgb = np.clip(rgb + rng.integers(-20, 21, rgb.shape), 0, 255).astype(
        np.uint8)
    rgb[h // 4:h // 2, w // 5:w // 2] = (200, 30, 90)
    alpha = ((xx * 7 + yy * 5) % 256).astype(np.uint8)
    grey = rgb.mean(-1).astype(np.uint8)
    bilevel = ((((xx // (1 + yy % 7)) + yy) % 5 < 2)
               ^ (rng.random((h, w)) < 0.05))
    return {"RGB": rgb, "RGBA": np.concatenate([rgb, alpha[..., None]], -1),
            "L": grey, "L4": (grey >> 4).astype(np.uint8),
            "RGB16": rgb.astype(np.uint16) * 257 + rng.integers(
                0, 200, rgb.shape).astype(np.uint16),
            "1": bilevel}


def pillow_save(a, fmt: str, mode: str | None = None, **kw) -> bytes:
    im = Image.fromarray(a)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def tiff_ifd_entry(data: bytes, tag: int) -> int:
    """The file offset of `tag`'s entry in a little-endian TIFF's IFD."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    for i in range(n):
        if struct.unpack_from("<H", data, ifd + 2 + 12 * i)[0] == tag:
            return ifd + 2 + 12 * i
    raise KeyError(tag)


def ycbcr_units(ycc: np.ndarray, h: int, v: int) -> bytes:
    """Contiguous YCbCr data units at subsampling (h, v): h * v Y samples,
    then Cb and Cr of the unit's first pixel."""
    H, W = ycc.shape[:2]
    uh, uw = -(-H // v), -(-W // h)
    y = np.zeros((uh * v, uw * h), np.uint8)
    y[:H, :W] = ycc[..., 0]
    units = y.reshape(uh, v, uw, h).transpose(0, 2, 1, 3).reshape(uh, uw, -1)
    c = ycc[::v, ::h, 1:]
    return np.concatenate([units, c], -1).tobytes()


def ycbcr_tiff(ycc: np.ndarray, sub, planar: bool = False, comp: int = 8,
               pred: int = 1) -> bytes:
    H, W = ycc.shape[:2]
    if planar:
        raw = [ycc[..., k].tobytes() for k in range(3)]
    else:
        raw = [ycbcr_units(ycc, *sub)]
    more = {"t530": (3, list(sub))} if sub else {}
    if planar:
        more["t284"] = (3, [2])
    if pred != 1:
        more["t317"] = (3, [pred])
    tags = lf.image_tags(W, H, (8, 8, 8), 6, comp, **more)
    return lf.tiff_file(tags, [zlib.compress(r) if comp == 8 else r
                               for r in raw])


def fax_cases(p) -> dict:
    one, out = p["1"], {}
    out["ccitt_mh"] = pillow_save(one, "TIFF", compression="tiff_ccitt")
    out["ccitt_g3_1d"] = pillow_save(one, "TIFF", compression="group3")
    out["ccitt_g3_1d_fill"] = pillow_save(one, "TIFF", compression="group3",
                                          tiffinfo={292: 4})
    out["ccitt_g3_2d"] = pillow_save(one, "TIFF", compression="group3",
                                     tiffinfo={292: 1})
    out["ccitt_g3_2d_fill_strips"] = pillow_save(
        one, "TIFF", compression="group3", tiffinfo={292: 5, 278: 8})
    out["ccitt_g4"] = pillow_save(one, "TIFF", compression="group4")
    out["ccitt_g4_strips"] = pillow_save(one, "TIFF", compression="group4",
                                         tiffinfo={278: 5})
    out["ccitt_g4_min_is_black"] = pillow_save(
        one, "TIFF", compression="group4", tiffinfo={262: 1})
    out["ccitt_g4_fill2"] = pillow_save(one, "TIFF", compression="group4",
                                        tiffinfo={266: 2})
    out["ccitt_g4_64"] = pillow_save(picture(64, 64, 3)["1"], "TIFF",
                                     compression="group4")
    out["ccitt_g4_truncated"] = truncated_g4(one)
    H, W = one.shape
    for align, comp, name in ((8, 2, "ccitt_mh_writer"),
                              (16, 32771, "ccitt_rlew")):
        for ph in (0, 1):
            out[f"{name}_photometric{ph}"] = lf.tiff_file(
                lf.image_tags(W, H, (1,), ph, comp), [lf.fax_mh(one, align)])
    return out


def truncated_g4(one: np.ndarray) -> bytes:
    """Pillow's Group 4 file with the strip cut inside its last row (the
    longest cut that changes that row alone, in Pillow): libtiff repairs
    the row (the rest of it in the colour at the cut) and keeps every row
    before, so the arrays are defined to the last byte."""
    whole = pillow_save(one, "TIFF", compression="group4")
    want = np.asarray(Image.open(io.BytesIO(whole)))
    at = tiff_ifd_entry(whole, 279)
    (count,) = struct.unpack_from("<I", whole, at + 8)
    for cut in range(count - 1, 0, -1):
        d = bytearray(whole)
        struct.pack_into("<I", d, at + 8, cut)
        got = np.asarray(Image.open(io.BytesIO(bytes(d))))
        if not np.array_equal(got[-1], want[-1]):
            assert np.array_equal(got[:-1], want[:-1])
            return bytes(d)
    raise AssertionError("no cut changes the last row alone")


def tiff_cases(p) -> dict:
    out = fax_cases(p)
    rgb, grey = p["RGB"], p["L"]
    H, W = grey.shape
    out["lzma_grey"] = pillow_save(grey, "TIFF", compression="lzma")
    out["lzma_rgb_predictor"] = pillow_save(rgb, "TIFF", compression="lzma",
                                            tiffinfo={317: 2})
    out["zstd_rgb"] = pillow_save(rgb, "TIFF", compression="zstd")
    out["zstd_grey16"] = pillow_save(p["RGB16"][..., 0], "TIFF",
                                     compression="zstd")
    big = picture(64, 64, 5)["L4"]           # 64^2: a file's fixed cost
    for ph in (0, 1):
        out[f"thunderscan_photometric{ph}"] = lf.tiff_file(
            lf.image_tags(64, 64, (4,), ph, 32809), [lf.thunderscan(big)])
    out["ojpeg_jif_420"] = lf.old_jpeg_jif(rgb, (2, 2), tag_sampling=(2, 2))
    out["ojpeg_jif_444_no_tag"] = lf.old_jpeg_jif(rgb, (1, 1))
    out["ojpeg_jif_422_tag_22"] = lf.old_jpeg_jif(rgb, (2, 1),
                                                  tag_sampling=(2, 2))
    out["ojpeg_jif_rgb_photometric"] = lf.old_jpeg_jif(
        rgb, (2, 2), tag_sampling=(2, 2), photometric=2)
    out["ojpeg_tables_420"] = lf.old_jpeg_tables(rgb, (2, 2))
    out["ojpeg_tables_422_strips"] = lf.old_jpeg_tables(rgb, (2, 1),
                                                        rows_per_strip=8)
    out["ojpeg_tables_420_strips"] = lf.old_jpeg_tables(
        picture(64, 64, 2)["RGB"], (2, 2), rows_per_strip=16)
    out["ojpeg_tables_444_restart_tag"] = lf.old_jpeg_tables(
        rgb, (1, 1), restart_tag=True)
    out["ojpeg_tables_grey_strips"] = lf.old_jpeg_tables(grey,
                                                         rows_per_strip=16)
    out["ojpeg_jif_tiled"] = ojpeg_tiled(rgb)
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    out["ycbcr_planar_deflate"] = ycbcr_tiff(ycc, (1, 1), planar=True)
    out["ycbcr_planar_raw"] = ycbcr_tiff(ycc, (2, 2), planar=True, comp=1)
    for sub in ((4, 4), (4, 2), (4, 1), (1, 2)):
        out[f"ycbcr_{sub[0]}{sub[1]}_deflate"] = ycbcr_tiff(ycc, sub)
    out["ycbcr_22_predictor"] = ycbcr_tiff(ycc, (2, 2), pred=2)
    out["jpeg_ycbcr_planes"] = jpeg_planes(ycc)
    return out


def ojpeg_tiled(rgb: np.ndarray) -> bytes:
    """An old-style JPEG TIFF of one 32x48 tile: the JPEG stream at
    JPEGInterchangeFormat is the tile, cropped to the image."""
    from nerf2mesh_tpu_torch.data.jpeg import encode_jpeg
    H, W = rgb.shape[:2]
    pad = np.zeros((48, 32, 3), np.uint8)
    pad[:H, :W] = rgb
    jpeg = encode_jpeg(pad, 85, "4:2:0")
    _, _, scan, eoi = lf._jpeg_parts(jpeg)
    tags = lf.image_tags(W, H, (8, 8, 8), 6, 6, t512=(3, [1]),
                         t514=(4, [len(jpeg)]), t530=(3, [2, 2]),
                         t322=(3, [32]), t323=(3, [48]))
    del tags[278]
    return lf.tiff_file(tags, [(513, 0, scan, eoi)], {513: [jpeg]},
                        tiles=True)


def jpeg_planes(ycc: np.ndarray) -> bytes:
    """New-style JPEG YCbCr in planes: each plane a grey JPEG, converted by
    libtiff's RGBA interface."""
    from nerf2mesh_tpu_torch.data.jpeg import encode_jpeg
    H, W = ycc.shape[:2]
    tags = lf.image_tags(W, H, (8, 8, 8), 6, 7, t284=(3, [2]),
                         t530=(3, [1, 1]))
    return lf.tiff_file(tags, [encode_jpeg(np.ascontiguousarray(
        ycc[..., k]), 90) for k in range(3)])


def sgi_cases(p) -> dict:
    out = {}
    for mode in ("L", "RGB", "RGBA"):
        a = p[mode]
        for bpc in (1, 2):
            out[f"pillow_{mode.lower()}_bpc{bpc}"] = pillow_save(
                a, "SGI", bpc=bpc)
        out[f"rle8_{mode.lower()}"] = lf.sgi(a)
        wide = (a.astype(np.uint16) << 8) | (np.arange(a.size).reshape(
            a.shape) % 7).astype(np.uint16)
        out[f"rle16_{mode.lower()}"] = lf.sgi(wide)
    out["rle8_dimension1"] = lf.sgi(p["L"][0])
    return out


def pcx_cases(p) -> dict:
    out = {}
    rgb = p["RGB"]
    for mode in ("1", "L", "P", "RGB"):
        out[f"pillow_{mode.lower()}"] = pillow_save(rgb, "PCX", mode)
    out["pillow_rgb_even_width"] = pillow_save(rgb[:, :28], "PCX")
    idx = (p["L"] >> 4).astype(np.uint8)
    pal = bytes(range(0, 240, 5))
    for planes in (2, 4):
        for w, even in ((29, True), (20, True), (20, False)):
            out[f"planes{planes}_w{w}{'' if even else '_odd_stride'}"] = \
                lf.pcx(idx[:, :w] % (1 << planes), 1, planes, pal,
                       even=even)
    out["dcx"] = lf.dcx([pillow_save(rgb, "PCX"),
                         pillow_save(p["L"], "PCX")])
    out["dcx_grey"] = lf.dcx([pillow_save(p["L"], "PCX")])
    return out


def icon_bmp_entries(p, mask) -> dict:
    rng = np.random.default_rng(7)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    idx = p["L"]
    ents = {bpp: lf.dib((idx.astype(int) % (1 << bpp)).astype(np.uint8),
                        bpp, pal[:1 << bpp], mask) for bpp in (1, 4, 8)}
    ents[24] = lf.dib(p["RGB"], 24, None, mask)
    ents[32] = lf.dib(p["RGBA"], 32, None, mask)
    return ents


def ico_cases(p) -> dict:
    out = {}
    H, W = p["L"].shape
    yy, xx = np.mgrid[0:H, 0:W]
    mask = (xx + 2 * yy) % 5 == 0
    for mode in ("RGBA", "RGB", "L", "P"):
        out[f"pillow_png_{mode.lower()}"] = pillow_save(
            p["RGBA" if mode == "RGBA" else "RGB"], "ICO", mode,
            sizes=[(W, H), (16, 16)])
    ents = icon_bmp_entries(p, mask)
    for bpp, e in ents.items():
        out[f"bmp{bpp}"] = lf.icon([(W, H, 0, 1, bpp, e)])
        out[f"cur_bmp{bpp}"] = lf.icon([(W, H, 0, 3, 5, e)], kind=2)
    small = lf.dib(p["RGB"][:16, :16], 24, None, mask[:16, :16])
    out["cur_two_entries_bmp32"] = lf.icon(
        [(16, 16, 0, 3, 5, small), (W, H, 0, 3, 5, ents[32])], kind=2)
    out["cur_256_loses"] = lf.icon(
        [(16, 16, 0, 3, 5, small), (256, 256, 0, 3, 5, ents[8])], kind=2)
    out["sort_depth_ties"] = lf.icon([(W, H, 0, 1, 32, ents[32]),
                                      (W, H, 0, 1, 8, ents[8]),
                                      (16, 16, 0, 1, 24, small)])
    out["png_and_bmp"] = lf.icon([(W, H, 0, 1, 32, pillow_save(
        p["RGBA"], "PNG")), (W, H, 0, 1, 24, ents[24])])
    grey_pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    out["bmp8_grey_palette"] = lf.icon([(W, H, 0, 1, 8, lf.dib(
        p["L"], 8, grey_pal, mask))])
    return out


def all_cases() -> dict:
    """{path under fixtures/: bytes} of every committed variant."""
    p = picture()
    out = {}
    for n, d in tiff_cases(p).items():
        out[f"formats/tiff/legacy_{n}.tif"] = d
    for n, d in sgi_cases(p).items():
        out[f"formats/sgi/{n}.sgi"] = d
    for n, d in pcx_cases(p).items():
        out[f"formats/pcx/{n}.{'dcx' if n.startswith('dcx') else 'pcx'}"] = d
    # icons at 64^2, so that phase 14 (c) times pixels more than calls
    for n, d in ico_cases(picture(64, 64, 6)).items():
        out[f"formats/ico/{n}.{'cur' if n.startswith('cur') else 'ico'}"] = d
    return out


CASES = all_cases()


def refused_cases() -> dict:
    """{name: bytes} that Pillow refuses and the port must refuse with
    ValueError."""
    p = picture()
    one, grey = p["1"], p["L"]
    H, W = grey.shape
    ycc = np.asarray(Image.fromarray(p["RGB"]).convert("YCbCr"))
    tif = lf.tiff_file
    out = {
        "tiff_sgilog": tif(lf.image_tags(W, H, (16,), 32844, 34676),
                           [grey.tobytes() * 2]),
        "tiff_sgilog_photometric1": tif(lf.image_tags(W, H, (8,), 1, 34676),
                                        [grey.tobytes()]),
        "tiff_webp": tif(lf.image_tags(W, H, (8,), 1, 50001),
                         [grey.tobytes()]),
        "tiff_next": tif(lf.image_tags(W, H, (8,), 1, 32766),
                         [grey.tobytes()]),
        "tiff_compression_9": tif(lf.image_tags(W, H, (8,), 1, 9),
                                  [grey.tobytes()]),
        "tiff_group4_8bit": tif(lf.image_tags(W, H, (8,), 1, 4),
                                [lf.fax_mh(one)]),
        "tiff_rlew_8bit": tif(lf.image_tags(W, H, (8,), 1, 32771),
                              [lf.fax_mh(one, 16)]),
        "tiff_thunderscan_8bit": tif(lf.image_tags(W, H, (8,), 1, 32809),
                                     [lf.thunderscan(p["L4"])]),
        "tiff_lzma_alone": tif(lf.image_tags(W, H, (8,), 1, 34925), [
            lzma.compress(grey.tobytes(), format=lzma.FORMAT_ALONE)]),
        "tiff_ycbcr_planar_22": ycbcr_tiff(ycc, (2, 2), planar=True),
        "tiff_ycbcr_planar_no_tag": ycbcr_tiff(ycc, None, planar=True),
        "tiff_ycbcr_14": ycbcr_tiff(ycc, (1, 4)),
        "tiff_ycbcr_24": ycbcr_tiff(ycc, (2, 4)),
        "tiff_ycbcr_31": ycbcr_tiff(ycc, (3, 1)),
        "tiff_ycbcr_one_sample": tif(
            lf.image_tags(W, H, (8,), 6, 8, t530=(3, [1, 1])),
            [zlib.compress(grey.tobytes())]),
        "tiff_ojpeg_rgb_minisblack": lf.tiff_file(*_retag(
            lf.old_jpeg_tables(p["RGB"]), {262: 1})),
        "sgi_run_past_row": sgi_overrun(grey),
        "sgi_dimension3_two_channels": lf.sgi(np.stack([grey] * 2, -1)),
        "sgi_storage2": bytes([1, 0xDA, 2]) + lf.sgi(grey, False)[3:],
        "pcx_2bit": bytes(lf.pcx(grey, 8, 1)[:3]) + b"\x02" + lf.pcx(
            grey, 8, 1)[4:],
        "pcx_run_past_line": pcx_overrun(grey),
        "cur_png_entry": lf.icon([(W, H, 0, 1, 32, pillow_save(
            p["RGBA"], "PNG"))], kind=2),
        "dcx_no_pages": struct.pack("<II", 0x3ADE68B1, 0),
    }
    return out


def _retag(data: bytes, changes: dict) -> tuple:
    """(tags, strips, blobs) of a file written by tools/legacy_forms.py,
    parsed back, with `changes` {tag: value} applied: for files no writer
    option makes."""
    from nerf2mesh_tpu_torch.data.tiff import _ifd
    tags = _ifd(data, "<", struct.unpack_from("<I", data, 4)[0], False)
    strips = [data[o:o + c] for o, c in zip(tags.pop(273), tags.pop(279))]
    blobs = {}
    for t, size in ((519, 64), (520, None), (521, None)):
        if t in tags:
            blocks = []
            for o in tags.pop(t):
                n = size or 16 + sum(data[o:o + 16])
                blocks.append(data[o:o + n])
            blobs[t] = blocks
    out = {t: (3 if t in (258, 259, 262, 277, 512, 530) else 4, list(v))
           for t, v in tags.items()}
    for t, v in changes.items():
        out[t] = (3, [v])
    return out, strips, blobs


def sgi_overrun(grey: np.ndarray) -> bytes:
    """An SGI RLE file whose first row's literal run is one sample longer
    than the row."""
    d = bytearray(lf.sgi(grey))
    (start,) = struct.unpack_from(">I", d, 512)
    W = grey.shape[1]
    d[start:start + 1] = bytes([0x80 | min(W + 1, 127)])
    return bytes(d)


def pcx_overrun(grey: np.ndarray) -> bytes:
    """A PCX whose first run crosses its line's end."""
    d = lf.pcx(grey, 8, 1, end_palette=bytes(range(256)) * 3)
    W = grey.shape[1]
    stride = W + W % 2
    body = bytes([0xC0 | 63, 7]) * (-(-stride // 63) + 1)
    return d[:128] + body + d[128:]


REFUSED = refused_cases()


def not_read_cases() -> dict:
    """{name: bytes} whose prefix a new plugin accepts but which no plugin
    of the port reads (Pillow: UnidentifiedImageError, the port:
    ValueError)."""
    return {
        "cur_prefix_no_entries_not_tga": b"\0\0\2\0\0\0" + b"\xff" * 40,
        "ico_prefix_no_entries": b"\0\0\1\0\0\0" + b"\xff" * 40,
    }


def dispatch_cases() -> dict:
    """{name: bytes} that a new plugin's _accept takes, whose _open passes
    it over, and that a later plugin (TGA) reads."""
    rgb = picture()["RGB"]
    tga = pillow_save(rgb, "TGA")
    assert tga[:4] == b"\0\0\2\0"                 # CUR's _accept takes it
    ided = bytearray(tga[:18])
    ided[0] = 10                                   # a 10-byte image ID
    ided[3:8] = b"\x01\x02\x03\x04\x05"            # PCX: an empty box
    pcx_like = bytes(ided) + b"0123456789" + tga[18:]
    return {"tga_with_cur_prefix": tga, "tga_with_pcx_prefix": pcx_like}


NOT_READ = not_read_cases()
DISPATCH = dispatch_cases()


def test_case_sizes():
    """Each variant is at most 64^2, and the committed set stays small
    (the 64^2 icons, 32-bit among them, take most of it)."""
    for rel, data in CASES.items():
        h, w = np.asarray(Image.open(io.BytesIO(data))).shape[:2]
        assert h * w <= 64 * 64, rel
    assert sum(len(d) for d in CASES.values()) < 400_000


@pytest.mark.parametrize("rel", sorted(CASES))
def test_reads_as_pillow(rel, tmp_path):
    data = CASES[rel]
    name = rel.rsplit("/", 1)[1]
    assert sha(port_array(data, tmp_path, name)) == sha(
        pillow_array(data, tmp_path, name)), rel


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_as_pillow_refuses(name, tmp_path):
    data = REFUSED[name]
    with pytest.raises(Exception):
        pillow_array(data, tmp_path, name)
    with pytest.raises(ValueError):
        port_array(data, tmp_path, name)


@pytest.mark.parametrize("name", sorted(NOT_READ))
def test_prefix_nothing_reads(name, tmp_path):
    from PIL import UnidentifiedImageError
    with pytest.raises(UnidentifiedImageError):
        pillow_array(NOT_READ[name], tmp_path, name)
    with pytest.raises(ValueError, match="no reader takes this file"):
        port_array(NOT_READ[name], tmp_path, name)


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_prefix_passed_over_to_tga(name, tmp_path):
    """Pillow's CUR or PCX plugin accepts the prefix, its _open gives up,
    and Image.open reads the file as TGA; so does the port."""
    data = DISPATCH[name]
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "TGA"
    assert sha(port_array(data, tmp_path, name)) == sha(
        pillow_array(data, tmp_path, name))


def test_truncated_group4_strip_matches_pillow(tmp_path):
    """The cut strip reads in Pillow to another array than the whole one
    (libtiff repaired its last row), and the port gives Pillow's array."""
    p = picture()
    data = CASES["formats/tiff/legacy_ccitt_g4_truncated.tif"]
    want = pillow_array(data, tmp_path)
    whole = pillow_array(pillow_save(p["1"], "TIFF", compression="group4"),
                         tmp_path, "whole")
    assert not np.array_equal(want, whole)
    np.testing.assert_array_equal(want[:-1], whole[:-1])
    assert sha(port_array(data, tmp_path)) == sha(want)
    # cut in the middle: the rows up to the repaired one are Pillow's; the
    # rest are whatever Pillow's buffer held, and white in the port
    d = bytearray(pillow_save(p["1"], "TIFF", compression="group4"))
    at = tiff_ifd_entry(d, 279)
    struct.pack_into("<I", d, at + 8, struct.unpack_from("<I", d, at + 8)[0]
                     // 2)
    want = pillow_array(bytes(d), tmp_path, "half")
    got = port_array(bytes(d), tmp_path, "half")
    r = int(np.flatnonzero((want != whole).any(1))[0]) + 1
    assert 0 < r < len(want) - 1
    np.testing.assert_array_equal(got[:r], want[:r])
    photometric = d[tiff_ifd_entry(d, 262) + 8]
    assert (got[r:] == (photometric == 0)).all()   # 0 bits: white runs


def fax_run_image() -> np.ndarray:
    """Rows of white and black runs of every terminating length 0-63 and
    every make-up length to 2560 (plus 63), and runs past 2560."""
    lengths = list(range(1, 64)) + [64 * m + 63 for m in range(1, 41)] + [
        2560, 2600, 5200]
    rows = []
    W = 5400
    for k, n in enumerate(lengths):
        row = np.zeros(W, bool)
        a = (k * 37) % 50
        row[a:a + n] = True                # a black run of n
        if k % 2:
            row = ~row                     # and a white run of n
        rows.append(row)
    return np.stack(rows)


@pytest.mark.parametrize("kind", ["tiff_ccitt", "group3", "group3_2d",
                                  "group4", "rlew_writer"])
def test_fax_code_tables_against_pillow(kind, tmp_path):
    """Every terminating and make-up code of both colours, through Pillow's
    libtiff encoder (the oracle for the decoder's tables) and this
    module's T.4 writer."""
    img = fax_run_image()
    H, W = img.shape
    if kind == "rlew_writer":
        data = lf.tiff_file(lf.image_tags(W, H, (1,), 0, 32771),
                            [lf.fax_mh(img, 16)])
    else:
        comp = "group3" if kind == "group3_2d" else kind
        info = {292: 1} if kind == "group3_2d" else {}
        data = pillow_save(img, "TIFF", compression=comp, tiffinfo=info)
    want = pillow_array(data, tmp_path)
    assert sha(port_array(data, tmp_path)) == sha(want)
    if kind != "rlew_writer":
        np.testing.assert_array_equal(want, img)


def test_writers_hold_to_pillow(tmp_path):
    """The writers' check: each decodes in Pillow to the image it was
    written from (bilevel rows, 4-bit samples, SGI samples and their high
    bytes, PCX indices, icon pixels), or within JPEG's loss."""
    p = picture()
    one, H, W = p["1"], 37, 29
    mh = lf.tiff_file(lf.image_tags(W, H, (1,), 0, 2), [lf.fax_mh(one)])
    np.testing.assert_array_equal(pillow_array(mh, tmp_path), ~one)
    th = CASES["formats/tiff/legacy_thunderscan_photometric1.tif"]
    np.testing.assert_array_equal(pillow_array(th, tmp_path),
                                  picture(64, 64, 5)["L4"] * 17)
    for rel in ("formats/tiff/legacy_ojpeg_jif_420.tif",
                "formats/tiff/legacy_ojpeg_tables_420.tif"):
        got = pillow_array(CASES[rel], tmp_path).astype(float)
        assert np.abs(got - p["RGB"]).mean() < 12, rel
    np.testing.assert_array_equal(
        pillow_array(CASES["formats/sgi/rle8_rgba.sgi"], tmp_path), p["RGBA"])
    np.testing.assert_array_equal(
        pillow_array(CASES["formats/sgi/rle16_rgb.sgi"], tmp_path), p["RGB"])
    idx = (p["L"] >> 4) % 4
    np.testing.assert_array_equal(
        pillow_array(CASES["formats/pcx/planes2_w29.pcx"], tmp_path), idx)
    ico = pillow_array(CASES["formats/ico/bmp32.ico"], tmp_path)
    np.testing.assert_array_equal(ico, picture(64, 64, 6)["RGBA"])
    assert Image.open(io.BytesIO(CASES["formats/ico/cur_bmp32.cur"])
                      ).format == "CUR"


def test_ojpeg_sampling_in_the_stream_wins(tmp_path):
    """A 4:2:2 stream under a YCbCrSubsampling tag of (2, 2): libtiff
    takes the stream's sampling (OJPEGSubsamplingCorrect), and the array is
    the one of the same stream with a matching tag."""
    rgb = picture()["RGB"]
    a = pillow_array(lf.old_jpeg_jif(rgb, (2, 1), tag_sampling=(2, 2)),
                     tmp_path, "a")
    b = pillow_array(lf.old_jpeg_jif(rgb, (2, 1), tag_sampling=(2, 1)),
                     tmp_path, "b")
    np.testing.assert_array_equal(a, b)


def test_ojpeg_converts_through_libtiffs_tables(tmp_path):
    """Old-style JPEG YCbCr goes through libtiff's TIFFYCbCrtoRGB (the
    RGBA interface), not libjpeg's conversion: the array differs from the
    JPEG stream decoded as a JPEG, and equals the raw planes through the
    float32 tables of data/tiff.py."""
    from nerf2mesh_tpu_torch.data.jpeg import COLOUR_RAW, decode_jpeg_tables
    from nerf2mesh_tpu_torch.data.tiff import _ycbcr_rgb
    data = CASES["formats/tiff/legacy_ojpeg_jif_420.tif"]
    want = pillow_array(data, tmp_path)
    jif_at = struct.unpack_from("<I", data, tiff_ifd_entry(data, 513) + 8)[0]
    n = struct.unpack_from("<I", data, tiff_ifd_entry(data, 514) + 8)[0]
    jpeg = data[jif_at:jif_at + n]
    assert not np.array_equal(want, np.asarray(Image.open(io.BytesIO(jpeg))))
    np.testing.assert_array_equal(
        _ycbcr_rgb(decode_jpeg_tables(b"", jpeg, COLOUR_RAW), None, None),
        want)


# ------------------------------------------------------- capture and masks
def encode_frame(rgb: np.ndarray, kind: str) -> tuple:
    """(extension, bytes) of a capture frame in `kind`."""
    H, W = rgb.shape[:2]
    if kind == "ojpeg_jif":
        return "tif", lf.old_jpeg_jif(rgb, (2, 2), 90, tag_sampling=(2, 2))
    if kind == "ojpeg_tables":
        return "tif", lf.old_jpeg_tables(rgb, (2, 1), 90, rows_per_strip=32)
    if kind in ("lzma", "zstd"):
        return "tif", pillow_save(rgb, "TIFF", compression=kind,
                                  tiffinfo={317: 2})
    if kind == "ycbcr_planar":
        ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
        return "tif", ycbcr_tiff(ycc, (1, 1), planar=True)
    if kind == "sgi_rle8":
        return "sgi", lf.sgi(rgb)
    if kind == "sgi_rle16":
        return "sgi", lf.sgi(rgb.astype(np.uint16) * 257)
    if kind == "pcx_rgb":
        return "pcx", pillow_save(rgb, "PCX")
    if kind == "dcx":
        return "dcx", lf.dcx([pillow_save(rgb, "PCX")])
    if kind == "ico_bmp32":
        rgba = np.concatenate([rgb, np.full((H, W, 1), 255, np.uint8)], -1)
        return "ico", lf.icon([(W, H, 0, 1, 32, lf.dib(rgba, 32))])
    if kind == "cur":
        return "cur", lf.icon([(W, H, 0, 3, 5, lf.dib(rgb, 24))], kind=2)
    raise KeyError(kind)


def encode_mask(mask: np.ndarray, kind: str) -> bytes:
    """A [H, W] uint8 mask (0 or 255) as 8-bit SGI RLE, PCX or LZMA TIFF,
    or a bilevel Group 4 TIFF (read as 0/1 by both packages)."""
    if kind == "sgi":
        return lf.sgi(mask)
    if kind == "pcx":
        return pillow_save(mask, "PCX")
    if kind == "lzma":
        return pillow_save(mask, "TIFF", compression="lzma")
    return pillow_save(mask > 0, "TIFF", compression="group4")


def make_capture(root: str) -> None:
    """A 16-view 96^2 COLMAP capture whose i-th frame is in FRAME_KINDS[i %
    11] (renamed in images.bin), its mask in MASK_KINDS[i % 4] under the
    name the providers look for (mask/<stem>.png: both packages read a file
    by its content)."""
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
        stem = os.path.splitext(im.name)[0]
        ext, data = encode_frame(rgb, FRAME_KINDS[i % len(FRAME_KINDS)])
        name = f"{stem}.{ext}"
        Path(root, "images", name).write_bytes(data)
        os.remove(src)
        ims[k] = dataclasses.replace(im, name=name)
        mask = ((rgb.astype(int).sum(-1) > 60) * 255).astype(np.uint8)
        Path(root, "mask", stem + ".png").write_bytes(
            encode_mask(mask, MASK_KINDS[i % len(MASK_KINDS)]))
    tcu.write_images_binary(ims, sp)


def test_capture_loads_as_jax():
    """The committed capture fixtures/colmap_legacy (frames in the eleven
    forms chip_smoke's phase 14 (h) trains on; SGI, PCX, LZMA TIFF and
    Group 4 masks): JAX's COLMAP provider (Pillow) and the port's (Pillow
    blocked) load equal images, masks, poses and intrinsics.  A Group 4
    mask is bilevel ("1"): both packages take its 0/1 as the alpha byte
    (ROADMAP C's raw-modes note), so those views' alpha is 0 or 1."""
    from nerf2mesh_tpu.config import parse_args as jparse
    from nerf2mesh_tpu.data.colmap import load_colmap_dataset as jload
    from nerf2mesh_tpu_torch.config import parse_args as tparse
    from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset as tload
    argv = [str(CAPTURE), "--bound", "4", "--enable_cam_near_far"]
    alphas = set()
    for split in ("train", "val"):
        want = jload(jparse(argv), split)
        with no_pillow():
            got = tload(tparse(argv), split)
        assert got.images.shape == want.images.shape
        assert got.images.shape[-1] == 4                 # the masks' alpha
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.poses, want.poses)
        np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
        alphas |= {int(a.max()) for a in got.images[..., 3]}
    assert alphas == {1, 255}          # the Group 4 masks' views, the rest
    names = sorted(os.listdir(CAPTURE / "images"))
    assert {n.rsplit(".", 1)[1] for n in names} == {
        "tif", "sgi", "pcx", "dcx", "ico", "cur"}


# ------------------------------------------------------- committed fixtures
def is_mine(rel: str) -> bool:
    return rel.startswith(("formats/tiff/legacy_", "formats/sgi/",
                           "formats/pcx/", "formats/ico/", "colmap_legacy/"))


def committed() -> list:
    out = sorted(CASES)
    for d in ("images", "mask"):
        out += [str(p.relative_to(FIXTURES))
                for p in sorted((CAPTURE / d).iterdir())]
    return out


def write_fixtures() -> None:
    """Writes every case, the capture fixtures/colmap_legacy/ and their
    entries in fixtures/formats.json; the other modules' entries stay."""
    import tempfile
    hashes = json.loads(FORMAT_HASHES.read_text())
    for k in [k for k in hashes if is_mine(k)]:
        del hashes[k]
    for d in ("sgi", "pcx", "ico"):
        shutil.rmtree(FIXTURES / "formats" / d, ignore_errors=True)
    for old in (FIXTURES / "formats" / "tiff").glob("legacy_*"):
        old.unlink()
    tmp = Path(tempfile.mkdtemp())
    for rel, data in sorted(CASES.items()):
        path = FIXTURES / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        hashes[rel] = sha(pillow_array(data, tmp))
    shutil.rmtree(CAPTURE, ignore_errors=True)
    make_capture(str(CAPTURE))
    for d in ("images", "mask"):
        for p in sorted((CAPTURE / d).iterdir()):
            hashes[str(p.relative_to(FIXTURES))] = sha(
                pillow_array(p.read_bytes(), tmp))
    shutil.rmtree(tmp)
    FORMAT_HASHES.write_text(json.dumps(dict(sorted(hashes.items())),
                                        indent=1) + "\n")


def test_committed_files_hash_to_pillow(tmp_path):
    """Every committed file of this module hashes to Pillow's array in
    formats.json, and the port reads each to the same hash."""
    want = json.loads(FORMAT_HASHES.read_text())
    files = committed()
    assert set(files) == {k for k in want if is_mine(k)}
    assert len([f for f in files if f.startswith("colmap_legacy/")]) == 32
    for rel in files:
        data = (FIXTURES / rel).read_bytes()
        name = rel.replace("/", "_")
        assert sha(pillow_array(data, tmp_path, name)) == want[rel], rel
        assert sha(port_array(data, tmp_path, name)) == want[rel], rel


def test_writers_reproduce_the_committed_bytes():
    """Every case, written again, equals its committed file."""
    for rel in sorted(CASES):
        assert (FIXTURES / rel).read_bytes() == CASES[rel], rel


def test_capture_writer_reproduces_frames(tmp_path):
    """The capture's writer gives the committed bytes again from the same
    synthetic frames (frames 0-3 and their masks)."""
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    root = tmp_path / "c"
    generate_colmap_dataset(str(root), H=96, W=96, n_images=16, n_points=400)
    names = sorted(os.listdir(root / "images"))[:4]
    for i, n in enumerate(names):
        with Image.open(root / "images" / n) as f:
            rgb = np.asarray(f.convert("RGB"))
        stem = os.path.splitext(n)[0]
        ext, data = encode_frame(rgb, FRAME_KINDS[i])
        assert data == (CAPTURE / "images" / f"{stem}.{ext}").read_bytes(), n
        mask = ((rgb.astype(int).sum(-1) > 60) * 255).astype(np.uint8)
        assert encode_mask(mask, MASK_KINDS[i]) == (
            CAPTURE / "mask" / f"{stem}.png").read_bytes(), n


def test_tiff_reader_raises_no_not_implemented():
    """data/tiff.py has no not-ported branch left: every form either reads
    as Pillow reads it or is refused with ValueError."""
    src = (REPO / "nerf2mesh_tpu_torch" / "data" / "tiff.py").read_text()
    assert "NotImplementedError" not in src


def test_reader_imports_no_pillow():
    """The readers decode committed files in a process where Pillow cannot
    be imported, and leave no PIL module loaded."""
    rels = ["formats/tiff/legacy_ccitt_g4.tif",
            "formats/tiff/legacy_ojpeg_tables_420.tif",
            "formats/sgi/rle16_rgba.sgi", "formats/pcx/dcx.dcx",
            "formats/ico/bmp4.ico", "formats/ico/cur_bmp32.cur"]
    paths = [str(FIXTURES / r) for r in rels]
    code = f"""
import sys
sys.modules["PIL"] = None
from nerf2mesh_tpu_torch.data import png
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
