"""The icon and small raster forms the port reads since ROADMAP A6 (j) 9
(a)-(d) against Pillow 12.1.0, on the CPU: ICNS (PNG entries in RGBA and
RGB, the latter "scrambled" as np.asarray packs them; JPEG 2000 entries
through convert("RGBA"); raw and RLE 24-bit entries with and without
masks), IM (every raw mode of ImImagePlugin.OPEN, its LUTs and Pillow's
bit decoder), MSP (version 1 raw and version 2 RLE), SPIDER (both byte
orders, stacks) and XBM (X10 and X11), and the refusals of what Pillow
identifies but cannot load here (BUFR, GRIB, HDF5, EPS, MPEG, WMF/EMF and
OLE compound files).

The oracle is ``np.asarray(Image.open(p))``, the array the JAX package's
providers see: every case must give its dtype, shape and bytes exactly.
Pillow writes ICNS (PNG entries), IM (its SAVE modes), MSP version 1,
SPIDER (native byte order) and X11 XBM; nerf2mesh_tpu_torch/tools/
icon_forms.py writes the rest.  What Pillow refuses, the port refuses with
ValueError, and the test shows Pillow refusing the same bytes.  The port's
side runs with Pillow blocked in sys.modules.  The committed files under
nerf2mesh_tpu_torch/fixtures/formats/{icns,im,msp,spider,xbm} and the
COLMAP capture fixtures/colmap_misc (written by ``python
tests/test_torch_iconforms.py``) hash to Pillow's arrays in
fixtures/formats.json.
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
from nerf2mesh_tpu_torch.tools import icon_forms as icf

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "nerf2mesh_tpu_torch" / "fixtures"
FORMAT_HASHES = FIXTURES / "formats.json"
# the COLMAP capture chip_smoke.py's phase 14 (j) trains on
CAPTURE = FIXTURES / "colmap_misc"
CAPTURE_SIZE = 128
FRAME_KINDS = ["icns_png_rgba", "icns_rle_mask", "icns_raw_mask", "icns_j2k",
               "icns_png_rgb", "im_rgb", "im_rgb_l", "spider", "icns_pillow"]
MASK_KINDS = ["msp1", "msp2", "xbm"]
SIZE = (48, 64)                  # an IM, MSP, SPIDER or XBM variant's H, W


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
    providers open frames."""
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


def picture(h=SIZE[0], w=SIZE[1], seed=0) -> dict:
    """A smooth picture with noise and flat patches: RGB, RGBA, grey, a
    bilevel image and 16-bit grey."""
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
    i16 = (xx * 1021 + yy * 517 + rng.integers(0, 300, (h, w))).astype(
        np.uint16)
    return {"RGB": rgb, "RGBA": np.concatenate([rgb, alpha[..., None]], -1),
            "L": grey, "1": bilevel, "I;16": i16}


def pillow_save(a, fmt: str, mode: str | None = None, **kw) -> bytes:
    """An array (or a Pillow image), converted to `mode`, saved by
    Pillow."""
    im = a if isinstance(a, Image.Image) else Image.fromarray(a)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def png16(a: np.ndarray) -> bytes:
    """A 16-bit PNG of uint16 [H, W, C] samples (C = 2, 3 or 4), filter 0."""
    import zlib
    H, W, C = a.shape
    raw = b"".join(b"\0" + a[y].astype(">u2").tobytes() for y in range(H))

    def chunk(k, b):
        return (struct.pack(">I", len(b)) + k + b
                + struct.pack(">I", zlib.crc32(k + b)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, 16, {2: 4, 3: 2, 4: 6}[C], 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# ----------------------------------------------------------------- cases
def smooth(h: int, w: int, seed: int) -> dict:
    """A picture with runs (flat bands and patches) and a noisy strip:
    what the RLE writer packs small, with literals where it must."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([(xx // 8) * 30 % 256, (yy // 4) * 17 % 256,
                    ((xx + yy) // 16) * 40 % 256], -1).astype(np.uint8)
    rgb[h // 3:h // 3 + 6] = rng.integers(0, 256, (6, w, 3), dtype=np.uint8)
    grey = ((xx // 4 + yy // 4) * 9 % 256).astype(np.uint8)
    return {"RGB": rgb, "L": grey,
            "RGBA": np.concatenate([rgb, grey[..., None]], -1)}


def icns_cases(p) -> dict:
    big = smooth(128, 128, 1)
    p64 = picture(64, 64, 5)
    s48, s32, s16 = picture(48, 48, 2), picture(32, 32, 3), picture(16, 16,
                                                                     4)
    j = "formats/icns/"
    return {
        j + "png_rgba_icp6.icns": icf.icns([(b"icp6", pillow_save(
            p64["RGBA"], "PNG"))]),
        j + "png_rgb_icp6_scrambled.icns": icf.icns([(b"icp6", pillow_save(
            p64["RGB"], "PNG"))]),
        j + "png_rgba_64_in_ic10.icns": icf.icns([(b"ic10", pillow_save(
            picture(64, 64, 6)["RGBA"], "PNG"))]),
        j + "png_rgb16_icp5.icns": icf.icns([(b"icp5", png16(
            s32["RGB"].astype(np.uint16) * 257 + 3))]),
        j + "png_la16_icp6.icns": icf.icns([(b"icp6", png16(np.stack(
            [p64["I;16"], picture(64, 64, 7)["I;16"]], -1)))]),
        j + "j2k_grey_jp2_ic12.icns": icf.icns([(b"ic12", pillow_save(
            p64["L"], "JPEG2000"))]),
        j + "j2k_la_jp2.icns": icf.icns([(b"icp6", pillow_save(
            picture(64, 64, 8)["RGBA"], "JPEG2000", "LA"))]),
        j + "j2k_rgb_codestream.icns": icf.icns([(b"icp6", pillow_save(
            p64["RGB"], "JPEG2000", no_jp2=True))]),
        j + "j2k_rgba_irreversible.icns": icf.icns([(b"ic12", pillow_save(
            picture(64, 64, 9)["RGBA"], "JPEG2000", irreversible=True))]),
        j + "j2k_i16_clipped.icns": icf.icns([(b"icp6", pillow_save(
            Image.fromarray(picture(64, 64, 10)["I;16"] // 200),
            "JPEG2000"))]),
        j + "rle_mask_it32.icns": icf.icns([
            (b"it32", b"\0\0\0\0" + icf.icns_rgb(big["RGB"])),
            (b"t8mk", big["L"].tobytes())]),
        j + "raw_it32_scrambled.icns": icf.icns([
            (b"it32", b"\0\0\0\0" + icf.icns_rgb(big["RGB"], rle=False))]),
        j + "rle_it32_scrambled.icns": icf.icns([
            (b"it32", b"\0\0\0\0" + icf.icns_rgb(big["RGB"][::-1]))]),
        j + "raw_mask_ih32.icns": icf.icns([
            (b"ih32", icf.icns_rgb(s48["RGB"], rle=False)),
            (b"h8mk", s48["L"].tobytes())], toc=True),
        j + "rle_il32_with_smaller.icns": icf.icns([
            (b"is32", icf.icns_rgb(s16["RGB"])),
            (b"s8mk", s16["L"].tobytes()),
            (b"il32", icf.icns_rgb(s32["RGB"])),
            (b"l8mk", s32["L"].tobytes())], toc=True),
        j + "png_wins_over_rgb_mask.icns": icf.icns([
            (b"il32", icf.icns_rgb(s32["RGB"])),
            (b"l8mk", s32["L"].tobytes()),
            (b"icp5", pillow_save(s32["RGBA"][::-1].copy(), "PNG"))]),
        j + "duplicate_block_last_wins.icns": icf.icns([
            (b"is32", icf.icns_rgb(s16["RGB"][::-1].copy())),
            (b"s8mk", s16["L"].tobytes()),
            (b"is32", icf.icns_rgb(s16["RGB"]))]),
    }


# Pillow's IM writer: mode -> the picture's array it takes
IM_PILLOW = {"1": "1", "L": "L", "LA": "RGBA", "P": "RGB", "PA": "RGBA",
             "I": "I;16", "I;16": "I;16", "I;16L": "I;16", "I;16B": "I;16",
             "F": "I;16", "RGB": "RGB", "RGBA": "RGBA", "RGBX": "RGBA",
             "CMYK": "RGBA", "YCbCr": "RGB"}


# the IM variants written to fixtures/formats/im (the rest are held to
# Pillow at test time only, to keep the committed files small)
IM_COMMITTED = {"x24_rgb", "rgb3_planes", "b2_palette", "b4_palette",
                "l_colour_lut", "la_colour_lut", "l32f_uint_to_float",
                "l16s_float", "bits12_float", "bits7_leftover"}


def im_cases(p, committed: bool = True) -> dict:
    H, W = SIZE
    rng = np.random.default_rng(11)
    out = {}
    for mode, src in IM_PILLOW.items():
        a = p[src]
        if mode in ("I;16L", "I;16B"):
            im = Image.fromarray(a).convert("I").convert("I;16")
            im = Image.frombytes(mode, im.size, a.astype(
                "<u2" if mode == "I;16L" else ">u2").tobytes())
        elif mode == "F":
            im = Image.fromarray(a.astype(np.float32) / 7 - 1000)
        elif mode == "I":
            im = Image.fromarray(a.astype(np.int32) * 3001 - 2 ** 27)
        elif mode == "P":
            im = Image.fromarray(a).convert("P")
        else:
            im = Image.fromarray(a)
        name = mode.replace(";", "_")
        if committed:
            out[f"formats/im/pillow_{name}.im"] = pillow_save(im, "IM", mode)
    grey, rgb, rgba = p["L"], p["RGB"], p["RGBA"]
    colour = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    ramp = bytes(255 - i for i in range(256)) * 3
    rnd = rng.integers(0, 256, (H, W * 4), dtype=np.uint8)

    def im(name, itype, body, **kw):
        if (name in IM_COMMITTED) == committed:
            out[f"formats/im/{name}.im"] = icf.im_header(itype, W, H,
                                                         **kw) + body

    im("x24_rgb", "X 24 image", icf.im_rows(rgb.reshape(H, -1)))
    im("rgb3_planes", "RGB3 image", b"".join(icf.im_rows(rgb[..., c])
                                             for c in (1, 0, 2)))
    im("ryb3_planes", "RYB3 image", b"".join(icf.im_rows(rgb[..., c])
                                             for c in (2, 1, 0)))
    im("b2_palette", "B2 image", icf.im_packed(grey >> 6, 2))
    im("b4_palette", "B4 image", icf.im_packed(grey >> 4, 4))
    im("b2_colour_lut", "B2 image", icf.im_rows(grey), lut=colour)
    im("l_colour_lut", "Greyscale image", icf.im_rows(grey), lut=colour)
    im("l_reversed_lut", "Grayscale image", icf.im_rows(grey), lut=ramp)
    im("la_colour_lut", "LA image", icf.im_lines(rgba[..., 2:]), lut=colour)
    im("pa_colour_lut", "PA image", icf.im_lines(rgba[..., 1:3]), lut=colour)
    im("rgb_lut", "RGB image", icf.im_lines(rgb), lut=colour)
    im("b1_bilevel", "B1 image", icf.im_packed(p["1"], 1))
    im("l1_bilevel", "L 1 image", icf.im_packed(p["1"], 1))
    im("l32s_int", "L 32 S image", icf.im_rows(rnd))
    im("l32f_uint_to_float", "L 32 F image", icf.im_rows(rnd))
    im("l8_float", "L 8 image", icf.im_rows(grey))
    im("l8s_float", "L*8S image", icf.im_rows(rnd[:, :W]))
    im("l16_float", "L*16 image", icf.im_rows(rnd[:, :2 * W]))
    im("l16s_float", "L 16S image", icf.im_rows(rnd[:, :2 * W]))
    im("l32_float", "L 32 image", icf.im_rows(rnd))
    for bits in (3, 5, 12, 24, 31):
        vals = rng.integers(0, 2 ** bits, (H, W), dtype=np.uint64)
        im(f"bits{bits}_float", f"L*{bits} image",
           icf.im_packed(vals, bits, lsb_first=True))
    # the bits a row leaves over go into the next row's first byte
    im("bits7_leftover", "L*7 image", icf.im_rows(rnd[:, :(W * 7 + 7) // 8]))
    im("ycc_lines", "YCC image", icf.im_lines(rgb))
    im("cmyk_lines", "CMYK image", icf.im_lines(rgba))
    im("rgbx_lines", "RGBX image", icf.im_lines(rgba))
    im("comments_and_scale", "Greyscale image", icf.im_rows(grey),
       lines=("Comment: one", "Comment: two", "Scale (x,y): 1.5,2",
              "Date: 1999"), eol=b"\n")
    im("header_ends_at_eof_marker", "Greyscale image", icf.im_rows(grey),
       end=b"\x1a")
    return out


def msp_cases(p) -> dict:
    H, W = SIZE
    m = p["1"]
    packed = np.packbits(m, axis=1)
    rows = [icf.msp_rle_row(r.tobytes()) for r in packed]
    rows[3] = b""                                   # a blank (white) line
    rows[5] = rows[5] + b"\x02\xaa\x55"             # decodes 2 bytes long
    rows[9] = b"\x03\x0f\xf0\x0f"                  # decodes 5 bytes short
    rows[10] = rows[10] + b"\x00\x08\xcc"          # 8 bytes long
    return {
        "formats/msp/pillow_v1.msp": pillow_save(m, "MSP"),
        "formats/msp/v2_rle.msp": icf.msp2(m),
        "formats/msp/v2_rle_uneven_rows.msp": icf.msp2(m, rows) + b"\0" * 64,
        "formats/msp/v2_rle_odd_width.msp": icf.msp2(m[:, :61]),
    }


def spider_cases(p) -> dict:
    f = (p["I;16"].astype(np.float32) - 30000) / 17
    return {
        "formats/spider/pillow.spi": pillow_save(f, "SPIDER"),
        "formats/spider/big_endian.spi": icf.spider(f, big_endian=True),
    }


def extra_cases(p) -> dict:
    """Cases held to Pillow at test time only: the IM variants beyond
    IM_COMMITTED, SPIDER in other widths and as a stack, msp's odd width."""
    f = (p["I;16"].astype(np.float32) - 30000) / 17
    out = im_cases(p, committed=False)
    out["formats/spider/little_endian_40.spi"] = icf.spider(f[:, :40])
    out["formats/spider/stack_first_image.spi"] = icf.spider(f, stack=3)
    out["formats/spider/big_endian_stack.spi"] = icf.spider(
        f[:8], big_endian=True, stack=2)
    return out


def xbm_cases(p) -> dict:
    m = p["1"]
    return {
        "formats/xbm/pillow_x11.xbm": pillow_save(m, "XBM"),
        "formats/xbm/x11_hotspot.xbm": icf.xbm(m[:, :61], hotspot=(3, 7)),
        # an X10 short gives Pillow one byte, its first two digits: only a
        # file of at most 8 columns has the tokens its rows need
        "formats/xbm/x10_shorts_8_wide.xbm": icf.xbm(m[:, :8], x10=True),
        "formats/xbm/leading_whitespace.xbm": icf.xbm(m, lead=b" \n\t"),
    }


def all_cases() -> dict:
    p = picture()
    out = {}
    for f in (icns_cases, im_cases, msp_cases, spider_cases, xbm_cases):
        out.update(f(p))
    return out


CASES = all_cases()
EXTRA = extra_cases(picture())


def eps(*lines: str) -> bytes:
    return "\n".join(lines).encode() + b"\n"


def wmf_placeable(inch: int, box=(0, 0, 200, 100), sig=b"\x01\x00\t\x00"):
    return (b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<4hH", *box, inch)
            + b"\0" * 6 + sig + b"\0" * 40)


def emf(frame=(0, 0, 2540, 2540)) -> bytes:
    return (struct.pack("<II", 1, 88) + struct.pack("<4i", 0, 0, 100, 50)
            + struct.pack("<4i", *frame) + b" EMF" + b"\0" * 50)


def refused_cases() -> dict:
    """{name: bytes} Pillow refuses to read; the port raises ValueError."""
    p = picture(16, 16, 12)
    big = picture(128, 128, 13)
    H, W = SIZE
    ps = "%!PS-Adobe-3.0 EPSF-3.0"
    rle = icf.icns_rgb(p["RGB"])
    return {
        # identified, not loadable here
        "bufr": b"BUFR" + bytes(60),
        "bufr_zczc": b"ZCZC" + bytes(60),
        "grib_edition_1": b"GRIB\0\0\0\x01" + bytes(60),
        "hdf5": b"\x89HDF\r\n\x1a\n" + bytes(60),
        "mpeg": b"\x00\x00\x01\xb3\x14\x00\xf0" + bytes(60),
        "eps": eps(ps, "%%BoundingBox: 0 0 40 30", "%%EndComments",
                   "showpage"),
        "eps_dos_binary": struct.pack("<III", 0xC6D3D0C5, 28, 60) + bytes(
            16) + eps(ps, "%%BoundingBox: 0 0 40 30", "%%EndComments"),
        "eps_imagedata": eps(ps, "%%BoundingBox: 0 0 4 3", "%%EndComments",
                             "%ImageData: 8 6 8 3 0 1 0 \"b\""),
        "eps_bad_header_line": eps(ps, "%%BoundingBox: 0 0 4 3", "x"),
        "eps_no_bounding_box_value": eps(ps, "%%BoundingBox: none",
                                         "%%EndComments"),
        # the plugin does not clear its line buffer after %%EndComments, so
        # the next line is joined to it and this %ImageData goes unseen
        "eps_line_after_end_comments_joined": eps(
            ps, "%%BoundingBox: 0 0 4 3", "%%EndComments",
            "%ImageData: 4 3 8 9"),
        "wmf_placeable": wmf_placeable(1440),
        "wmf_inch_0": wmf_placeable(0),
        "emf": emf(),
        "emf_empty_frame": emf((0, 0, 0, 2540)),
        "ole_compound_file": b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1" + bytes(504),
        # ICNS load failures
        "icns_png_entry_grey": icf.icns([(b"icp4", pillow_save(
            p["L"], "PNG"))]),
        "icns_png_entry_palette": icf.icns([(b"icp4", pillow_save(
            p["RGB"], "PNG", "P"))]),
        "icns_png_entry_i16": icf.icns([(b"icp4", pillow_save(
            Image.fromarray(p["I;16"]), "PNG"))]),
        "icns_size_not_allowed": icf.icns([(b"ic10", pillow_save(
            picture(60, 60, 14)["RGBA"], "PNG"))]),
        "icns_rle_band_short": icf.icns([(b"is32", rle[:-40])]),
        "icns_rle_run_across_band": icf.icns([(b"is32", bytes([255, 7]) * 3
                                               + rle)]),
        "icns_it32_bad_signature": icf.icns([(b"it32", b"\0\0\0\1" +
                                              icf.icns_rgb(big["RGB"]))]),
        "icns_mask_without_rgb": icf.icns([(b"s8mk", bytes(256))]),
        "icns_mask_cut_short": icf.icns([(b"is32", rle),
                                         (b"s8mk", bytes(100))]),
        "icns_unknown_subimage": icf.icns([(b"ic07", b"GIF89a" + bytes(40))]),
        # IM, MSP, SPIDER, XBM
        "im_rlb": icf.im_header("RLB image", W, H) + bytes(3 * W * H),
        "im_pa_without_colour_lut": icf.im_header("PA image", W, H)
        + bytes(2 * W * H),
        "im_truncated": icf.im_header("RGB image", W, H) + bytes(100),
        "im_scale_not_a_number": icf.im_header("Greyscale image", W, H,
                                              lines=("Scale (x,y): x*y",)),
        "msp_v1_truncated": pillow_save(p["1"], "MSP")[:40],
        "msp_v2_row_cut_short": icf.msp2(p["1"])[:-3],
        "msp_v2_run_cut_short": icf.msp2(p["1"], [b"\x00\x05"] * 16),
        "spider_truncated": icf.spider(p["L"].astype(np.float32))[:-4],
        "xbm_truncated": icf.xbm(p["1"])[:-30],
        "xbm_x10_wider_than_8": icf.xbm(p["1"], x10=True),
    }


REFUSED = refused_cases()
# refusals Pillow reports as an unidentified image
UNIDENTIFIED = {"ole_compound_file"}


def not_read_cases() -> dict:
    """{name: bytes} whose prefix a plugin accepts but whose _open
    Image.open passes over, and no other plugin reads (Pillow:
    UnidentifiedImageError, the port: ValueError)."""
    return {
        "icns_no_known_slot": icf.icns([(b"TOC ", b""), (b"abcd", b"1234")]),
        "icns_block_size_0": b"icns" + struct.pack(">I", 64) + b"is32" +
        bytes(4),
        "icns_header_cut": b"icns" + struct.pack(">I", 64) + b"is32",
        "grib_edition_2": b"GRIB\0\0\0\x02" + bytes(60),
        "mpeg_cut_short": b"\x00\x00\x01\xb3\x14\x00",
        "mpeg_size_0": b"\x00\x00\x01\xb3\x00\x00\x00" + bytes(20),
        "eps_no_bounding_box": eps("%!PS-Adobe-3.0", "%%EndComments"),
        "eps_bounding_box_of_2": eps("%!PS-Adobe-3.0", "%%BoundingBox: 1 2",
                                     "%%EndComments"),
        "eps_imagedata_mode_9": eps("%!PS-Adobe-3.0",
                                    "%%BoundingBox: 0 0 4 3",
                                    "%%EndComments", "%%Page: 1 1",
                                    "%ImageData: 4 3 8 9"),
        "wmf_not_placeable_header": wmf_placeable(1440, sig=b"\0\0\0\0"),
        "wmf_size_0": wmf_placeable(1440, box=(5, 5, 5, 9)),
        "msp_bad_checksum": b"DanM" + bytes(60),
        "xbm_no_bits": b"#define t_width 8\n#define t_height 2\n",
        "xbm_width_0": b"#define t_width 0\n#define t_height 2\nt_bits[] =",
        "spider_iform_3": icf.spider(np.zeros((8, 8), np.float32))[:16] +
        struct.pack("<f", 3.0) + icf.spider(np.zeros((8, 8), np.float32))[
            20:],
        "im_unknown_key_only": b"Foo: bar\n" + bytes(600),
    }


NOT_READ = not_read_cases()


# ------------------------------------------------------------------ tests
def test_case_sizes():
    """Each variant is at most 64^2 but ICNS slots that need more, and the
    committed set stays small."""
    for rel, data in {**CASES, **EXTRA}.items():
        h, w = np.asarray(Image.open(io.BytesIO(data))).shape[:2]
        assert h * w <= 64 * 64 or rel.startswith("formats/icns/"), rel
    assert sum(len(d) for d in CASES.values()) < 500_000


@pytest.mark.parametrize("rel", sorted(CASES) + sorted(EXTRA))
def test_reads_as_pillow(rel, tmp_path):
    data = CASES.get(rel) or EXTRA[rel]
    name = rel.rsplit("/", 1)[1]
    assert sha(port_array(data, tmp_path, name)) == sha(
        pillow_array(data, tmp_path, name)), rel


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_as_pillow_refuses(name, tmp_path):
    from PIL import UnidentifiedImageError
    data = REFUSED[name]
    with pytest.raises(Exception) as e:
        pillow_array(data, tmp_path, name)
    assert isinstance(e.value, UnidentifiedImageError) == (
        name in UNIDENTIFIED), (name, e.value)
    with pytest.raises(ValueError):
        port_array(data, tmp_path, name)


@pytest.mark.parametrize("name", sorted(NOT_READ))
def test_prefix_nothing_reads(name, tmp_path):
    from PIL import UnidentifiedImageError
    with pytest.raises(UnidentifiedImageError):
        pillow_array(NOT_READ[name], tmp_path, name)
    with pytest.raises(ValueError, match="no reader takes this file"):
        port_array(NOT_READ[name], tmp_path, name)


def test_icns_rgb_entries_read_scrambled(tmp_path):
    """An RGB PNG entry and a maskless 24-bit entry come back as Pillow's
    RGBA packer lays the RGB core out, shaped as RGB: the pixels with a pad
    byte each (255 after PNG and raw data, 0 after RLE), cut to H * W * 3;
    an RGBA PNG entry comes back as it is."""
    p = picture(16, 16, 15)
    rgb = p["RGB"]

    def packed(pad):
        px = np.concatenate([rgb, np.full((16, 16, 1), pad, np.uint8)], -1)
        return px.reshape(-1)[:16 * 16 * 3].reshape(16, 16, 3)

    for entry, pad in ((pillow_save(rgb, "PNG"), 255),
                       (icf.icns_rgb(rgb, rle=False), 255),
                       (icf.icns_rgb(rgb), 0)):
        code = b"icp4" if entry[:4] == b"\x89PNG" else b"is32"
        data = icf.icns([(code, entry)])
        np.testing.assert_array_equal(pillow_array(data, tmp_path),
                                      packed(pad))
        np.testing.assert_array_equal(port_array(data, tmp_path),
                                      packed(pad))
    data = icf.icns([(b"icp4", pillow_save(p["RGBA"], "PNG"))])
    np.testing.assert_array_equal(port_array(data, tmp_path), p["RGBA"])


def test_icns_jpeg2000_i16_clips(tmp_path):
    """An I;16 JPEG 2000 entry goes through convert("RGBA"): each sample
    clipped to 255 in R, G and B, alpha 255."""
    v = np.array([[0, 1, 254, 255], [256, 1000, 62501, 65535]], np.uint16)
    v = np.repeat(np.repeat(v, 8, 0), 4, 1)                   # 16 x 16
    data = icf.icns([(b"icp4", pillow_save(Image.fromarray(v),
                                           "JPEG2000"))])
    want = np.minimum(v, 255).astype(np.uint8)
    want = np.stack([want, want, want, np.full_like(want, 255)], -1)
    np.testing.assert_array_equal(pillow_array(data, tmp_path), want)
    np.testing.assert_array_equal(port_array(data, tmp_path), want)


def test_icns_size_setter(tmp_path):
    """A PNG entry's size is its own: 64^2 in the 1024 slot reads, as does
    32^2 in the 64 slot beside it; 60^2 is refused by both."""
    for code, side, ok in ((b"ic10", 64, True), (b"ic12", 32, True),
                           (b"ic10", 60, False), (b"ic12", 48, False)):
        data = icf.icns([(code, pillow_save(
            picture(side, side, 16)["RGBA"], "PNG"))])
        if ok:
            assert port_array(data, tmp_path).shape == (side, side, 4)
            assert sha(port_array(data, tmp_path)) == sha(
                pillow_array(data, tmp_path))
        else:
            with pytest.raises(ValueError, match="allowed sizes"):
                pillow_array(data, tmp_path)
            with pytest.raises(ValueError, match="allowed sizes"):
                port_array(data, tmp_path)


def test_icns_written_by_pillow_at_1024(tmp_path):
    """Pillow's own ICNS writer (PNG entries 16-1024 from one RGB image)
    reads at its largest slot, 1024^2, scrambled, in both packages."""
    rgb = picture(64, 64, 17)["RGB"]
    data = pillow_save(rgb, "ICNS")
    want = pillow_array(data, tmp_path)
    assert want.shape == (1024, 1024, 3)
    assert sha(port_array(data, tmp_path)) == sha(want)


def test_icns_rle_band_ending_short(tmp_path):
    """A band whose packets stop short of W * H (the next band's bytes are
    taken for it, and the last band runs out) is refused by both."""
    rgb = picture(16, 16, 18)["RGB"]
    bands = [icf.icns_rle(rgb[..., c]) for c in range(3)]
    short = icf.icns_rle(rgb[:8, :, 0])
    data = icf.icns([(b"is32", short + bands[1] + bands[2])])
    with pytest.raises((SyntaxError, ValueError)):
        pillow_array(data, tmp_path)
    with pytest.raises(ValueError, match="ICNS RLE"):
        port_array(data, tmp_path)


def test_im_bit_decoder_leftover_bits(tmp_path):
    """Pillow's bit decoder starts each row on a byte boundary but ORs the
    bits the last row left into the new row's first byte."""
    W, H = 3, 2                               # 3 x 3 bits: 7 bits left
    body = bytes([0b00000000, 0b11111110, 0b00000001, 0b00000000])
    data = icf.im_header("L*3 image", W, H) + body
    got = port_array(data, tmp_path)
    np.testing.assert_array_equal(got, pillow_array(data, tmp_path))
    # the top row (stored second) gets 0b1111111 ORed into its first byte:
    # 0x7f gives 7, 7 and (with the second byte's low bit) 1
    np.testing.assert_array_equal(got[0], [7, 7, 1])


def test_dispatch_im_before_tiff(tmp_path):
    """IM has no _accept and comes before TIFF in Image.open's order: a
    file that starts as a TIFF but whose header lines IM takes is IM."""
    H, W = 4, 6
    grey = picture(H, W, 19)["L"]
    data = (b"II*\x00\x08\x00\x00\x00: x\r\n" + icf.im_header(
        "Greyscale image", W, H)[:-1] + b"\x1a" + icf.im_rows(grey))
    want = pillow_array(data, tmp_path)
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "IM"
    np.testing.assert_array_equal(want, grey)
    np.testing.assert_array_equal(port_array(data, tmp_path), grey)


def test_dispatch_names_pillow_order():
    """The refusals and new readers sit at their plugins' places in
    Image.OPEN: BUFR after BLP, EPS after DDS, GRIB and HDF5 before
    JPEG2000, ICNS before ICO, IM before MPEG and TIFF, MSP after TIFF,
    SPIDER before TGA, WMF and XBM after TGA and WEBP."""
    names = [n for n, _, _ in png.legacy_readers(b"")]
    pos = {n: i for i, n in enumerate(names)}
    assert pos["BLP"] < pos["BUFR"] < pos["CUR"]
    assert pos["DDS"] < pos["EPS"] < pos["FTEX"] < pos["GRIB"] < pos[
        "HDF5"] < pos["JPEG2000"] < pos["ICNS"] < pos["ICO"] < pos["IM"]
    assert pos["IM"] < pos["MPEG"] < pos["TIFF"] < pos["MSP"] < pos["PSD"]
    assert pos["SGI"] < pos["SPIDER"] < pos["TGA"] < pos["WEBP"] < pos[
        "WMF"] < pos["XBM"]


def test_writers_hold_to_pillow(tmp_path):
    """The writers' check: the IM writer's RGB;L and packed forms, the MSP
    version-2 writer and the SPIDER writer give back their pictures through
    Pillow; the X10 writer's shorts read as Pillow reads them (first two
    digits)."""
    p = picture()
    H, W = SIZE
    got = pillow_array(icf.im_header("RGB image", W, H)
                       + icf.im_lines(p["RGB"]), tmp_path)
    np.testing.assert_array_equal(got, p["RGB"])
    got = pillow_array(icf.im_header("B4 image", W, H)
                       + icf.im_packed(p["L"] >> 4, 4), tmp_path)
    np.testing.assert_array_equal(got, p["L"] >> 4)
    np.testing.assert_array_equal(pillow_array(icf.msp2(p["1"]), tmp_path),
                                  p["1"])
    f = p["I;16"].astype(np.float32) / 3
    for be in (False, True):
        np.testing.assert_array_equal(
            pillow_array(icf.spider(f, big_endian=be), tmp_path), f)
    np.testing.assert_array_equal(pillow_array(icf.spider(f, stack=2),
                                               tmp_path), f)
    np.testing.assert_array_equal(pillow_array(icf.xbm(p["1"]), tmp_path),
                                  p["1"])
    big = picture(128, 128, 20)["RGB"]
    np.testing.assert_array_equal(pillow_array(icf.icns(
        [(b"it32", b"\0\0\0\0" + icf.icns_rgb(big)),
         (b"t8mk", bytes(128 * 128))]), tmp_path)[..., :3], big)


# ------------------------------------------------------- capture and masks
def _slot(side: int) -> tuple:
    """(24-bit entry, its mask, the PNG/JPEG 2000 entry) types for a
    frame of side `side`: the 24-bit slot of that size, ic07 (128) for the
    PNG and JPEG 2000 entries (an entry's own size may divide its slot's)."""
    rgb = {16: b"is32", 32: b"il32", 48: b"ih32", 128: b"it32"}[side]
    return rgb, {b"is32": b"s8mk", b"il32": b"l8mk", b"ih32": b"h8mk",
                 b"it32": b"t8mk"}[rgb], b"ic07"


def encode_frame(rgb: np.ndarray, kind: str) -> tuple:
    """(extension, bytes) of a capture frame in `kind`."""
    H, W = rgb.shape[:2]
    rgba = np.concatenate([rgb, np.full((H, W, 1), 255, np.uint8)], -1)
    code, mask, png_code = _slot(W)
    lead = b"\0\0\0\0" if code == b"it32" else b""
    grey = rgb.mean(-1).astype(np.uint8)
    if kind == "icns_png_rgba":
        return "icns", icf.icns([(png_code, pillow_save(rgba, "PNG"))])
    if kind == "icns_png_rgb":
        return "icns", icf.icns([(png_code, pillow_save(rgb, "PNG"))])
    if kind == "icns_j2k":
        return "icns", icf.icns([(png_code, pillow_save(rgb, "JPEG2000"))])
    if kind in ("icns_rle_mask", "icns_raw_mask"):
        body = lead + icf.icns_rgb(rgb, rle=kind == "icns_rle_mask")
        return "icns", icf.icns([(code, body), (mask, grey.tobytes())],
                                toc=True)
    if kind == "im_rgb":
        return "im", icf.im_header("X 24 image", W, H) + icf.im_rows(
            rgb.reshape(H, -1))
    if kind == "im_rgb_l":
        return "im", pillow_save(rgb, "IM")
    if kind == "spider":
        return "spi", pillow_save(grey.astype(np.float32), "SPIDER")
    if kind == "icns_pillow":
        im = Image.fromarray(rgb)
        apps = [im.resize((s, s), Image.NEAREST)
                for s in (32, 64, 128, 256, 512, 1024) if s != W]
        return "icns", pillow_save(im, "ICNS", append_images=apps)
    raise KeyError(kind)


def encode_mask(mask: np.ndarray, kind: str) -> bytes:
    """A bool [H, W] mask as MSP version 1 (Pillow's), MSP version 2 (RLE)
    or XBM (Pillow's); each reads as "1", 0/1 in both packages."""
    if kind == "msp1":
        return pillow_save(mask, "MSP")
    if kind == "msp2":
        return icf.msp2(mask)
    return pillow_save(mask, "XBM")


def make_capture(root: str, side: int = CAPTURE_SIZE) -> None:
    """A 16-view COLMAP capture at side^2 whose i-th frame is in
    FRAME_KINDS[i % 9] (renamed in images.bin), its mask in MASK_KINDS[i %
    3] under the name the providers look for (mask/<stem>.png: both
    packages read a file by its content).  The Pillow-written ICNS reads at
    1024^2: its mask is MSP version 2 at 1024^2 (the providers join a frame
    and its mask before resizing both to the camera's size)."""
    import dataclasses
    from nerf2mesh_tpu_torch.data import colmap_utils as tcu
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    generate_colmap_dataset(root, H=side, W=side, n_images=16, n_points=400)
    sp = os.path.join(root, "sparse", "0", "images.bin")
    ims = tcu.read_images_binary(sp)
    os.makedirs(os.path.join(root, "mask"), exist_ok=True)
    for i, k in enumerate(sorted(ims)):
        im = ims[k]
        src = os.path.join(root, "images", im.name)
        with Image.open(src) as f:
            rgb = np.asarray(f.convert("RGB"))
        stem = os.path.splitext(im.name)[0]
        kind = FRAME_KINDS[i % len(FRAME_KINDS)]
        ext, data = encode_frame(rgb, kind)
        name = f"{stem}.{ext}"
        Path(root, "images", name).write_bytes(data)
        os.remove(src)
        ims[k] = dataclasses.replace(im, name=name)
        mask = rgb.astype(int).sum(-1) > 60
        if kind == "icns_pillow":
            big = np.repeat(np.repeat(mask, 1024 // side, 0), 1024 // side, 1)
            mdata = icf.msp2(big)
        else:
            mdata = encode_mask(mask, MASK_KINDS[i % len(MASK_KINDS)])
        Path(root, "mask", stem + ".png").write_bytes(mdata)
    tcu.write_images_binary(ims, sp)


def _loads_as_jax(capture: Path):
    from nerf2mesh_tpu.config import parse_args as jparse
    from nerf2mesh_tpu.data.colmap import load_colmap_dataset as jload
    from nerf2mesh_tpu_torch.config import parse_args as tparse
    from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset as tload
    argv = [str(capture), "--bound", "4", "--enable_cam_near_far"]
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
    assert alphas <= {0, 1}              # every mask is bilevel, read 0/1
    names = sorted(os.listdir(capture / "images"))
    assert {n.rsplit(".", 1)[1] for n in names} == {"icns", "im", "spi"}


def test_capture_loads_as_jax():
    """The committed capture fixtures/colmap_misc (frames in the nine forms
    chip_smoke's phase 14 (j) trains on: ICNS in each entry kind and
    Pillow's own, IM RGB and RGB;L, SPIDER; MSP and XBM masks): JAX's
    COLMAP provider (Pillow) and the port's (Pillow blocked) load equal
    images, masks, poses and intrinsics.  The masks are bilevel ("1"):
    both packages take their 0/1 as the alpha byte."""
    _loads_as_jax(CAPTURE)


def test_tiny_capture_loads_as_jax(tmp_path):
    """The same forms at 32^2 (il32/l8mk entries, PNG and JPEG 2000
    entries of 32^2 in the 128 slot), written here: both providers load
    equal arrays."""
    root = tmp_path / "c"
    make_capture(str(root), side=32)
    _loads_as_jax(root)


# ------------------------------------------------------- committed fixtures
def is_mine(rel: str) -> bool:
    return rel.startswith(("formats/icns/", "formats/im/", "formats/msp/",
                           "formats/spider/", "formats/xbm/",
                           "colmap_misc/"))


def committed() -> list:
    out = sorted(CASES)
    for d in ("images", "mask"):
        out += [str(p.relative_to(FIXTURES))
                for p in sorted((CAPTURE / d).iterdir())]
    return out


def write_fixtures() -> None:
    """Writes every case, the capture fixtures/colmap_misc/ and their
    entries in fixtures/formats.json; the other modules' entries stay."""
    import tempfile
    hashes = json.loads(FORMAT_HASHES.read_text())
    for k in [k for k in hashes if is_mine(k)]:
        del hashes[k]
    for d in ("icns", "im", "msp", "spider", "xbm"):
        shutil.rmtree(FIXTURES / "formats" / d, ignore_errors=True)
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
    assert len([f for f in files if f.startswith("colmap_misc/")]) == 32
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
    generate_colmap_dataset(str(root), H=CAPTURE_SIZE, W=CAPTURE_SIZE,
                            n_images=16, n_points=400)
    names = sorted(os.listdir(root / "images"))[:4]
    for i, n in enumerate(names):
        with Image.open(root / "images" / n) as f:
            rgb = np.asarray(f.convert("RGB"))
        stem = os.path.splitext(n)[0]
        ext, data = encode_frame(rgb, FRAME_KINDS[i])
        assert data == (CAPTURE / "images" / f"{stem}.{ext}").read_bytes(), n
        mask = rgb.astype(int).sum(-1) > 60
        assert encode_mask(mask, MASK_KINDS[i % len(MASK_KINDS)]) == (
            CAPTURE / "mask" / f"{stem}.png").read_bytes(), n


def test_reader_imports_no_pillow():
    """The readers decode committed files in a process where Pillow cannot
    be imported, and leave no PIL module loaded."""
    rels = ["formats/icns/rle_mask_it32.icns",
            "formats/icns/j2k_rgb_codestream.icns",
            "formats/icns/png_rgb_icp6_scrambled.icns",
            "formats/im/pillow_RGB.im", "formats/im/bits12_float.im",
            "formats/msp/v2_rle.msp", "formats/spider/big_endian.spi",
            "formats/xbm/x10_shorts_8_wide.xbm"]
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
