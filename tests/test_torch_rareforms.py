"""The last of Pillow's readers the port reads since ROADMAP A6 (j) 9's
second part, against Pillow 12.1.0 on the CPU: SUN rasters (depths 1, 4,
8, 24 and 32, colour maps, RGB and BGR types, RLE), XPM (one- and
two-character keys, "P" and "RGB", transparent keys), PIXAR, McIdas areas
("L", "I;16B", "I" and their strides), GIMP brushes (versions 1 and 2),
IM Tools, XV thumbnails, FITS (every BITPIX Pillow takes, as it misreads
them, and GZIP_1 tiles), FLI/FLC first frames (every chunk kind), Kodak
PhotoCD base images (every PhotoYCC value, the rotations) and IPTC/NAA
images (raw and JPEG payloads, the band merge), ICNS's palette JPEG 2000
entries, and the ValueError for a file no plugin takes.

The oracle is ``np.asarray(Image.open(p))``, the array the JAX package's
providers see: every case must give its dtype, shape and bytes exactly.
Pillow writes none of these formats; nerf2mesh_tpu_torch/tools/
rare_forms.py writes them.  What Pillow refuses, the port refuses with
ValueError, and the test shows Pillow refusing the same bytes.  The port's
side runs with Pillow blocked in sys.modules.  The committed files under
nerf2mesh_tpu_torch/fixtures/formats/{sun,xpm,pixar,mcidas,gbr,imt,
xvthumb,fits,fli,pcd,iptc} and the COLMAP capture fixtures/colmap_rare
(written by ``python tests/test_torch_rareforms.py``) hash to Pillow's
arrays in fixtures/formats.json.
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

from nerf2mesh_tpu_torch.data import imgdec, png
from nerf2mesh_tpu_torch.tools import icon_forms as icf
from nerf2mesh_tpu_torch.tools import rare_forms as rf

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "nerf2mesh_tpu_torch" / "fixtures"
FORMAT_HASHES = FIXTURES / "formats.json"
# the COLMAP capture chip_smoke.py's phase 14 (k) trains on
CAPTURE = FIXTURES / "colmap_rare"
CAPTURE_SIZE = 128
FRAME_KINDS = ["sun24", "sun24_rle", "sun32", "pixar", "gbr_rgba",
               "xpm_rgb", "iptc_band"]
MASK_KINDS = ["mcidas", "imt", "fits8", "xvthumb", "fli", "xpm_p"]
FORMATS = ("sun", "xpm", "pixar", "mcidas", "gbr", "imt", "xvthumb",
           "fits", "fli", "pcd", "iptc")
SIZE = (24, 34)                  # a variant's H, W


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
    """A picture with flat bands (runs across rows for the RLE writers),
    noise and a patch: RGB, RGBA, grey, bilevel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([(xx // 6) * 40 % 256, (yy // 3) * 23 % 256,
                    ((xx + yy) // 5) * 31 % 256], -1).astype(np.uint8)
    noisy = rgb[h // 2:h // 2 + 3]
    noisy[:] = rng.integers(0, 256, noisy.shape, dtype=np.uint8)
    rgb[2:5, 3:9] = (0x80, 0x80, 0x80)             # SUN RLE's escape byte
    grey = ((xx // 4 + yy // 2) * 13 % 256).astype(np.uint8)
    grey[-3:] = rng.integers(0, 256, (3, w), dtype=np.uint8)
    grey[0, :5] = 0x80
    alpha = ((xx * 7 + yy * 5) % 256).astype(np.uint8)
    return {"RGB": rgb, "RGBA": np.concatenate([rgb, alpha[..., None]], -1),
            "L": grey, "1": (xx // 3 + yy // 2) % 3 == 0}


def jpeg_bytes(a: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", quality=90, **kw)
    return b.getvalue()


def j2k_codestream(a: np.ndarray, mode: str | None = None) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a, mode).save(b, "JPEG2000", no_jp2=True)
    return b.getvalue()


# ----------------------------------------------------------------- cases
def sun_cases(p) -> dict:
    rng = np.random.default_rng(1)
    colour_map = rng.integers(0, 256, 3 * 256, dtype=np.uint8).tobytes()
    nib = p["L"] >> 4
    d = "formats/sun/"
    return {
        d + "d1_raw.ras": rf.sun(p["1"], 1),
        d + "d1_rle.ras": rf.sun(p["1"], 1, 2),
        d + "d4_grey.ras": rf.sun(nib, 4),
        d + "d4_map.ras": rf.sun(nib, 4, palette=colour_map[:48]),
        d + "d8_grey_old.ras": rf.sun(p["L"], 8, 0),
        d + "d8_map_rle.ras": rf.sun(p["L"], 8, 2, palette=colour_map),
        d + "d8_rle.ras": rf.sun(p["L"], 8, 2),
        d + "d24_bgr.ras": rf.sun(p["RGB"], 24),
        d + "d24_rgb_type3.ras": rf.sun(p["RGB"], 24, 3),
        d + "d24_rle.ras": rf.sun(p["RGB"], 24, 2),
        d + "d24_tiff_type4.ras": rf.sun(p["RGB"], 24, 4),
        d + "d32_bgrx.ras": rf.sun(p["RGB"], 32),
        d + "d32_rgbx_type3.ras": rf.sun(p["RGB"], 32, 3),
        d + "d32_rle.ras": rf.sun(p["RGB"], 32, 2),
        d + "d4_odd_width.ras": rf.sun(nib[:, :33], 4),
    }


def xpm_cases(p) -> dict:
    rng = np.random.default_rng(2)
    H, W = SIZE
    idx5 = (p["L"] // 52).astype(np.int64)
    cols5 = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    q = p["RGB"] // 32
    code = (q[..., 0].astype(np.int64) * 64 + q[..., 1] * 8 + q[..., 2])
    used, idx = np.unique(code, return_inverse=True)
    n = max(len(used), 300)
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    cols[:len(used)] = np.stack([used // 64, used // 8 % 8, used % 8],
                                -1) * 32
    idx = idx.reshape(H, W)
    short = rf.xpm(idx5, cols5, 1).replace(b"#%02x%02x%02x" % tuple(
        cols5[2]), b"#abc")
    d = "formats/xpm/"
    return {
        d + "p_cpp1.xpm": rf.xpm(idx5, cols5, 1),
        d + "p_cpp2_none_unused.xpm": rf.xpm(idx5, np.concatenate(
            [cols5, cols5[:1]]), 2, none=5),
        d + "p_no_pixels_comment.xpm": rf.xpm(idx5, cols5, 1,
                                              pixels_comment=False,
                                              comments=False),
        d + "p_short_hex.xpm": short,
        d + "p_duplicate_key.xpm": rf.xpm(idx5, np.concatenate(
            [cols5, cols5[:1] // 2]), 1).replace(b'"d c #', b'"a c #', 1),
        d + "rgb_cpp2_over_256.xpm": rf.xpm(idx, cols, 2),
        d + "rgb_cpp3.xpm": rf.xpm(idx, cols, 3, pixels_comment=False),
    }


def pixar_cases(p) -> dict:
    return {"formats/pixar/rgb.pxr": rf.pixar(p["RGB"])}


def mcidas_cases(p) -> dict:
    rng = np.random.default_rng(3)
    H, W = SIZE
    d = "formats/mcidas/"
    return {
        d + "l.area": rf.mcidas(p["L"], 1),
        d + "i16b.area": rf.mcidas(rng.integers(0, 65536, (H, W)), 2),
        d + "i32b.area": rf.mcidas(rng.integers(-2 ** 31, 2 ** 31, (H, W)),
                                   4),
        d + "l_prefix_two_bands.area": rf.mcidas(p["L"], 1, prefix=3,
                                                 bands=2),
        d + "i16b_offset_gap.area": rf.mcidas(
            rng.integers(0, 65536, (H, W)), 2, prefix=2, offset=300),
    }


def gbr_cases(p) -> dict:
    d = "formats/gbr/"
    return {
        d + "v1_l.gbr": rf.gbr(p["L"], 1),
        d + "v2_l.gbr": rf.gbr(p["L"], 2, b"a longer brush comment"),
        d + "v2_rgba.gbr": rf.gbr(p["RGBA"], 2),
    }


def imt_cases(p) -> dict:
    d = "formats/imt/"
    return {d + "grey.imt": rf.imt(p["L"]),
            d + "grey_no_comment.imt": rf.imt(p["L"], comments=False)}


def xvthumb_cases(p) -> dict:
    d = "formats/xvthumb/"
    return {d + "thumb.xv": rf.xv_thumb(p["L"]),
            d + "thumb_no_comments.xv": rf.xv_thumb(p["L"][::-1], ())}


def fits_cases(p) -> dict:
    rng = np.random.default_rng(4)
    H, W = SIZE
    d = "formats/fits/"
    i16 = rng.integers(-32768, 32768, (H, W))
    ext = (rf.fits_header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
                           ("EXTEND", True)])
           + rf.fits_header([("XTENSION", "IMAGE"), ("BITPIX", 16),
                             ("NAXIS", 2), ("NAXIS1", W), ("NAXIS2", H),
                             ("PCOUNT", 0), ("GCOUNT", 1)])
           + i16.astype(">i2").tobytes())
    return {
        d + "bitpix8.fits": rf.fits(p["L"], 8),
        d + "bitpix16_as_le.fits": rf.fits(i16, 16),
        d + "bitpix32_native.fits": rf.fits(
            rng.integers(-2 ** 31, 2 ** 31, (H, W)), 32),
        d + "bitpix-32_native.fits": rf.fits(
            rng.standard_normal((H, W)) * 100, -32),
        d + "bitpix-64_first_half.fits": rf.fits(
            rng.standard_normal((H, W)) * 100, -64),
        d + "naxis1.fits": rf.fits_header([
            ("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 1),
            ("NAXIS1", W)]) + p["L"][0].tobytes(),
        d + "comments_and_cards.fits": rf.fits(p["L"], 8, [
            ("BSCALE", 1), b"COMMENT  a card with no value".ljust(80),
            ("OBJECT", "SPHERES")]),
        d + "extension_image.fits": ext,
        d + "gzip_bitpix8.fits": rf.fits_gzip(p["L"], 8, pad=True),
        d + "gzip_bitpix16.fits": rf.fits_gzip(
            rng.integers(0, 2 ** 20, (H, W)), 16),
        d + "gzip_bitpix32.fits": rf.fits_gzip(
            rng.integers(-2 ** 31, 2 ** 31, (H, W)), 32, pad=True),
    }


def fli_cases(p) -> dict:
    rng = np.random.default_rng(5)
    H, W = SIZE
    a = p["L"]
    b = a.copy()
    b[3:9, 4:20] = 200
    b[12, ::3] = 7
    b[-1, -1] = 99
    pal = rng.integers(0, 64, (256, 3), dtype=np.uint8)
    zero = np.zeros_like(a)
    d = "formats/fli/"
    return {
        d + "brun.flc": rf.fli(W, H, [rf.fli_colour(pal * 4), rf.fli_brun(a)]),
        d + "brun_lc_fli.fli": rf.fli(W, H, [rf.fli_colour(pal, 11),
                                            rf.fli_brun(a), rf.fli_lc(b, a)],
                                      magic=0xAF11),
        d + "ss2_odd_width.flc": rf.fli(W - 1, H, [rf.fli_ss2(
            b[:, :W - 1], zero[:, :W - 1])]),
        d + "brun_ss2.flc": rf.fli(W, H, [rf.fli_brun(a),
                                          rf.fli_ss2(b, a)]),
        d + "copy.flc": rf.fli(W, H, [rf.fli_chunk(16, a.tobytes())]),
        d + "copy_black_lc.flc": rf.fli(W, H, [
            rf.fli_chunk(16, a.tobytes()), rf.fli_chunk(13, b""),
            rf.fli_lc(b, zero, runs=False)]),
        d + "stamp_then_brun.flc": rf.fli(W, H, [
            rf.fli_chunk(18, bytes(30)), rf.fli_brun(a)],
            frames=3, tail=rf.fli_frame([rf.fli_chunk(13, b"")])),
    }


def pcd_cases(p) -> dict:
    """Smooth planes (the committed files stay compressible in git)."""
    yy, xx = np.mgrid[0:rf.PCD_H, 0:rf.PCD_W]
    y = ((xx // 3 + yy // 2) % 256).astype(np.uint8)
    cy, cx = np.mgrid[0:rf.PCD_H // 2, 0:rf.PCD_W // 2]
    c1 = (100 + (cx // 6) % 110).astype(np.uint8)
    c2 = (90 + (cy // 4) % 100).astype(np.uint8)
    planes = rf.pcd_planes(y, c1, c2)
    d = "formats/pcd/"
    return {d + "base_landscape.pcd": rf.pcd(planes, 0),
            d + "base_rotated_270.pcd": rf.pcd(planes, 3)}


def iptc_cases(p) -> dict:
    H, W = SIZE
    g = p["L"]
    d = "formats/iptc/"
    jpeg_grey = jpeg_bytes(g)
    return {
        d + "raw_l.iim": rf.iptc(W, H, 1, 0, g.tobytes()),
        d + "raw_l_records_of_100.iim": rf.iptc(W, H, 1, 0, g.tobytes(),
                                                chunk=100),
        d + "raw_rgb_band2.iim": rf.iptc(W, H, 3, 1, g.tobytes(), band=2),
        d + "raw_rgb_default_band.iim": rf.iptc(W, H, 3, 1, g.tobytes()),
        d + "raw_cmyk_band4.iim": rf.iptc(W, H, 4, 1, g.tobytes(), band=4),
        d + "raw_cmyk_band0_last.iim": rf.iptc(W, H, 4, 1, g.tobytes(),
                                               band=0),
        d + "jpeg_l.iim": rf.iptc(W, H, 1, 0, jpeg_grey, compression=5),
        d + "jpeg_rgb_band3.iim": rf.iptc(W, H, 3, 1, jpeg_grey,
                                          compression=5, band=3),
        d + "jpeg_l_rgb_payload.iim": rf.iptc(W, H, 1, 0, jpeg_bytes(
            p["RGB"]), compression=5),
        d + "raw_l_zero_trailer.iim": rf.iptc(W, H, 1, 0, g.tobytes(),
                                              trailer=bytes(9)),
    }


def all_cases() -> dict:
    p = picture()
    out = {}
    for f in (sun_cases, xpm_cases, pixar_cases, mcidas_cases, gbr_cases,
              imt_cases, xvthumb_cases, fits_cases, fli_cases, pcd_cases,
              iptc_cases):
        out.update(f(p))
    return out


def icns_palette_cases() -> dict:
    """ICNS entries that are JP2 files with a pclr palette (modes "P" and
    "PA"), duplicate entries among them, of 1-5 components a colour."""
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 12, (16, 16)).astype(np.uint8)
    alpha = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    out = {}
    for npc in (1, 2, 3, 4, 5):
        ent = rng.integers(0, 3, (10, npc), dtype=np.uint8) * 100
        ent[3] = ent[1]                               # a duplicate colour
        if npc == 4:
            ent[:5, 3] = 255
        for pa in (False, True):
            cs = j2k_codestream(np.dstack([idx, alpha]), "LA") if pa else \
                j2k_codestream(idx)
            name = f"icns_pclr_{npc}_{'pa' if pa else 'p'}"
            out[name] = icf.icns([(b"icp4", rf.jp2_palette(cs, 16, 16, ent,
                                                          alpha=pa))])
    return out


def extra_cases(p) -> dict:
    """Held to Pillow at test time only: random-byte PhotoCD base images at
    each orientation (every luma and chroma value), random SUN RLE
    streams, ICNS palette entries, a 64^2 picture in the raw formats."""
    rng = np.random.default_rng(7)
    out = {}
    for o in (0, 1, 2, 3, 5, 255):
        out[f"pcd_random_orientation_{o}"] = rf.pcd(rng.integers(
            0, 256, rf.PCD_W * rf.PCD_H * 3 // 2, dtype=np.uint8).tobytes(),
            o)
    for i in range(6):
        W, H, depth = 5 + i, 3 + i % 3, (1, 4, 8, 24, 32, 8)[i]
        stream = rng.integers(0, 256, 200, dtype=np.uint8)
        stream[::3] = 0x80
        stream[1::9] = 0
        out[f"sun_rle_random_{i}"] = struct.pack(
            ">8I", rf.SUN_MAGIC, W, H, depth, 0, 2, 0, 0) + bytes(stream)
    out.update(icns_palette_cases())
    big = picture(64, 64, 8)
    out["sun_d24_rle_64"] = rf.sun(big["RGB"], 24, 2)
    out["gbr_v2_rgba_64"] = rf.gbr(big["RGBA"])
    out["fli_brun_64"] = rf.fli(64, 64, [rf.fli_brun(big["L"])])
    out["xpm_rgb_64"] = rf.xpm(
        np.arange(64 * 64).reshape(64, 64) % 600,
        rng.integers(0, 256, (600, 3), dtype=np.uint8), 2)
    return out


CASES = all_cases()
EXTRA = extra_cases(picture())


def refused_cases() -> dict:
    """{name: bytes} that Pillow identifies but fails to load (or refuses
    in _open with an error Image.open passes on); the port raises
    ValueError."""
    p = picture()
    H, W = SIZE
    g = p["L"]
    rgb24 = rf.sun(p["RGB"], 24)
    rle = rf.sun(p["L"], 8, 2)
    mc = bytearray(rf.mcidas(g, 1))
    struct.pack_into(">i", mc, 33 * 4, -300)           # word 34: offset
    fits16 = rf.fits(g, 16)
    no_image = rf.fits_header([("SIMPLE", True), ("BITPIX", 8),
                               ("NAXIS", 0)]) + bytes(80)
    return {
        "sun_raw_truncated": rgb24[:-5],
        "sun_rle_truncated": rle[:len(rle) // 2],
        "sun_rle_escape_at_end": rle[:40] + b"\x80",
        "sun_map_on_24_bit": rf.sun(p["RGB"], 24, palette=bytes(12)),
        "sun_map_on_1_bit": rf.sun(p["1"], 1, palette=bytes(6)),
        "pixar_truncated": rf.pixar(p["RGB"])[:-1],
        "mcidas_truncated": rf.mcidas(g, 1)[:-3],
        "mcidas_negative_offset": bytes(mc),
        "mcidas_i32_truncated": rf.mcidas(g, 4)[:-1],
        "gbr_pixels_short": rf.gbr(p["RGBA"])[:-2],
        "gbr_v2_header_of_24": struct.pack(">5I", 24, 2, 4, 4, 1) +
        b"GIMP" + struct.pack(">I", 1) + bytes(16),
        "imt_no_form_feed": b"width 4\nheight 2\npixel n8\n",
        "imt_width_not_a_number": b"width x4\nheight 2\npixel n8\n\x0c" +
        bytes(8),
        "imt_truncated": rf.imt(g)[:-1],
        "xv_one_field": b"P7 332\n#c\n12\n" + bytes(40),
        "xv_size_not_a_number": b"P7 332\n4 x 255\n" + bytes(40),
        "xv_truncated": rf.xv_thumb(g)[:-1],
        "fits_data_truncated": fits16[:2880 + 10],
        "fits_no_image": no_image,
        "fits_header_truncated": fits16[:160],
        "fits_gzip_float": rf.fits_gzip(np.zeros((4, 4), np.int64), -32),
        "fits_gzip_not_gzip": rf.fits_gzip(g, 8)[:-200] + b"x" * 200,
        "fits_gzip_short": rf.fits_gzip(g[:3], 8).replace(
            rf.fits_card("ZNAXIS2", 3), rf.fits_card("ZNAXIS2", 9)),
        "fits_naxis_not_a_number": rf.fits(g, 8).replace(
            rf.fits_card("NAXIS1", W), rf.fits_card("NAXIS1", "x")),
        "xpm_colour_not_hex": rf.xpm(g // 52, np.zeros((5, 3), np.uint8),
                                     1).replace(b"c #000000", b"c red", 1),
        "xpm_key_not_a_colour": rf.xpm(g // 52, np.zeros((5, 3), np.uint8),
                                       1).replace(b'pixels */\n"',
                                                  b'pixels */\n"Q', 1),
        "xpm_transparent_key_used": rf.xpm(g // 52, np.zeros(
            (5, 3), np.uint8), 1, none=0),
        "xpm_pixels_cut": rf.xpm(g // 52, np.zeros((5, 3), np.uint8),
                                 1)[:-200],
        "xpm_colour_line_without_c": rf.xpm(
            g // 52, np.zeros((5, 3), np.uint8), 1).replace(
            b" c #", b" m #", 1),
        "xpm_size_not_a_number": b'/* XPM */\n"4  5 1",\n',
        "fli_frame_truncated": rf.fli(W, H, [rf.fli_brun(g)])[:-10],
        "fli_prefix_chunk": rf.fli(W, H, [rf.fli_brun(g)], prefix=bytes(4)),
        "fli_unknown_chunk": rf.fli(W, H, [rf.fli_chunk(99, bytes(4))]),
        "fli_brun_short_line": rf.fli(W, H, [rf.fli_chunk(
            15, b"\x01\x02\x07" * H)]),
        "fli_lc_past_data": rf.fli(W, H, [rf.fli_chunk(
            12, struct.pack("<HH", 0, 3) + b"\x01\x00\x05ab")]),
        "fli_chunk_size_0": rf.fli(W, H, [struct.pack("<IH", 0, 13) +
                                          bytes(4)]),
        "pcd_truncated": rf.pcd(bytes(rf.PCD_W * rf.PCD_H * 3 // 2 - 1)),
        "iptc_compression_2": rf.iptc(W, H, 1, 0, g.tobytes(),
                                      compression=2),
        "iptc_no_compression": rf.iptc(W, H, 1, 0, g.tobytes()).replace(
            rf.iptc_record(3, 120, b"\x01"), b""),
        "iptc_size_byte_140": rf.iptc_record(2, 5, b"x") +
        b"\x1c\x02\x06\x8c" + bytes(20),
        "iptc_band_5_of_cmyk": rf.iptc(W, H, 4, 1, g.tobytes(), band=5),
        "iptc_rgb_payload_in_band_1": rf.iptc(
            W, H, 3, 1, jpeg_bytes(p["RGB"]), compression=5, band=1),
        "iptc_rgb_payload_in_band_2": rf.iptc(
            W, H, 3, 1, jpeg_bytes(p["RGB"]), compression=5, band=2),
        "iptc_no_image_record": rf.iptc(W, H, 1, 0, b"")[:-5],
        "iptc_junk_after_image": rf.iptc(W, H, 1, 0, g.tobytes(),
                                         trailer=b"junk!"),
        "iptc_raw_short": rf.iptc(W, H, 1, 0, g.tobytes()[:-4]),
        "iptc_payload_unidentified": rf.iptc(W, H, 1, 0, b"\1\2\3" * 50,
                                             compression=5),
    }


REFUSED = refused_cases()
# refusals where Pillow's load hands over an unidentified payload
UNIDENTIFIED = {"iptc_payload_unidentified"}


def not_read_cases() -> dict:
    """{name: bytes} whose plugin's _accept takes them (or that reach a
    plugin without one) but whose _open hands them on, and that no later
    plugin reads (Pillow: UnidentifiedImageError, the port: ValueError)."""
    g = picture()["L"]
    H, W = SIZE
    sun = bytearray(rf.sun(g, 8))
    fli = bytearray(rf.fli(W, H, [rf.fli_brun(g)]))

    def poke(b: bytearray, fmt: str, off: int, v) -> bytes:
        c = bytearray(b)
        struct.pack_into(fmt, c, off, v)
        return bytes(c)

    mc = rf.mcidas(g, 1)
    gbr = rf.gbr(g, 2)
    pal_walk = rf.fli(W, H, [rf.fli_chunk(4, struct.pack("<HBB", 2, 0, 0)
                                          + bytes(768) + b"\x01\x01" +
                                          bytes(3))])
    return {
        "sun_depth_2": poke(sun, ">I", 12, 2),
        "sun_map_type_2": bytes(sun[:24]) + struct.pack(">II", 2, 6) +
        bytes(6) + bytes(sun[32:]),
        "sun_map_over_1024": rf.sun(g, 8, palette=bytes(1026)),
        "sun_type_6": poke(sun, ">I", 20, 6),
        "sun_width_0": poke(sun, ">I", 4, 0),
        "sun_header_cut": bytes(sun[:20]),
        "pixar_other_mode": rf.pixar(picture()["RGB"], (14, 3)),
        "pixar_header_cut": rf.pixar(picture()["RGB"])[:300],
        "mcidas_bytes_3": poke(bytearray(mc), ">i", 40, 3),
        "mcidas_no_lines": poke(bytearray(mc), ">i", 32, 0),
        "mcidas_directory_cut": mc[:200],
        "gbr_depth_3": poke(bytearray(gbr), ">I", 16, 3),
        "gbr_no_magic": gbr[:20] + b"GIMQ" + gbr[24:],
        "gbr_width_0": poke(bytearray(gbr), ">I", 8, 0),
        "xpm_no_size_line": b"/* XPM */\nstatic char *x[] = {\n};\n",
        "xpm_colour_line_cut_after_c": b'/* XPM */\n"2 1 1 1",\n". c",\n'
        b'"..",\n',
        "imt_no_pixel_line": b"width 4\nheight 2\n\x0c" + bytes(8),
        "imt_no_newline": b"width 4 height 2 pixel n8" + bytes(90),
        "xv_eof_in_comments": b"P7 332\n#a\n#b\n",
        "xv_width_0": b"P7 332\n0 5 255\n" + bytes(10),
        "fits_not_simple_t": rf.fits(g, 8).replace(
            rf.fits_card("SIMPLE", True), rf.fits_card("SIMPLE", False)),
        "fits_bitpix_64": rf.fits(g, 8).replace(rf.fits_card("BITPIX", 8),
                                                rf.fits_card("BITPIX", 64)),
        "fits_no_naxis": rf.fits(g, 8).replace(rf.fits_card("NAXIS", 2),
                                               rf.fits_card("NAXES", 2)),
        "fli_frames_0": poke(fli, "<H", 6, 0),
        "fli_header_not_zero": poke(fli, "<H", 20, 1),
        "fli_size_0": poke(fli, "<H", 8, 0),
        "fli_palette_past_255": pal_walk,
        "fli_header_only": bytes(fli[:128]),
        "iptc_no_layers_record": rf.iptc(W, H, 1, 0, g.tobytes()).replace(
            rf.iptc_record(3, 60, b"\x01\x00"), b""),
        "iptc_layers_2": rf.iptc(W, H, 2, 1, g.tobytes()),
        "iptc_bad_record_number": b"\x1c\x0a\x05\x00\x01x" + bytes(10),
        "pcd_other_magic": bytes(2048) + b"PCX_IPI" + bytes(3000),
        "random_bytes": np.random.default_rng(9).integers(
            0, 256, 600, dtype=np.uint8).tobytes(),
    }


NOT_READ = not_read_cases()


def dispatch_cases() -> dict:
    """{name: bytes} that FLI's or GBR's _accept takes, whose _open hands
    them on, and that TGA (later in Image.OPEN) reads."""
    rgb = picture(3, 5)["RGB"]
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "TGA")
    tga = bytearray(b.getvalue())
    fli_like = bytearray(tga)
    fli_like[4:6] = b"\x12\xaf"                   # FLC magic, height 3
    gbr_like = bytearray(tga)
    gbr_like[7] = 2                               # GBR version 2
    return {"tga_with_fli_prefix": bytes(fli_like),
            "tga_with_gbr_prefix": bytes(gbr_like)}


DISPATCH = dispatch_cases()


# ------------------------------------------------------------------ tests
def test_case_sizes():
    """Each committed variant is at most 64^2 but PhotoCD's fixed 768 x
    512, and the committed set stays small."""
    for rel, data in CASES.items():
        h, w = np.asarray(Image.open(io.BytesIO(data))).shape[:2]
        assert h * w <= 64 * 64 or rel.startswith("formats/pcd/"), rel
    assert sum(len(d) for k, d in CASES.items()
               if not k.startswith("formats/pcd/")) < 300_000


@pytest.mark.parametrize("rel", sorted(CASES) + sorted(EXTRA))
def test_reads_as_pillow(rel, tmp_path):
    data = CASES.get(rel) or EXTRA[rel]
    name = rel.rsplit("/", 1)[-1]
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
def test_nothing_reads_as_pillow(name, tmp_path):
    """A file every plugin passes over: UnidentifiedImageError in Pillow,
    ValueError (cannot identify) in the port."""
    from PIL import UnidentifiedImageError
    with pytest.raises(UnidentifiedImageError):
        pillow_array(NOT_READ[name], tmp_path, name)
    with pytest.raises(ValueError, match="no reader takes this file"):
        port_array(NOT_READ[name], tmp_path, name)


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_prefix_passed_over_to_tga(name, tmp_path):
    """FLI's or GBR's _accept takes the prefix, its _open gives up, and
    Image.open reads the file as TGA; so does the port."""
    data = DISPATCH[name]
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "TGA"
    assert sha(port_array(data, tmp_path)) == sha(pillow_array(data,
                                                               tmp_path))


def test_writers_hold_to_pillow(tmp_path):
    """The writers give back their pictures through Pillow: SUN at every
    depth and type (RLE rows unpadded), XPM, PIXAR, McIdas, GBR, IMT, the
    XV thumbnail, FITS (bottom-up rows, BITPIX 8), FLI's BRUN, LC and SS2
    against the frame before, and PhotoCD's planes in their places."""
    p = picture()
    for depth, a, want in ((1, p["1"], p["1"]), (4, p["L"] >> 4,
                                                 (p["L"] >> 4) * 17),
                           (8, p["L"], p["L"]), (24, p["RGB"], p["RGB"]),
                           (32, p["RGB"], p["RGB"])):
        for ftype in (1, 2, 3):
            np.testing.assert_array_equal(pillow_array(
                rf.sun(a, depth, ftype), tmp_path), want)
    idx = (p["L"] // 52).astype(np.int64)
    cols = np.arange(15, dtype=np.uint8).reshape(5, 3) * 17
    np.testing.assert_array_equal(pillow_array(rf.xpm(idx, cols, 2),
                                               tmp_path), idx)
    np.testing.assert_array_equal(pillow_array(rf.xpm(
        idx, np.resize(cols, (300, 3)), 2), tmp_path), cols[idx])
    np.testing.assert_array_equal(pillow_array(rf.pixar(p["RGB"]),
                                               tmp_path), p["RGB"])
    np.testing.assert_array_equal(pillow_array(rf.mcidas(
        p["L"], 1, prefix=2, bands=3), tmp_path), p["L"])
    np.testing.assert_array_equal(pillow_array(rf.gbr(p["RGBA"], 1),
                                               tmp_path), p["RGBA"])
    np.testing.assert_array_equal(pillow_array(rf.imt(p["L"]), tmp_path),
                                  p["L"])
    np.testing.assert_array_equal(pillow_array(rf.xv_thumb(p["L"]),
                                               tmp_path), p["L"])
    np.testing.assert_array_equal(pillow_array(rf.fits(p["L"], 8),
                                               tmp_path), p["L"][::-1])
    np.testing.assert_array_equal(pillow_array(rf.fits_gzip(p["L"], 8),
                                               tmp_path), p["L"][::-1])
    H, W = SIZE
    a, b = p["L"], p["L"][::-1].copy()
    zero = np.zeros_like(a)
    for chunks, want in (([rf.fli_brun(a)], a),
                         ([rf.fli_brun(a), rf.fli_lc(b, a)], b),
                         ([rf.fli_brun(a), rf.fli_ss2(b, a)], b),
                         ([rf.fli_ss2(b[:, 1:], zero[:, 1:])], b[:, 1:])):
        np.testing.assert_array_equal(pillow_array(rf.fli(
            want.shape[1], H, chunks), tmp_path), want)
    y = np.zeros((rf.PCD_H, rf.PCD_W), np.uint8)
    y[:, ::2] = 255                       # luma alone: R = G = B clipped
    flat = np.full((rf.PCD_H // 2, rf.PCD_W // 2), 156, np.uint8)
    got = pillow_array(rf.pcd(rf.pcd_planes(y, flat, flat + 137 - 156)),
                       tmp_path)
    np.testing.assert_array_equal(got[..., 0], y)


def test_fits_reads_as_pillow_misreads():
    """Pillow's FITS reading against the standard, which the port follows
    (ROADMAP C's known defects of the reference): rows bottom-up, a
    BITPIX 16 value 1 read as 256, BITPIX 32 and -32 byte-swapped, -64 as
    float32 over the first half of the doubles."""
    from nerf2mesh_tpu_torch.data import fits
    a = np.array([[1, 2, 3], [4, 5, 6]])
    with no_pillow():
        np.testing.assert_array_equal(fits.decode_fits(rf.fits(a, 16)),
                                      (a * 256)[::-1])
        got32 = fits.decode_fits(rf.fits(a, 32))
        np.testing.assert_array_equal(got32, a[::-1].astype(">i4").view(
            "<i4"))
        gotf = fits.decode_fits(rf.fits(a.astype(float), -32))
        assert gotf.tobytes() == a[::-1].astype(">f4").tobytes()
        got64 = fits.decode_fits(rf.fits(a.astype(float), -64))
        body = a.astype(">f8").tobytes()[:6 * 4]
        np.testing.assert_array_equal(got64, np.frombuffer(
            body, "<f4").reshape(2, 3)[::-1])


def test_pcd_every_photoycc_value(tmp_path):
    """Every (luma, C1, C2) triple through Pillow's pcd decoder and YCC;P
    unpacker, 43 base images of 2 x 2 blocks: four lumas share a block's
    chroma, so the port's chroma upsampling and its five tables meet
    Pillow's on all 2^24 values."""
    from nerf2mesh_tpu_torch.data import pcd
    per = rf.PCD_W * rf.PCD_H
    for start in range(0, 1 << 24, per):
        v = np.arange(start, start + per) % (1 << 24)
        blk = v.reshape(rf.PCD_H // 2, rf.PCD_W // 2, 4)
        y = np.empty((rf.PCD_H, rf.PCD_W), np.uint8)
        for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            y[dy::2, dx::2] = blk[..., k] & 255
        c1 = (blk[..., 0] >> 16).astype(np.uint8)
        c2 = (blk[..., 0] >> 8 & 255).astype(np.uint8)
        data = rf.pcd(rf.pcd_planes(y, c1, c2))
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im)
        np.testing.assert_array_equal(pcd.decode_pcd(data), want)


# ------------------------------------------------ native decoders vs numpy
def sun_rle_model(src: bytes, total: int):
    """SunRleDecode.c in Python: the flat bytes, or None when the data
    ends first."""
    out, pos = bytearray(), 0
    while len(out) < total:
        if pos >= len(src):
            return None
        if src[pos] != 0x80:
            out.append(src[pos])
            pos += 1
        elif pos + 1 >= len(src):
            return None
        elif src[pos + 1] == 0:
            out.append(0x80)
            pos += 2
        elif pos + 2 >= len(src):
            return None
        else:
            out += bytes([src[pos + 2]]) * min(src[pos + 1] + 1,
                                               total - len(out))
            pos += 3
    return bytes(out)


def test_sun_rle_against_model_and_pillow(tmp_path):
    """imgdec.sun_rle against the model on adversarial streams (runs
    across rows and past the image, escapes, data ending inside a packet)
    and against Pillow's decoder on the same files."""
    rng = np.random.default_rng(10)
    for trial in range(300):
        W, H = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        stream = bytearray(rng.integers(0, 256, int(rng.integers(0, 40)),
                                        dtype=np.uint8))
        for i in range(len(stream)):
            if rng.random() < 0.3:
                stream[i] = 0x80
            elif rng.random() < 0.2:
                stream[i] = int(rng.integers(0, 4))
        stream = bytes(stream)
        want = sun_rle_model(stream, W * H)
        if want is None:
            with pytest.raises(ValueError, match="truncated"):
                imgdec.sun_rle(stream, W, H)
        else:
            assert imgdec.sun_rle(stream, W, H).tobytes() == want
        if trial % 10 == 0:
            data = struct.pack(">8I", rf.SUN_MAGIC, W, H, 8, 0, 2, 0,
                               0) + stream
            if want is None:
                with pytest.raises(Exception):
                    pillow_array(data, tmp_path)
            else:
                np.testing.assert_array_equal(pillow_array(
                    data, tmp_path), np.frombuffer(want, np.uint8).reshape(
                    H, W))


def fli_model(frame: bytes, W: int, H: int, out: np.ndarray):
    """FliDecode.c in Python on one frame: 'done', ('more', consumed) or
    'error'."""
    def i16(o):
        return frame[o] | frame[o + 1] << 8

    def i32(o):
        return struct.unpack_from("<i", frame, o)[0]

    n = len(frame)
    if n < 4:
        return ("more", 0)
    if n + n % 2 < i32(0):
        return ("more", 0)
    if n < 8 or i16(4) != 0xF1FA:
        return "error"
    ptr, left = 16, n - 16
    for _ in range(i16(6)):
        if left < 10:
            return "error"
        d, lim, kind = ptr + 6, ptr + left, i16(ptr + 4)
        if kind == 13:
            out[:] = 0
        elif kind == 16:
            if d + W * H > lim:
                return ("more", ptr)
            out[:] = np.frombuffer(frame, np.uint8, W * H, d).reshape(H, W)
        elif kind == 15:
            for y in range(H):
                d += 1
                x = 0
                while x < W:
                    if d + 2 > lim:
                        return "error"
                    c = frame[d]
                    if c & 0x80:
                        i = 256 - c
                        if x + i > W:
                            break
                        if d + i + 1 > lim:
                            return "error"
                        out[y, x:x + i] = list(frame[d + 1:d + 1 + i])
                        d += i + 1
                    else:
                        i = c
                        if x + i > W:
                            break
                        out[y, x:x + i] = frame[d + 1]
                        d += 2
                    x += i
                if x != W:
                    return "error"
        elif kind == 12:
            y, ymax = i16(d), i16(d) + i16(d + 2)
            d += 4
            while y < ymax and y < H:
                if d + 1 > lim:
                    return "error"
                packets, d, x, p = frame[d], d + 1, 0, 0
                while p < packets:
                    if d + 2 > lim:
                        return "error"
                    x += frame[d]
                    c = frame[d + 1]
                    if c & 0x80:
                        i = 256 - c
                        if x + i > W:
                            break
                        if d + 3 > lim:
                            return "error"
                        out[y, x:x + i] = frame[d + 2]
                        d += 3
                    else:
                        i = c
                        if x + i > W:
                            break
                        if d + 2 + i > lim:
                            return "error"
                        out[y, x:x + i] = list(frame[d + 2:d + 2 + i])
                        d += 2 + i
                    x += i
                    p += 1
                if p < packets:
                    break
                y += 1
            if y < ymax:
                return "error"
        elif kind == 7:
            lines, d = i16(d), d + 2
            y = l = 0
            while l < lines and y < H:
                if d + 2 > lim:
                    return "error"
                packets, d = i16(d), d + 2
                row = y
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= H:
                            return "error"
                        row = y
                    else:
                        out[row, W - 1] = packets & 255
                    if d + 2 > lim:
                        return "error"
                    packets, d = i16(d), d + 2
                x = p = 0
                while p < packets:
                    if d + 2 > lim:
                        return "error"
                    x += frame[d]
                    c = frame[d + 1]
                    if c >= 128:
                        if d + 4 > lim:
                            return "error"
                        i = 256 - c
                        if x + 2 * i > W:
                            break
                        out[row, x:x + 2 * i] = list(frame[d + 2:d + 4]) * i
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * c
                        if x + i > W:
                            break
                        if d + 2 + i > lim:
                            return "error"
                        out[row, x:x + i] = list(frame[d + 2:d + 2 + i])
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                l += 1
                y += 1
            if l < lines:
                return "error"
        elif kind not in (4, 11, 18):
            return "error"
        adv = i32(ptr)
        if adv == 0 or adv < 0 or adv > left:
            return "error"
        ptr, left = ptr + adv, left - adv
    return "done"


def test_fli_frame_against_model(tmp_path):
    """imgdec.fli_frame against the model on adversarial frames (runs and
    literals past a line, counts past the frame, skips past the last line,
    chunks that end early, wrong chunk sizes) built from valid chunks with
    bytes changed; every tenth also against Pillow's decoder."""
    rng = np.random.default_rng(11)
    for trial in range(300):
        W, H = int(rng.integers(1, 12)), int(rng.integers(1, 7))
        a = (rng.integers(0, 4, (H, W)) * 60).astype(np.uint8)
        b = a.copy()
        b[rng.random((H, W)) < 0.4] = 9
        kind = trial % 5
        chunk = bytearray((rf.fli_brun(a), rf.fli_lc(b, a),
                           rf.fli_ss2(b, a), rf.fli_chunk(16, a.tobytes()),
                           rf.fli_lc(b, a, runs=False))[kind])
        for _ in range(int(rng.integers(0, 3))):
            if len(chunk) > 6:
                i = int(rng.integers(6, len(chunk)))
                chunk[i] = int(rng.choice([0, 1, 2, 126, 127, 128, 254,
                                           255, chunk[i] ^ 1]))
        frame = rf.fli_frame([bytes(chunk)])
        if rng.random() < 0.2:
            frame = frame[:int(rng.integers(0, len(frame)))]
        want_img = np.zeros((H, W), np.uint8)
        want = fli_model(frame, W, H, want_img)
        got_img = np.zeros((H, W), np.uint8)
        try:
            r = imgdec.fli_frame(frame, got_img)
            got = "done" if r == -1 else ("more", r)
        except ValueError:
            got = "error"
        assert got == want, (trial, frame.hex())
        np.testing.assert_array_equal(got_img, want_img)
        if trial % 10 == 0:
            data = rf.fli_header(W, H) + frame
            if want == "done":
                np.testing.assert_array_equal(pillow_array(data, tmp_path),
                                              want_img)
            else:
                with pytest.raises(Exception):
                    pillow_array(data, tmp_path)


def test_icns_has_no_not_ported_branch():
    """data/icns.py reads every JPEG 2000 entry mode now, and the image
    readers raise NotImplementedError only for AVIF (png.py) and the
    JPEG 2000 residue (jpeg2000.py)."""
    data = REPO / "nerf2mesh_tpu_torch" / "data"
    users = sorted(p.name for p in data.glob("*.py")
                   if "NotImplementedError" in p.read_text())
    assert users == ["jpeg2000.py", "png.py"], users
    src = (data / "png.py").read_text()
    assert src.count("raise NotImplementedError") == 1
    assert "AVIF" in src[src.index("raise NotImplementedError"):][:120]


def test_icns_palette_built_as_getcolor():
    """The palette Pillow builds from pclr entries through getcolor:
    duplicates share a slot, one-component entries overwrite each other's
    bytes, a 257th colour is refused."""
    from nerf2mesh_tpu_torch.data import jpeg2000
    assert jpeg2000.pillow_palette([(1, 2, 3), (4, 5, 6), (1, 2, 3),
                                    (7, 8, 9)], 3) == (
        "RGB", bytes([1, 2, 3, 4, 5, 6, 7, 8, 9]))
    assert jpeg2000.pillow_palette([(10,), (20,), (30,), (40,)], 1) == (
        "RGB", bytes([40]))
    assert jpeg2000.pillow_palette([(1, 2, 3, 4)], 4) == (
        "RGBA", bytes([1, 2, 3, 4]))
    with pytest.raises(ValueError, match="256"):
        jpeg2000.pillow_palette([(i, i // 256, 0) for i in range(300)], 3)


def test_dispatch_names_pillow_order():
    """The new readers sit at their plugins' places in Image.OPEN: FITS
    and FLI after EPS, GBR before GRIB, IMT and IPTC after IM, McIdas
    before MPEG, PCD and PIXAR after MSP, SUN after SPIDER, XPM and
    XVTHUMB last."""
    names = [n for n, _, _ in png.legacy_readers(b"")]
    pos = {n: i for i, n in enumerate(names)}
    assert pos["EPS"] < pos["FITS"] < pos["FLI"] < pos["FTEX"] < pos[
        "GBR"] < pos["GRIB"]
    assert pos["IM"] < pos["IMT"] < pos["IPTC"] < pos["MCIDAS"] < pos[
        "MPEG"] < pos["TIFF"] < pos["MSP"] < pos["PCD"] < pos["PIXAR"] < \
        pos["PSD"]
    assert pos["SPIDER"] < pos["SUN"] < pos["TGA"]
    assert names[-3:] == ["XBM", "XPM", "XVTHUMB"]


def test_xv_thumbnail_not_taken_as_pam(tmp_path):
    """"P7 332" is not PPM's (its _accept takes P0-P6, Pf and Py only): the
    XV thumbnail reader gets it; a PAM file ("P7\\n") is unidentified."""
    thumb = rf.xv_thumb(np.arange(12, dtype=np.uint8).reshape(3, 4))
    np.testing.assert_array_equal(port_array(thumb, tmp_path),
                                  np.arange(12).reshape(3, 4))
    pam = b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n" + bytes(4)
    with pytest.raises(ValueError, match="no reader takes this file"):
        port_array(pam, tmp_path)


# ------------------------------------------------------- capture and masks
def quantised(rgb: np.ndarray, n: int = 300) -> tuple:
    """(indices, colours) of a frame quantised to 16 levels a channel,
    with at least n colours (so an XPM of it is "RGB")."""
    q = (rgb // 16).astype(np.int64)
    code = q[..., 0] * 256 + q[..., 1] * 16 + q[..., 2]
    used, idx = np.unique(code, return_inverse=True)
    extra = np.setdiff1d(np.arange(4096), used)[:max(n - len(used), 0)]
    codes = np.concatenate([used, extra])
    cols = (np.stack([codes // 256, codes // 16 % 16, codes % 16], -1) * 16
            + 8).astype(np.uint8)
    return idx.reshape(rgb.shape[:2]), cols


def encode_frame(rgb: np.ndarray, kind: str) -> tuple:
    """(extension, bytes) of a capture frame in `kind`."""
    H, W = rgb.shape[:2]
    grey = rgb.mean(-1).astype(np.uint8)
    if kind == "sun24":
        return "ras", rf.sun(rgb, 24)
    if kind == "sun24_rle":
        return "ras", rf.sun(rgb, 24, 2)
    if kind == "sun32":
        return "ras", rf.sun(rgb, 32, 3)
    if kind == "pixar":
        return "pxr", rf.pixar(rgb)
    if kind == "gbr_rgba":
        return "gbr", rf.gbr(np.dstack([rgb, np.full((H, W), 255,
                                                     np.uint8)]))
    if kind == "xpm_rgb":
        return "xpm", rf.xpm(*quantised(rgb), cpp=2)
    if kind == "iptc_band":
        return "iim", rf.iptc(W, H, 3, 1, grey.tobytes(), band=2)
    raise KeyError(kind)


def encode_mask(mask: np.ndarray, kind: str) -> bytes:
    """A bool [H, W] mask as 0/255 (McIdas "L", IMT, FITS 8-bit, the XV
    thumbnail's and FLI's indices) or 0/1 (XPM "P" of two colours)."""
    m = mask.astype(np.uint8) * 255
    H, W = mask.shape
    if kind == "mcidas":
        return rf.mcidas(m, 1, prefix=4)
    if kind == "imt":
        return rf.imt(m)
    if kind == "fits8":
        return rf.fits(m[::-1], 8)
    if kind == "xvthumb":
        return rf.xv_thumb(m)
    if kind == "fli":
        return rf.fli(W, H, [rf.fli_brun(m)])
    if kind == "xpm_p":
        return rf.xpm(mask.astype(np.int64), np.array(
            [[0, 0, 0], [255, 255, 255]], np.uint8), 1)
    raise KeyError(kind)


def make_capture(root: str, side: int = CAPTURE_SIZE) -> None:
    """A 16-view COLMAP capture at side^2 whose i-th frame is in
    FRAME_KINDS[i % 7] (renamed in images.bin), its mask in MASK_KINDS[i %
    6] under the name the providers look for (mask/<stem>.png: both
    packages read a file by its content)."""
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
        ext, data = encode_frame(rgb, FRAME_KINDS[i % len(FRAME_KINDS)])
        name = f"{stem}.{ext}"
        Path(root, "images", name).write_bytes(data)
        os.remove(src)
        ims[k] = dataclasses.replace(im, name=name)
        mask = rgb.astype(int).sum(-1) > 60
        Path(root, "mask", stem + ".png").write_bytes(
            encode_mask(mask, MASK_KINDS[i % len(MASK_KINDS)]))
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
        alphas |= {int(v) for v in np.unique(got.images[..., 3])}
    assert alphas <= {0, 1, 255} and len(alphas) > 1
    names = sorted(os.listdir(capture / "images"))
    assert {n.rsplit(".", 1)[1] for n in names} == {"ras", "pxr", "gbr",
                                                    "xpm", "iim"}


def test_capture_loads_as_jax():
    """The committed capture fixtures/colmap_rare (frames in the seven
    forms chip_smoke's phase 14 (k) trains on: SUN 24-bit raw and RLE, SUN
    32-bit, PIXAR, GBR RGBA, XPM RGB and an IPTC band image; McIdas, IMT,
    FITS, XV thumbnail, FLI and XPM "P" masks): JAX's COLMAP provider
    (Pillow) and the port's (Pillow blocked) load equal images, masks,
    poses and intrinsics."""
    _loads_as_jax(CAPTURE)


def test_tiny_capture_loads_as_jax(tmp_path):
    """The same forms at 32^2, written here: both providers load equal
    arrays."""
    root = tmp_path / "c"
    make_capture(str(root), side=32)
    _loads_as_jax(root)


# ------------------------------------------------------- committed fixtures
def is_mine(rel: str) -> bool:
    return rel.startswith(tuple(f"formats/{f}/" for f in FORMATS)
                          + ("colmap_rare/",))


def committed() -> list:
    out = sorted(CASES)
    for d in ("images", "mask"):
        out += [str(p.relative_to(FIXTURES))
                for p in sorted((CAPTURE / d).iterdir())]
    return out


def write_fixtures() -> None:
    """Writes every case, the capture fixtures/colmap_rare/ and their
    entries in fixtures/formats.json; the other modules' entries stay."""
    import tempfile
    hashes = json.loads(FORMAT_HASHES.read_text())
    for k in [k for k in hashes if is_mine(k)]:
        del hashes[k]
    for d in FORMATS:
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
    assert len([f for f in files if f.startswith("colmap_rare/")]) == 32
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
    synthetic frames (frames 0-6 and their masks)."""
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    root = tmp_path / "c"
    generate_colmap_dataset(str(root), H=CAPTURE_SIZE, W=CAPTURE_SIZE,
                            n_images=16, n_points=400)
    names = sorted(os.listdir(root / "images"))[:7]
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
    rels = ["formats/sun/d24_rle.ras", "formats/xpm/rgb_cpp2_over_256.xpm",
            "formats/pixar/rgb.pxr", "formats/mcidas/i16b.area",
            "formats/gbr/v2_rgba.gbr", "formats/imt/grey.imt",
            "formats/xvthumb/thumb.xv", "formats/fits/gzip_bitpix16.fits",
            "formats/fli/brun_ss2.flc", "formats/pcd/base_rotated_270.pcd",
            "formats/iptc/jpeg_rgb_band3.iim"]
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
