"""The texture and layered-image forms the port reads since ROADMAP A6 (j)
7-9 against Pillow 12.1.0, on the CPU: DDS (every BCn codec, the legacy
masked-RGB, luminance and palette forms, DX10), FTEX, BLP (BLP1 JPEG and
palette, BLP2 palette and DXT), PSD (every mode of PsdImagePlugin.MODES,
raw and PackBits, with and without layers) and bare DIB.

The oracle is ``np.asarray(Image.open(p))``, the array the JAX package's
providers see: every case must give its dtype, shape and bytes exactly.
Every 8- or 16-byte string is a valid BCn block, so random blocks behind a
DDS header hold each codec, each BC7 mode 0-8 and each BC6H mode (signed
and unsigned, a reserved one) to Pillow; blocks whose endpoints are drawn
in band hold BC6H's half arithmetic where its values do not saturate.
Pillow writes uncompressed, DXT1/3/5 and BC2/3/5 DDS, BLP palettes and
DIB; nerf2mesh_tpu_torch/tools/texture_forms.py writes the rest.  What
Pillow refuses, the port refuses with ValueError, and the test shows
Pillow refusing the same bytes.  The port's side runs with Pillow blocked
in sys.modules.  The committed files under nerf2mesh_tpu_torch/fixtures/
formats/{dds,ftex,blp,psd,dib} and the COLMAP capture
fixtures/colmap_textures (written by ``python
tests/test_torch_textureforms.py``) hash to Pillow's arrays in
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

from nerf2mesh_tpu_torch.data import imgdec, png
from nerf2mesh_tpu_torch.tools import texture_forms as tf

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "nerf2mesh_tpu_torch" / "fixtures"
FORMAT_HASHES = FIXTURES / "formats.json"
# the COLMAP capture chip_smoke.py's phase 14 (i) trains on
CAPTURE = FIXTURES / "colmap_textures"
FRAME_KINDS = ["dds_dxt1", "dds_dxt5", "dds_bc7", "dds_bc6h", "dds_565",
               "ftex_dxt1", "blp1_jpeg", "blp2_dxt5", "blp2_palette",
               "psd_rgb_packbits", "psd_rgba_raw", "dib24"]
MASK_KINDS = ["psd_l", "dds_l", "dds_bc4", "psd_bitmap"]
DDPF_RGB, DDPF_ALPHA, DDPF_FOURCC, DDPF_PAL8, DDPF_LUM = (0x40, 0x1, 0x4,
                                                          0x20, 0x20000)
SIZE = (61, 62)                  # a variant's H, W (no multiple of 4)


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
    """A smooth picture with noise and flat patches: RGB, RGBA, grey and a
    bilevel image."""
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
            "L": grey, "1": bilevel}


def pillow_save(a, fmt: str, mode: str | None = None, **kw) -> bytes:
    """An array (or a Pillow image), converted to `mode`, saved by
    Pillow."""
    im = a if isinstance(a, Image.Image) else Image.fromarray(a)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def blocks(h: int, w: int) -> int:
    return ((h + 3) // 4) * ((w + 3) // 4)


def dxt_blocks(rgba: np.ndarray, fmt: str) -> bytes:
    """The blocks of Pillow's own DXT1/DXT5 encoder (its DDS writer)."""
    return pillow_save(rgba, "DDS", pixel_format=fmt)[128:]


# ----------------------------------------------------------------- cases
def dds_cases(p) -> dict:
    H, W = SIZE
    rng = np.random.default_rng(20)
    n = blocks(H, W)
    out = {}
    for mode in ("L", "LA", "RGB", "RGBA"):
        out[f"pillow_{mode.lower()}"] = pillow_save(p["RGBA"], "DDS", mode)
    for fmt in ("DXT1", "DXT3", "DXT5", "BC2", "BC3"):
        out[f"pillow_{fmt.lower()}"] = pillow_save(p["RGBA"], "DDS",
                                                   pixel_format=fmt)
    out["pillow_bc5"] = pillow_save(p["RGB"], "DDS", pixel_format="BC5")
    rgb16 = (0xF800, 0x7E0, 0x1F, 0)
    out["rgb565"] = tf.dds(W, H, DDPF_RGB, bitcount=16, masks=rgb16,
                           body=tf.mask_pixels(p["RGB"], 16, rgb16))
    a1 = (0x7C00, 0x3E0, 0x1F, 0x8000)
    out["argb1555"] = tf.dds(W, H, DDPF_RGB | DDPF_ALPHA, bitcount=16,
                             masks=a1, body=tf.mask_pixels(p["RGBA"], 16, a1))
    a4 = (0xF00, 0xF0, 0xF, 0xF000)
    out["argb4444"] = tf.dds(W, H, DDPF_RGB | DDPF_ALPHA, bitcount=16,
                             masks=a4, body=tf.mask_pixels(p["RGBA"], 16, a4))
    r332 = (0xE0, 0x1C, 0x3, 0)
    out["rgb332"] = tf.dds(W, H, DDPF_RGB, bitcount=8, masks=r332,
                           body=tf.mask_pixels(p["RGB"], 8, r332))
    bgr = (0xFF0000, 0xFF00, 0xFF, 0)
    out["bgr24"] = tf.dds(W, H, DDPF_RGB, bitcount=24, masks=bgr,
                          body=tf.mask_pixels(p["RGB"], 24, bgr))
    a2 = (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)
    out["a2r10g10b10"] = tf.dds(W, H, DDPF_RGB | DDPF_ALPHA, bitcount=32,
                                masks=a2, body=rng.integers(
                                    0, 256, H * W * 4, np.uint8).tobytes())
    full = tf.mask_pixels(p["RGB"], 16, rgb16)
    out["rgb565_truncated"] = tf.dds(W, H, DDPF_RGB, bitcount=16, masks=rgb16,
                                     body=full[:len(full) // 2 + 1])
    pal = np.concatenate([rng.integers(0, 256, (256, 3)),
                          np.arange(256)[:, None]], 1).astype(np.uint8)
    out["p8"] = tf.dds(W, H, DDPF_PAL8, bitcount=8,
                       body=pal.tobytes() + (p["L"] // 3).tobytes())
    out["l8_mipmapped"] = tf.dds(W, H, DDPF_LUM, bitcount=8, mipmaps=2,
                                 body=p["L"].tobytes() + b"\x55" * 1000)
    for fcc in (b"ATI1", b"BC4U"):
        out[f"{fcc.decode().lower()}_random"] = tf.dds(
            W, H, DDPF_FOURCC, fcc, body=rng.bytes(n * 8))
    for fcc in (b"ATI2", b"BC5U", b"BC5S"):
        out[f"{fcc.decode().lower()}_random"] = tf.dds(
            W, H, DDPF_FOURCC, fcc, body=rng.bytes(n * 16))
    out["dxt1_random"] = tf.dds(W, H, DDPF_FOURCC, b"DXT1",
                                body=rng.bytes(n * 8))
    out["dxt1_cubemap"] = tf.dds(W, H, DDPF_FOURCC, b"DXT1", caps2=0xFE00,
                                 body=rng.bytes(n * 8 * 6))
    names = {70: "bc1_typeless", 71: "bc1_unorm", 73: "bc2_typeless",
             74: "bc2_unorm", 76: "bc3_typeless", 77: "bc3_unorm",
             79: "bc4_typeless", 80: "bc4_unorm", 82: "bc5_typeless",
             83: "bc5_unorm", 84: "bc5_snorm"}
    for dxgi, name in names.items():
        size = 8 if dxgi in (70, 71, 79, 80) else 16
        out[f"dx10_{name}_random"] = tf.dds(W, H, DDPF_FOURCC, b"DX10",
                                            dxgi=dxgi, body=rng.bytes(n * size))
    for dxgi, name in ((95, "uf16"), (96, "sf16")):
        out[f"dx10_bc6h_{name}_modes"] = tf.dds(
            W, H, DDPF_FOURCC, b"DX10", dxgi=dxgi,
            body=tf.random_bc6h(n, rng))
        out[f"dx10_bc6h_{name}_inband"] = tf.dds(
            W, H, DDPF_FOURCC, b"DX10", dxgi=dxgi,
            body=b"".join(tf.bc6h_inband(i % 14, dxgi == 96, rng)
                          for i in range(n)))
    for dxgi, name in ((97, "typeless"), (98, "unorm"), (99, "srgb")):
        out[f"dx10_bc7_{name}_modes"] = tf.dds(
            W, H, DDPF_FOURCC, b"DX10", dxgi=dxgi, body=tf.random_bc7(n, rng))
    out["dx10_bc7_mode6_picture"] = tf.dds(W, H, DDPF_FOURCC, b"DX10",
                                           dxgi=98,
                                           body=tf.bc7_mode6(p["RGBA"]))
    out["dx10_bc6h_mode3_picture"] = tf.dds(W, H, DDPF_FOURCC, b"DX10",
                                            dxgi=95,
                                            body=tf.bc6h_mode3(p["RGB"]))
    for dxgi, name in ((27, "typeless"), (28, "unorm"), (29, "srgb")):
        out[f"dx10_r8g8b8a8_{name}"] = tf.dds(
            W, H, DDPF_FOURCC, b"DX10", dxgi=dxgi, body=p["RGBA"].tobytes())
    return {f"formats/dds/{k}.dds": v for k, v in out.items()}


def ftex_cases(p) -> dict:
    H, W = SIZE
    rng = np.random.default_rng(21)
    dxt = dxt_blocks(p["RGBA"], "DXT1")
    half = p["RGB"][::2, ::2]
    return {"formats/ftex/dxt1.ftc": tf.ftex(W, H, 0, [dxt, dxt[:64]]),
            "formats/ftex/dxt1_random.ftc": tf.ftex(
                W, H, 0, [rng.bytes(blocks(H, W) * 8)]),
            "formats/ftex/rgb.ftu": tf.ftex(W, H, 1, [p["RGB"].tobytes(),
                                                      half.tobytes()])}


def _jpeg(img, **kw) -> bytes:
    return pillow_save(img, "JPEG", quality=90, **kw)


def blp_cases(p) -> dict:
    H, W = 64, 64
    q = picture(H, W, 3)
    rng = np.random.default_rng(22)
    bgr = q["RGB"][..., ::-1].copy()
    pal_img = Image.fromarray(q["RGB"]).quantize(256, dither=0)
    idx = np.asarray(pal_img)
    pal = np.asarray(pal_img.getpalette()[:768], np.uint8).reshape(-1, 3)
    pal_a = np.concatenate([pal, (np.arange(len(pal)) * 5 % 256)[:, None]],
                           1).astype(np.uint8)
    cmyk = io.BytesIO()
    Image.fromarray(q["RGB"]).convert("CMYK").save(cmyk, "JPEG", quality=90)
    out = {
        "blp1_jpeg": tf.blp1_jpeg(W, H, _jpeg(bgr)),
        "blp1_jpeg_alpha": tf.blp1_jpeg(W, H, _jpeg(bgr), alpha=8,
                                        gap=b"\0" * 9),
        "blp1_jpeg_grey": tf.blp1_jpeg(W, H, _jpeg(q["L"])),
        "blp1_jpeg_cmyk": tf.blp1_jpeg(W, H, cmyk.getvalue()),
        "blp1_palette_enc5": tf.blp1_palette(idx, pal),
        "blp1_palette_enc4_alpha": tf.blp1_palette(idx, pal_a, alpha=8,
                                                   encoding=4),
        "blp2_pillow_palette": pillow_save(pal_img, "BLP"),
        "blp2_dxt1": tf.blp2(W, H, 2, 0, 0, dxt_blocks(q["RGBA"], "DXT1")),
        "blp2_dxt1_alpha": tf.blp2(W, H, 2, 1, 0, rng.bytes(256 * 8)),
        "blp2_dxt3": tf.blp2(W, H, 2, 8, 1, rng.bytes(256 * 16)),
        "blp2_dxt5": tf.blp2(W, H, 2, 8, 7, dxt_blocks(q["RGBA"], "DXT5")),
        "blp2_dxt5_random": tf.blp2(W, H, 2, 8, 7, rng.bytes(256 * 16)),
        "blp2_dxt5_no_alpha": tf.blp2(W, H, 2, 0, 7, rng.bytes(256 * 16)),
        "blp2_dxt1_w62": tf.blp2(62, 61, 2, 1, 0, rng.bytes(256 * 8)),
    }
    pal_img.putpalette(pal_a.reshape(-1).tolist(), "RGBA")
    out["blp1_pillow_palette_rgba"] = pillow_save(pal_img, "BLP",
                                                  blp_version="BLP1")
    out["blp2_pillow_palette_rgba"] = pillow_save(pal_img, "BLP")
    for depth in (0, 1, 4, 8):
        out[f"blp2_palette_depth{depth}"] = tf.blp2(
            W, H, 1, depth, 0, idx.tobytes(), palette=pal_a)
    return {f"formats/blp/{k}.blp": v for k, v in out.items()}


def _bits(b: np.ndarray) -> np.ndarray:
    return np.packbits(b, axis=1)


def psd_cases(p) -> dict:
    H, W = SIZE
    rgb, rgba, grey = p["RGB"], p["RGBA"], p["L"]
    planes = [rgba[..., c] for c in range(4)]
    rng = np.random.default_rng(23)
    pal = rng.integers(0, 256, 768, np.uint8).tobytes()
    lab = np.asarray(Image.fromarray(rgb).convert("LAB"))
    res = [(1005, b"", b"\0\x48\0\0" * 4), (1039, b"icc", b"\x01\x02\x03")]
    layers = tf.psd_layers(W, H, rgba)
    out = {}
    for comp, tag in ((0, "raw"), (1, "packbits")):
        out[f"bitmap_{tag}"] = tf.psd([_bits(p["1"])], 0, 1, comp, width=W)
        out[f"grey_{tag}"] = tf.psd([grey], 1, 8, comp, resources=res)
        out[f"rgb_{tag}"] = tf.psd(planes[:3], 3, 8, comp)
        out[f"rgba_{tag}"] = tf.psd(planes, 3, 8, comp)
        out[f"cmyk_{tag}"] = tf.psd(planes, 4, 8, comp)
        out[f"rgba_layers_{tag}"] = tf.psd(planes, 3, 8, comp, layers=layers,
                                           resources=res)
    out["grey_mode0"] = tf.psd([grey], 0, 8, 1)
    out["grey_alpha"] = tf.psd([grey, planes[3]], 1, 8, 1)
    out["indexed_palette"] = tf.psd([grey], 2, 8, 1, colour_data=pal)
    out["indexed_short_palette"] = tf.psd([grey], 2, 8, 0,
                                          colour_data=pal[:300])
    out["rgb_five_channels"] = tf.psd(planes + [grey], 3, 8, 1)
    out["multichannel"] = tf.psd([grey, planes[0]], 7, 8, 1)
    out["duotone"] = tf.psd([grey], 8, 8, 1, colour_data=b"\0" * 40)
    out["lab"] = tf.psd([lab[..., c] for c in range(3)], 9, 8, 1)
    return {f"formats/psd/{k}.psd": v for k, v in out.items()}


def dib_cases(p) -> dict:
    from nerf2mesh_tpu_torch.tools import legacy_forms as lf
    out = {f"pillow_{m.lower()}": pillow_save(p["RGB"], "DIB", m)
           for m in ("1", "L", "P", "RGB")}
    H, W = SIZE
    core = bytearray(pillow_save(p["RGB"], "DIB", "RGB"))
    hdr = struct.pack("<IHHHH", 12, W, H, 1, 24)   # OS/2 core header
    out["os2_core_24"] = hdr + bytes(core[40:])
    entry = lf.dib(p["RGB"], 24)               # an icon's DIB: rows doubled
    out["icon_entry_24"] = entry[:8] + struct.pack("<i", H) + entry[12:]
    return {f"formats/dib/{k}.dib": v for k, v in out.items()}


def all_cases() -> dict:
    p = picture()
    out = {}
    for f in (dds_cases, ftex_cases, blp_cases, psd_cases, dib_cases):
        out.update(f(p))
    return out


CASES = all_cases()


def refused_cases() -> dict:
    """{name: bytes} Pillow refuses to read; the port raises ValueError."""
    H, W = 8, 8
    body = bytes(range(256)) * 2
    p = picture(H, W, 4)
    planes = [p["RGB"][..., c] for c in range(3)]
    psd16 = tf.psd([np.zeros((H, 2 * W), np.uint8)] * 3, 3, 16, 0, width=W)
    blp1 = tf.blp1_palette(np.zeros((H, W), np.uint8), p["RGB"][0])
    psd_zip = bytearray(tf.psd(planes, 3, 8, 0))
    at = len(psd_zip) - 3 * H * W - 2
    psd_zip[at:at + 2] = struct.pack(">H", 2)   # ZIP without prediction
    psd_zip = bytes(psd_zip)
    return {
        "dds_header_size_100": tf.dds(W, H, DDPF_FOURCC, b"DXT1",
                                      header_size=100, body=body),
        "dds_header_cut": tf.dds(W, H, DDPF_FOURCC, b"DXT1")[:100],
        "dds_fourcc_dxt2": tf.dds(W, H, DDPF_FOURCC, b"DXT2", body=body),
        "dds_fourcc_bc4s": tf.dds(W, H, DDPF_FOURCC, b"BC4S", body=body),
        "dds_dxgi_float": tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=2,
                                 body=body),
        "dds_dxgi_b8g8r8a8": tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=87,
                                    body=body),
        "dds_luminance_16": tf.dds(W, H, DDPF_LUM, bitcount=16, body=body),
        "dds_no_pixel_flags": tf.dds(W, H, 0, body=body),
        "dds_bc7_truncated": tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=98,
                                    body=body[:40]),
        "dds_l_truncated": tf.dds(W, H, DDPF_LUM, bitcount=8, body=b"\0" * 9),
        "ftex_two_formats": tf.ftex(W, H, 0, [body], formats=2),
        "ftex_format_2": tf.ftex(W, H, 2, [body]),
        "ftex_rgb_truncated": tf.ftex(W, H, 1, [body[:50]]),
        "blp1_compression_2": b"BLP1" + struct.pack("<i", 2) + blp1[8:],
        "blp1_encoding_3": tf.blp1_palette(np.zeros((H, W), np.uint8),
                                           p["RGB"][0], encoding=3),
        "blp1_not_a_jpeg": tf.blp1_jpeg(W, H, b"\xff\xd8\xff\xda" + body),
        "blp2_jpeg": tf.blp2(W, H, 2, 0, 0, body[:32], compression=0),
        "blp2_raw_bgra": tf.blp2(W, H, 3, 0, 0, body),
        "blp2_alpha_encoding_2": tf.blp2(W, H, 2, 8, 2, body),
        "blp2_dxt5_truncated": tf.blp2(W, H, 2, 8, 7, body[:40]),
        "blp2_palette_short": tf.blp2(W, H, 1, 0, 0, body[:20]),
        "psd_16_bit": psd16,
        "psd_32_bit": psd16[:22] + struct.pack(">H", 32) + psd16[24:],
        "psd_rgb_two_channels": tf.psd(planes, 3, 8, 0, channels=2),
        "psd_cmyk_three_channels": tf.psd(planes, 4, 8, 0, channels=3),
        "psd_zip": psd_zip,
        "psd_packbits_truncated": tf.psd(planes, 3, 8, 1)[:-10],
        "psd_raw_truncated": tf.psd(planes, 3, 8, 0)[:-10],
        "dib_bits_7": pillow_save(p["RGB"], "DIB")[:14] + struct.pack(
            "<H", 7) + pillow_save(p["RGB"], "DIB")[16:],
    }


REFUSED = refused_cases()


def not_read_cases() -> dict:
    """{name: bytes} whose prefix a new plugin accepts but whose _open
    Image.open passes over, and no other plugin reads (Pillow:
    UnidentifiedImageError, the port: ValueError)."""
    dxt = tf.dds(8, 8, DDPF_FOURCC, b"DXT1", body=b"\0" * 32)
    ftex = bytearray(tf.ftex(8, 8, 0, [b"\0" * 32]))
    struct.pack_into("<i", ftex, 28, 4000)        # data past the end
    dib = bytearray(pillow_save(picture(8, 8)["RGB"], "DIB", "RGB"))
    struct.pack_into("<H", dib, 14, 16)
    struct.pack_into("<I", dib, 16, 3)            # bitfields, masks cut
    return {
        "dds_dx10_header_cut": tf.dds(8, 8, DDPF_FOURCC, b"DX10")[:130],
        "dds_zero_width": dxt[:16] + b"\0" * 4 + dxt[20:],
        "ftex_data_past_end": bytes(ftex),
        "ftex_header_cut": bytes(ftex[:20]),
        "blp2_header_cut": tf.blp2(8, 8, 1, 0, 0, b"")[:14],
        "psd_version_2": tf.psd([np.zeros((4, 4), np.uint8)], 1, 8, 0,
                                version=2),
        "psd_zero_height": tf.psd([np.zeros((0, 4), np.uint8)], 1, 8, 0,
                                  width=4),
        "dib_masks_cut": bytes(dib[:40]),
    }


NOT_READ = not_read_cases()


# ------------------------------------------------------------------ tests
def test_case_sizes():
    """Each variant is at most 64^2, and the committed set stays small."""
    for rel, data in CASES.items():
        h, w = np.asarray(Image.open(io.BytesIO(data))).shape[:2]
        assert h * w <= 64 * 64, rel
    assert sum(len(d) for d in CASES.values()) < 1_000_000


@pytest.mark.parametrize("rel", sorted(CASES))
def test_reads_as_pillow(rel, tmp_path):
    data = CASES[rel]
    name = rel.rsplit("/", 1)[1]
    assert sha(port_array(data, tmp_path, name)) == sha(
        pillow_array(data, tmp_path, name)), rel


# refusals Pillow reports as an unidentified image: PsdImagePlugin's MODES
# lookup raises KeyError, which ImageFile turns into a SyntaxError, so
# Image.open passes the file over, and no other plugin reads a file that
# starts 8BPS
UNIDENTIFIED = {"psd_16_bit", "psd_32_bit"}


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


# a small surface: 4 x 3 blocks, cropped on both edges
SMALL = (10, 13)


@pytest.mark.parametrize("mode", range(9))
def test_bc7_mode_random_blocks(mode, tmp_path):
    """Random blocks of one BC7 mode (8: a first byte of 0) against
    Pillow."""
    H, W = SMALL
    rng = np.random.default_rng(100 + mode)
    data = tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=98,
                  body=tf.random_bc7(blocks(H, W), rng, [mode]))
    assert sha(port_array(data, tmp_path)) == sha(pillow_array(data, tmp_path))


BC6H_MODES = list(range(14)) + list(tf.BC6H_RESERVED)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("mode", BC6H_MODES)
def test_bc6h_mode_random_blocks(mode, signed, tmp_path):
    """Random blocks of one BC6H mode (or a reserved mode code), unsigned
    and signed, against Pillow."""
    H, W = SMALL
    rng = np.random.default_rng(200 + mode + 50 * signed)
    data = tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=96 if signed else 95,
                  body=tf.random_bc6h(blocks(H, W), rng, [mode]))
    want = pillow_array(data, tmp_path)
    assert sha(port_array(data, tmp_path)) == sha(want)
    if mode >= 14:
        assert not want.any()                  # reserved modes: black


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("mode", range(14))
def test_bc6h_in_band_blocks(mode, signed, tmp_path):
    """Blocks of one BC6H mode whose endpoints are drawn in band: at least
    half the values strictly between 0 and 255, all Pillow's."""
    H, W = SMALL
    rng = np.random.default_rng(300 + mode + 50 * signed)
    body = b"".join(tf.bc6h_inband(mode, signed, rng)
                    for _ in range(blocks(H, W)))
    data = tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=96 if signed else 95,
                  body=body)
    want = pillow_array(data, tmp_path)
    assert ((want > 0) & (want < 255)).mean() >= 0.5
    assert sha(port_array(data, tmp_path)) == sha(want)


def test_block_tables_through_decodes(tmp_path):
    """Every constant native/bcndec.cpp commits, through decodes against
    Pillow: each BC7 partition of every partitioned mode (the two- and
    three-subset masks, their anchors: a wrong anchor shifts every later
    index), every BC6H mode with each of its 32 partitions (the packing of
    each endpoint bit), and the weights through random indices."""
    rng = np.random.default_rng(7)
    bc7 = []
    for mode, parts in ((0, 16), (1, 64), (2, 64), (3, 64), (7, 64)):
        pb = {0: 4, 1: 6, 2: 6, 3: 6, 7: 6}[mode]
        for part in range(parts):
            b = bytearray(rng.bytes(16))
            v = int.from_bytes(b, "little")
            v = (v >> (mode + 1 + pb) << (mode + 1 + pb)) | (part << (
                mode + 1)) | (1 << mode)
            bc7.append(v.to_bytes(16, "little"))
    bc6 = []
    for mode in range(14):
        code, nbits = tf.BC6H_MODE_BITS[mode]
        layout_bits = {2: 75}.get(nbits, 72 if mode < 10 else 60)
        for part in range(32 if mode < 10 else 4):
            v = int.from_bytes(rng.bytes(16), "little")
            v = v >> nbits << nbits | code
            if mode < 10:
                at = nbits + layout_bits
                v = v & ~(31 << at) | part << at
            bc6.append(v.to_bytes(16, "little"))
    for body, dxgi in ((bc7, 98), (bc6, 95), (bc6, 96)):
        n = len(body)
        W = 4 * 16
        H = 4 * (-(-n // 16))
        raw = b"".join(body) + b"\0" * (16 * (H // 4 * 16 - n))
        data = tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=dxgi, body=raw)
        assert sha(port_array(data, tmp_path)) == sha(
            pillow_array(data, tmp_path)), dxgi


def test_blp_and_dds_decode_the_same_blocks_apart(tmp_path):
    """BLP2's DXT decoders are Pillow's Python ones, not BcnDecode.c: the
    same blocks read through a DDS and a BLP2 header differ (unreplicated
    5:6:5, DXT3 alpha times 17, three-colour DXT1 blocks' midpoints), and
    the port gives each path's own array."""
    rng = np.random.default_rng(8)
    H = W = 16
    for fourcc, kind, size in ((b"DXT1", 0, 8), (b"DXT3", 1, 16),
                               (b"DXT5", 7, 16)):
        body = rng.bytes(blocks(H, W) * size)
        d = tf.dds(W, H, DDPF_FOURCC, fourcc, body=body)
        b = tf.blp2(W, H, 2, 8, kind, body)
        via_dds, via_blp = (pillow_array(d, tmp_path, "d"),
                            pillow_array(b, tmp_path, "b"))
        assert via_dds.shape == via_blp.shape == (H, W, 4)
        assert not np.array_equal(via_dds, via_blp), fourcc
        assert sha(port_array(d, tmp_path, "d")) == sha(via_dds)
        assert sha(port_array(b, tmp_path, "b")) == sha(via_blp)


def test_dds_raw_reads_after_the_header(tmp_path):
    """Uncompressed L, LA and P tiles say offset 0, but DdsImageFile's
    load_seek ignores the seek: the pixels are the bytes after the header
    (after the palette for P), as the port reads them."""
    H, W = 5, 7
    rng = np.random.default_rng(9)
    px = rng.integers(0, 256, (H, W, 2), np.uint8)
    pal = rng.bytes(1024)
    for flags, bits, body, want in (
            (DDPF_LUM, 8, px[..., 0].tobytes(), px[..., 0]),
            (DDPF_LUM | DDPF_ALPHA, 16, px.tobytes(), px),
            (DDPF_PAL8, 8, pal + px[..., 1].tobytes(), px[..., 1])):
        data = tf.dds(W, H, flags, bitcount=bits, body=body)
        np.testing.assert_array_equal(pillow_array(data, tmp_path), want)
        np.testing.assert_array_equal(port_array(data, tmp_path), want)


def test_psd_packbits_rows_and_counts(tmp_path):
    """Pillow's PackBits decoder cuts a run at a row's end (imgdec.packbits,
    TIFF's single stream, does not), and a channel starts where the byte
    counts before it say, whatever its rows' runs use: a PSD whose runs
    cross rows, and ones whose counts over- and under-state a row, against
    Pillow."""
    H, W = 4, 6
    stream = b"".join(bytes([257 - 8, 10 * y]) for y in range(H))
    cut, n = imgdec.packbits_rows(stream, W, H)
    assert n == len(stream)
    np.testing.assert_array_equal(cut, np.arange(H)[:, None] * 10 + 0 * cut)
    whole = imgdec.packbits(stream, W * H).reshape(H, W)
    assert not np.array_equal(whole, cut)
    grey = tf.psd([np.zeros((H, W), np.uint8)], 1, 8, 1)
    head = grey[:len(grey) - 2 - 2 * H - sum(
        len(tf.packbits(bytes(W))) for _ in range(H))]
    data = head + struct.pack(f">H{H}H", 1, *[2] * H) + stream
    np.testing.assert_array_equal(pillow_array(data, tmp_path), cut)
    np.testing.assert_array_equal(port_array(data, tmp_path), cut)
    planes = [np.full((H, W), 10 * c + 1, np.uint8) for c in range(3)]
    planes[1][1] = np.arange(W)
    good = tf.psd(planes, 3, 8, 1)
    counts_at = len(good) - sum(len(tf.packbits(bytes(r))) for q in planes
                                for r in q) - 2 * 3 * H
    for delta in (2, -1):                  # channel 1 starts later, earlier
        d = bytearray(good) + b"\0" * 64
        (c,) = struct.unpack_from(">H", d, counts_at)
        struct.pack_into(">H", d, counts_at, c + delta)
        want = pillow_array(bytes(d), tmp_path)
        assert not np.array_equal(want, np.stack(planes, -1)), delta
        assert sha(port_array(bytes(d), tmp_path)) == sha(want), delta


def test_psd_layers_leave_the_merged_image(tmp_path):
    """A file with a layer section reads as its merged image: Pillow
    parses the layer (RGBA, its box) when asked, but np.asarray gives the
    image data section."""
    p = picture(8, 8, 5)
    merged = [p["RGBA"][..., c] for c in range(4)]
    layer = 255 - p["RGBA"]
    data = tf.psd(merged, 3, 8, 1, layers=tf.psd_layers(8, 8, layer))
    with Image.open(io.BytesIO(data)) as im:
        assert [(m, box) for _, m, box, _ in im.layers] == [
            ("RGBA", (0, 0, 8, 8))]
        np.testing.assert_array_equal(np.asarray(im), p["RGBA"])
    np.testing.assert_array_equal(port_array(data, tmp_path), p["RGBA"])


def test_dispatch_follows_image_open(tmp_path):
    """The readers without an early signature test run in the order
    Image.open tries their plugins (a fresh process's Image.OPEN after an
    open: preinit's BMP and DIB first, then the rest as init imports
    them), and each new one's name is Pillow's."""
    path = tmp_path / "x.blp"
    path.write_bytes(CASES["formats/blp/blp2_dxt5.blp"])
    code = ("from PIL import Image; Image.open(%r).load(); "
            "print(' '.join(Image.OPEN))" % str(path))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    names = [n for n, _, _ in png.legacy_readers(b"")]
    order = [n for n in res.stdout.split() if n in names]
    assert names == order
    assert {"BLP", "DIB", "DDS", "FTEX", "PSD"} <= set(names)


def test_writers_hold_to_pillow(tmp_path):
    """The writers' check: the BC7 mode-6 and BC6H mode-3 encoders give
    Pillow's decode near a smooth picture (on the noisy one, within its
    noise), BC4 the mask exactly, the masked RGB writer its fields, the
    PSD writer each channel."""
    p = picture()
    H, W = SIZE
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = np.stack([xx * 4, yy * 4, (xx + yy) * 2, 255 - xx * 2],
                      -1).clip(0, 255).astype(np.uint8)
    for body, ref, dxgi in ((tf.bc7_mode6(smooth), smooth, 98),
                            (tf.bc6h_mode3(smooth[..., :3]),
                             smooth[..., :3], 95)):
        got = pillow_array(tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=dxgi,
                                  body=body), tmp_path).astype(int)
        assert np.abs(got - ref).mean() < 3, dxgi
    for rel, ref in (("dx10_bc7_mode6_picture", p["RGBA"]),
                     ("dx10_bc6h_mode3_picture", p["RGB"])):
        got = pillow_array(CASES[f"formats/dds/{rel}.dds"], tmp_path)
        assert np.abs(got.astype(int) - ref).mean() < 12, rel
    mask = np.where(p["L"] > 100, 255, 0).astype(np.uint8)
    data = tf.dds(SIZE[1], SIZE[0], DDPF_FOURCC, b"ATI1", body=tf.bc4(mask))
    np.testing.assert_array_equal(pillow_array(data, tmp_path), mask)
    np.testing.assert_array_equal(
        pillow_array(CASES["formats/dds/bgr24.dds"], tmp_path), p["RGB"])
    np.testing.assert_array_equal(
        pillow_array(CASES["formats/psd/rgba_packbits.psd"], tmp_path),
        p["RGBA"])
    np.testing.assert_array_equal(
        pillow_array(CASES["formats/psd/bitmap_packbits.psd"], tmp_path),
        p["1"])


# ------------------------------------------------------- capture and masks
def encode_frame(rgb: np.ndarray, kind: str) -> tuple:
    """(extension, bytes) of a capture frame in `kind`."""
    H, W = rgb.shape[:2]
    rgba = np.concatenate([rgb, np.full((H, W, 1), 255, np.uint8)], -1)
    if kind == "dds_dxt1":
        return "dds", pillow_save(rgba, "DDS", pixel_format="DXT1")
    if kind == "dds_dxt5":
        return "dds", pillow_save(rgba, "DDS", pixel_format="DXT5")
    if kind == "dds_bc7":
        return "dds", tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=98,
                             body=tf.bc7_mode6(rgba))
    if kind == "dds_bc6h":
        return "dds", tf.dds(W, H, DDPF_FOURCC, b"DX10", dxgi=95,
                             body=tf.bc6h_mode3(rgb))
    if kind == "dds_565":
        m = (0xF800, 0x7E0, 0x1F, 0)
        return "dds", tf.dds(W, H, DDPF_RGB, bitcount=16, masks=m,
                             body=tf.mask_pixels(rgb, 16, m))
    if kind == "ftex_dxt1":
        return "ftc", tf.ftex(W, H, 0, [dxt_blocks(rgba, "DXT1")])
    if kind == "blp1_jpeg":
        return "blp", tf.blp1_jpeg(W, H, _jpeg(rgb[..., ::-1].copy()))
    if kind == "blp2_dxt5":
        return "blp", tf.blp2(W, H, 2, 8, 7, dxt_blocks(rgba, "DXT5"))
    if kind == "blp2_palette":
        return "blp", pillow_save(rgb, "BLP", "P")
    if kind == "psd_rgb_packbits":
        return "psd", tf.psd([rgb[..., c] for c in range(3)], 3, 8, 1)
    if kind == "psd_rgba_raw":
        return "psd", tf.psd([rgba[..., c] for c in range(4)], 3, 8, 0)
    if kind == "dib24":
        return "dib", pillow_save(rgb, "DIB")
    raise KeyError(kind)


def encode_mask(mask: np.ndarray, kind: str) -> bytes:
    """A [H, W] uint8 mask (0 or 255) as PSD grey (PackBits), DDS L, DDS
    BC4, or a PSD bitmap (read as 0/1 by both packages)."""
    H, W = mask.shape
    if kind == "psd_l":
        return tf.psd([mask], 1, 8, 1)
    if kind == "dds_l":
        return pillow_save(mask, "DDS")
    if kind == "dds_bc4":
        return tf.dds(W, H, DDPF_FOURCC, b"ATI1", body=tf.bc4(mask))
    return tf.psd([_bits(mask > 0)], 0, 1, 1, width=W)


def make_capture(root: str) -> None:
    """A 16-view 96^2 COLMAP capture whose i-th frame is in FRAME_KINDS[i %
    12] (renamed in images.bin), its mask in MASK_KINDS[i % 4] under the
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
    """The committed capture fixtures/colmap_textures (frames in the twelve
    forms chip_smoke's phase 14 (i) trains on; PSD grey, DDS L, DDS BC4
    and PSD bitmap masks): JAX's COLMAP provider (Pillow) and the port's
    (Pillow blocked) load equal images, masks, poses and intrinsics.  A
    bitmap mask is "1": both packages take its 0/1 as the alpha byte, so
    those views' alpha is 0 or 1."""
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
    assert alphas == {1, 255}          # the bitmap masks' views, the rest
    names = sorted(os.listdir(CAPTURE / "images"))
    assert {n.rsplit(".", 1)[1] for n in names} == {
        "dds", "ftc", "blp", "psd", "dib"}


# ------------------------------------------------------- committed fixtures
def is_mine(rel: str) -> bool:
    return rel.startswith(("formats/dds/", "formats/ftex/", "formats/blp/",
                           "formats/psd/", "formats/dib/",
                           "colmap_textures/"))


def committed() -> list:
    out = sorted(CASES)
    for d in ("images", "mask"):
        out += [str(p.relative_to(FIXTURES))
                for p in sorted((CAPTURE / d).iterdir())]
    return out


def write_fixtures() -> None:
    """Writes every case, the capture fixtures/colmap_textures/ and their
    entries in fixtures/formats.json; the other modules' entries stay."""
    import tempfile
    hashes = json.loads(FORMAT_HASHES.read_text())
    for k in [k for k in hashes if is_mine(k)]:
        del hashes[k]
    for d in ("dds", "ftex", "blp", "psd", "dib"):
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
    assert len([f for f in files if f.startswith("colmap_textures/")]) == 32
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


def test_reader_imports_no_pillow():
    """The readers decode committed files in a process where Pillow cannot
    be imported, and leave no PIL module loaded."""
    rels = ["formats/dds/dx10_bc7_unorm_modes.dds",
            "formats/dds/dx10_bc6h_sf16_modes.dds", "formats/dds/rgb565.dds",
            "formats/ftex/dxt1.ftc", "formats/blp/blp1_jpeg_cmyk.blp",
            "formats/blp/blp2_dxt5.blp", "formats/psd/cmyk_packbits.psd",
            "formats/dib/pillow_p.dib"]
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
