"""The image forms the port reads since ROADMAP A6 (g) and the rest of (i)
against Pillow 12.1.0, on the CPU: arithmetic-coded (sequential and
progressive, with restarts and DAC conditioning), lossless, YCCK, 4:4:0,
4:1:1 and other-ratio JPEG; JPEG-compressed (YCbCr and as stored), Big,
fill-order-2, associated-alpha, signed, float, 12-bit, CMYK, CIELab and
YCbCr TIFF; netpbm (P1-P6 plain and raw, every maxval, PFM), TGA and QOI.

The oracle is ``np.asarray(Image.open(p))``, the array the JAX package's
providers see: every case must give its dtype, shape and bytes exactly
(floats compared by their bits, since a byte-swapped float may be NaN).
Pillow writes some of the files; the rest come from the writers here and
from nerf2mesh_tpu_torch/tools/jpeg_forms.py (the QM encoder of jcarith.c,
the lossless and any-sampling JPEG writers).  An arithmetic file must
decode in Pillow to the array of the Huffman file of the same
coefficients, which holds the writer to libjpeg before the decoder is
held to Pillow.  What Pillow refuses, the port refuses with ValueError.
The port's side runs with Pillow blocked in sys.modules.  The committed
files under nerf2mesh_tpu_torch/fixtures/formats/{jpeg,tiff,netpbm,tga,qoi}
and the COLMAP capture fixtures/colmap_forms (written by ``python
tests/test_torch_imageforms.py``) hash to Pillow's arrays in
fixtures/formats.json, and one file of each writer is written again here
byte for byte.
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
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu_torch.data import png
from nerf2mesh_tpu_torch.tools.jpeg_forms import abbreviated, encode_forms

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "nerf2mesh_tpu_torch" / "fixtures"
FORMAT_HASHES = FIXTURES / "formats.json"
# the COLMAP capture chip_smoke.py's phase 14 (f) trains on
CAPTURE = FIXTURES / "colmap_forms"
CAPTURE_KINDS = ["jpeg_arith", "jpeg_arith_progressive", "jpeg_440",
                 "jpeg_411", "jpeg_lossless", "tiff_jpeg_ycbcr", "bigtiff",
                 "ppm", "tga_rle", "qoi"]
MASK_KINDS = ["pgm", "qoi"]
EXT = {"jpeg": "jpg", "tiff": "tif", "bigtiff": "tif", "netpbm": "pnm",
       "ppm": "ppm", "pgm": "pgm", "tga": "tga", "qoi": "qoi"}


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
    """SHA-256 of an array's values (bool as 0/1), its dtype and shape."""
    a = np.asarray(a)
    v = a.astype(np.uint8) if a.dtype == bool else a
    return {"sha256": hashlib.sha256(np.ascontiguousarray(v).tobytes())
            .hexdigest(), "dtype": str(a.dtype), "shape": list(a.shape)}


def assert_same(got: np.ndarray, want: np.ndarray, name: str) -> None:
    assert sha(got) == sha(want), (name, got.dtype, got.shape, want.dtype,
                                   want.shape)


def pillow_bytes(img: np.ndarray, fmt: str, mode=None, **kw) -> bytes:
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def picture(h=29, w=37, seed=0) -> dict:
    """A smooth RGB picture with noise, an alpha ramp and palette indices."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 4 % 256], -1).astype(np.int32)
    rgb = np.clip(rgb + rng.integers(-20, 21, rgb.shape), 0, 255).astype(
        np.uint8)
    alpha = ((xx * 7 + yy * 5) % 256).astype(np.uint8)
    return {"rgb": rgb, "grey": rgb.mean(-1).astype(np.uint8),
            "rgba": np.concatenate([rgb, alpha[..., None]], -1),
            "index": rng.integers(0, 40, (h, w)).astype(np.uint8)}


def ycc(rgb: np.ndarray) -> list:
    """JFIF's RGB -> YCbCr planes (float; the writer rounds)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]


# --------------------------------------------------------------------- JPEG
S444, S420 = [(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)]
S440, S411 = [(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)]


def jpeg_cases() -> dict:
    im = picture()
    P = ycc(im["rgb"])
    R = [im["rgb"][..., i] for i in range(3)]
    K = ((np.arange(29)[:, None] * 9 + np.arange(37)) % 256).astype(
        np.uint8)
    return {
        "arith_444": encode_forms(P, S444, coding="arith"),
        "arith_420_restart_dac": encode_forms(P, S420, coding="arith",
                                              restart=3, dac=((1, 3), 3)),
        "arith_grey": encode_forms(P[:1], coding="arith", quality=90),
        "arith_progressive_420": encode_forms(P, S420, coding="arith",
                                              progressive=True),
        "arith_progressive_444_restart": encode_forms(
            P, S444, coding="arith", progressive=True, restart=4,
            quality=90),
        "arith_progressive_grey_restart": encode_forms(
            P[:1], coding="arith", progressive=True, restart=7),
        "arith_progressive_440_dac": encode_forms(
            P, S440, coding="arith", progressive=True, dac=((0, 2), 8)),
        "huffman_440": encode_forms(P, S440),
        "huffman_411": encode_forms(P, S411),
        "huffman_2x2_1x2": encode_forms(P, [(2, 2), (1, 2), (1, 2)]),
        "huffman_4x2": encode_forms(P, [(4, 2), (1, 1), (1, 1)]),
        "arith_411_restart": encode_forms(P, S411, coding="arith",
                                          restart=2),
        "ycck": encode_forms(P + [K], marker="adobe2"),
        "ycck_420": encode_forms(P + [K], [(2, 2), (1, 1), (1, 1), (2, 2)],
                                 marker="adobe2"),
        "ycck_arith": encode_forms(P + [K], coding="arith", marker="adobe2"),
        "cmyk_adobe0": encode_forms(R + [K], marker="adobe0"),
        "rgb_adobe0": encode_forms(R, marker="adobe0"),
        "lossless_rgb_p1": encode_forms(R, coding="lossless",
                                        marker="adobe0"),
        "lossless_rgb_p4_restart": encode_forms(
            R, coding="lossless", marker="adobe0", predictor=4, restart=5),
        "lossless_rgb_p7_pt2": encode_forms(R, coding="lossless", marker=None,
                                            predictor=7, pt=2),
        "lossless_grey_p5": encode_forms(P[:1], coding="lossless",
                                         predictor=5),
        "lossless_grey_p6_restart": encode_forms(
            P[:1], coding="lossless", predictor=6, restart=3),
        "lossless_rgb_420_p3": encode_forms(R, S420, coding="lossless",
                                            marker="adobe0", predictor=3),
        "lossless_rgb_440_p2": encode_forms(R, S440, coding="lossless",
                                            marker="adobe0", predictor=2),
        "lossless_cmyk": encode_forms(R + [K], coding="lossless",
                                      marker="adobe0"),
    }


def refused_jpeg_cases() -> dict:
    im = picture(16, 16)
    P = ycc(im["rgb"])
    base = encode_forms(P, S444)
    sof = base.index(b"\xff\xc0")
    (n,) = struct.unpack(">H", base[sof + 2:sof + 4])
    dnl = bytearray(base)
    dnl[sof + 5:sof + 7] = b"\0\0"              # the height left to DNL
    return {
        "12bit": encode_forms(P, precision=12, sof=0xFFC1),
        # a DHP segment (the frame's size), then a differential frame
        "hierarchical": base[:2] + b"\xff\xde" + base[sof + 2:sof + 2 + n]
        + base[2:sof] + b"\xff\xc5" + base[sof + 2:],
        "arith_lossless": encode_forms(P, coding="lossless", sof=0xFFCB),
        "lossless_ycbcr": encode_forms(P, coding="lossless"),
        "lossless_ycck": encode_forms(P + [P[0]], coding="lossless",
                                      marker="adobe2"),
        "dnl_height": bytes(dnl),
        "sampling_3x1": encode_forms(P, [(3, 1), (2, 1), (1, 1)]),
        "lossless_restart_mid_row": encode_forms(
            P, coding="lossless", marker="adobe0", restart=2)
        .replace(b"\xff\xdd\x00\x04\x00\x20", b"\xff\xdd\x00\x04\x00\x07"),
    }


# --------------------------------------------------------------------- TIFF
_FMT = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                     np.uint8)


def tiff_layout(chunks, tags, bo="<", big=False, tiled=False) -> bytes:
    """A one-page TIFF (a BigTIFF with big=True) of the strips or tiles
    `chunks` and the tags {tag: (type, values)}; the offsets and byte
    counts are filled in."""
    head = 16 if big else 8
    body, offsets = bytearray(), []
    for c in chunks:
        offsets.append(head + len(body))
        body += c + b"\0" * (len(c) % 2)
    tags = dict(tags)
    ot = 16 if big else 4
    tags[324 if tiled else 273] = (ot, offsets)
    tags[325 if tiled else 279] = (ot, [len(c) for c in chunks])
    esz, csz, nsz = (20, 8, 8) if big else (12, 4, 2)
    ifd_at = head + len(body)
    ext = ifd_at + nsz + esz * len(tags) + csz
    entries, blobs = b"", b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if typ == 7:
            blob, count = bytes(vals), len(vals)
        else:
            blob = struct.pack(f"{bo}{len(vals)}{_FMT[typ]}", *vals)
            count = len(vals)
        if len(blob) <= csz:
            field = blob.ljust(csz, b"\0")
        else:
            field = struct.pack(bo + ("Q" if big else "I"), ext + len(blobs))
            blobs += blob + b"\0" * (len(blob) % 2)
        entries += struct.pack(bo + ("HHQ" if big else "HHI"), tag, typ,
                               count) + field
    ifd = (struct.pack(bo + ("Q" if big else "H"), len(tags)) + entries
           + b"\0" * csz + blobs)
    if big:
        hdr = (b"II+\0" if bo == "<" else b"MM\0+") + struct.pack(
            bo + "HHQ", 8, 0, ifd_at)
    else:
        hdr = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(
            bo + "I", ifd_at)
    return hdr + bytes(body) + ifd


def tiff_file(samples, photo, bo="<", comp=1, rps=None, extra=(), fmt=None,
              fill=1, big=False, bits=None, pred=1, more=None) -> bytes:
    """A strip TIFF of samples [H, W(, spp)] (any integer or float dtype),
    compression none (1), deflate (8) or PackBits (32773)."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    H, W, spp = s.shape
    rps = rps or H
    chunks = []
    for y in range(0, H, rps):
        rows = np.ascontiguousarray(s[y:y + rps])
        if pred == 3:                        # tif_predict.c fpDiff
            be = rows.astype(">f4").view(np.uint8).reshape(len(rows), W, 4)
            planes = be.transpose(0, 2, 1).reshape(len(rows), -1).astype(
                np.int64)
            planes[:, 1:] = (planes[:, 1:] - planes[:, :-1]) % 256
            raw = planes.astype(np.uint8).tobytes()
        else:
            raw = rows.astype(rows.dtype.newbyteorder(bo)).tobytes()
        c = {1: raw, 8: zlib.compress(raw, 9)}.get(comp)
        if comp == 32773:                    # literal runs of 128 bytes
            c = b"".join(bytes([len(raw[i:i + 128]) - 1]) + raw[i:i + 128]
                         for i in range(0, len(raw), 128))
        if fill == 2:
            c = _REVERSED[np.frombuffer(c, np.uint8)].tobytes()
        chunks.append(c)
    tags = {256: (4, [W]), 257: (4, [H]),
            258: (3, [bits or s.dtype.itemsize * 8] * spp),
            259: (3, [comp]), 262: (3, [photo]), 277: (3, [spp]),
            278: (4, [rps])}
    if extra:
        tags[338] = (3, list(extra))
    if fmt:
        tags[339] = (3, [fmt] * spp)
    if fill != 1:
        tags[266] = (3, [fill])
    if pred != 1:
        tags[317] = (3, [pred])
    tags.update(more or {})
    return tiff_layout(chunks, tags, bo, big)


def jpeg_tiff(planes, sampling, photo, rps=None, tiles=None) -> bytes:
    """A JPEG-compressed TIFF (compression 7): each strip or tile an
    abbreviated baseline stream, its tables in JPEGTables (347)."""
    H, W = planes[0].shape
    chunks, tables = [], b""
    if tiles:
        tw, th = tiles
        boxes = [(y, x) for y in range(0, H, th) for x in range(0, W, tw)]
    else:
        tw, th = W, rps
        boxes = [(y, 0) for y in range(0, H, rps)]
    for y, x in boxes:
        ps = [p[y:y + th, x:x + tw] for p in planes]
        if tiles:
            ps = [np.pad(p, ((0, th - p.shape[0]), (0, tw - p.shape[1])),
                         mode="edge") for p in ps]
        tables, image = abbreviated(encode_forms(ps, sampling, marker=None))
        chunks.append(image)
    tags = {256: (4, [W]), 257: (4, [H]), 258: (3, [8] * len(planes)),
            259: (3, [7]), 262: (3, [photo]), 277: (3, [len(planes)]),
            347: (7, tables)}
    if tiles:
        tags.update({322: (4, [tw]), 323: (4, [th])})
    else:
        tags[278] = (4, [rps])
    if photo == 6:
        tags[530] = (3, list(sampling[0]))
    return tiff_layout(chunks, tags, tiled=bool(tiles))


def ycbcr_tiff(planes, sub, rps, comp=8) -> bytes:
    """A subsampled YCbCr TIFF: data units of h x v Y samples, Cb and Cr."""
    h, v = sub
    H, W = planes[0].shape
    Hp, Wp = -(-H // v) * v, -(-W // h) * h
    Y, Cb, Cr = (np.pad(np.rint(p), ((0, Hp - H), (0, Wp - W)), mode="edge")
                 for p in planes)
    c = [np.rint(p.reshape(Hp // v, v, Wp // h, h).mean((1, 3)))
         for p in (Cb, Cr)]
    units = np.concatenate([Y.reshape(Hp // v, v, Wp // h, h)
                            .transpose(0, 2, 1, 3)
                            .reshape(Hp // v, Wp // h, h * v),
                            c[0][..., None], c[1][..., None]], -1)
    units = units.astype(np.uint8)
    chunks = [zlib.compress(units[y // v:(y + rps) // v].tobytes())
              for y in range(0, H, rps)]
    tags = {256: (4, [W]), 257: (4, [H]), 258: (3, [8, 8, 8]),
            259: (3, [comp]), 262: (3, [6]), 277: (3, [3]), 278: (4, [rps]),
            530: (3, [h, v])}
    return tiff_layout(chunks, tags)


def packed12(a: np.ndarray) -> bytes:
    """Rows of 12-bit samples, most significant bits first."""
    H, W = a.shape
    r = np.pad(a, ((0, 0), (0, W % 2))).reshape(H, -1, 2)
    b = np.stack([r[..., 0] >> 4, ((r[..., 0] & 15) << 4) | (r[..., 1] >> 8),
                  r[..., 1] & 255], -1).astype(np.uint8).reshape(H, -1)
    return b[:, :(W * 12 + 7) // 8].tobytes()


def tiff_cases() -> dict:
    im = picture(21, 19, seed=1)
    rgb, rgba, grey = im["rgb"], im["rgba"], im["grey"]
    rng = np.random.default_rng(3)
    s16 = rng.integers(-30000, 30000, grey.shape).astype(np.int16)
    f32 = (rng.standard_normal(grey.shape) * 100).astype(np.float32)
    i32 = rng.integers(-2 ** 31, 2 ** 31, grey.shape).astype(np.int32)
    P = ycc(rgb)
    g12 = rng.integers(0, 4096, grey.shape)
    t12 = {256: (4, [19]), 257: (4, [21]), 258: (3, [12]), 262: (3, [1]),
           277: (3, [1]), 278: (4, [21])}
    cmap = {320: (3, list(range(0, 65536, 256)) * 3)}
    cases = {
        "pillow_bigtiff": pillow_bytes(rgb, "TIFF", big_tiff=True),
        "bigtiff_deflate_strips": tiff_file(rgb, 2, comp=8, rps=8, big=True),
        "bigtiff_float": tiff_file(f32, 1, comp=8, fmt=3, big=True),
        "assoc_alpha": tiff_file(rgba, 2, extra=(1,)),
        "assoc_alpha_deflate_extra": tiff_file(
            np.concatenate([rgba, rgba[..., :1]], -1), 2, comp=8,
            extra=(1, 0)),
        "assoc_alpha_16_be": tiff_file(rgba.astype(np.uint16) * 257, 2, ">",
                                       comp=8, extra=(1,)),
        "fill2_grey_deflate": tiff_file(grey, 1, comp=8, fill=2, rps=5),
        "fill2_white_packbits": tiff_file(grey, 0, ">", comp=32773, fill=2),
        "fill2_rgb_raw": tiff_file(rgb, 2, ">", fill=2, rps=9),
        "fill2_grey16_raw": tiff_file(s16.view(np.uint16), 1, fill=2),
        "signed8": tiff_file(s16.astype(np.int8), 1, fmt=2),
        "signed16_le_deflate": tiff_file(s16, 1, comp=8, fmt=2),
        "signed16_be_raw": tiff_file(s16, 1, ">", fmt=2),
        "signed16_be_deflate": tiff_file(s16, 1, ">", comp=8, fmt=2),
        "signed32_be_packbits": tiff_file(i32, 1, ">", comp=32773, fmt=2),
        "unsigned32_le": tiff_file(i32.view(np.uint32), 1, comp=8),
        "float32_le": tiff_file(f32, 1, fmt=3, rps=7),
        "float32_be_raw": tiff_file(f32, 1, ">", fmt=3),
        "float32_be_deflate": tiff_file(f32, 1, ">", comp=8, fmt=3),
        "float32_white": tiff_file(f32, 0, fmt=3),
        "float32_predictor3_le": tiff_file(f32, 1, comp=8, fmt=3, pred=3,
                                           rps=10),
        "float32_predictor3_be": tiff_file(f32, 1, ">", comp=8, fmt=3,
                                           pred=3),
        "grey12": tiff_layout([packed12(g12)], {**t12, 259: (3, [1])}),
        "grey12_deflate": tiff_layout([zlib.compress(packed12(g12))],
                                      {**t12, 259: (3, [8])}),
        "cmyk": tiff_file(rgba, 5, comp=8),
        "cmyk16_be": tiff_file(rgba.astype(np.uint16) * 257, 5, ">"),
        "lab": tiff_file(rgb, 8, comp=32773),
        "palette_alpha": tiff_file(rgba[..., 2:], 3, comp=8, extra=(2,),
                                   more=cmap),
        "pillow_jpeg_rgb": pillow_bytes(rgb, "TIFF", compression="jpeg"),
        "pillow_jpeg_grey": pillow_bytes(grey, "TIFF", compression="jpeg",
                                         quality=90),
        "pillow_jpeg_ycbcr": pillow_bytes(rgb, "TIFF", "YCbCr",
                                          compression="jpeg"),
        "jpeg_ycbcr_420_strips": jpeg_tiff(P, S420, 6, rps=16),
        "jpeg_ycbcr_422_strips": jpeg_tiff(P, [(2, 1), (1, 1), (1, 1)], 6,
                                           rps=8),
        "jpeg_ycbcr_420_tiles": jpeg_tiff(P, S420, 6, tiles=(16, 16)),
        "jpeg_rgb_strips": jpeg_tiff([rgb[..., i] for i in range(3)], None,
                                     2, rps=8),
        "pillow_ycbcr_lzw": pillow_bytes(rgb, "TIFF", "YCbCr",
                                         compression="tiff_lzw"),
        "ycbcr_420_deflate": ycbcr_tiff(P, (2, 2), 8),
        "ycbcr_422_packbits": ycbcr_tiff(P, (2, 1), 5, comp=8),
        # Pillow's own decoder reads 4 bytes a pixel of a raw YCbCr strip
        "ycbcr_raw_as_rgbx": tiff_file(rgb, 6, rps=4, more={
            530: (3, [1, 1]), 305: (7, b"a software tag" * 40)}),
    }
    return cases


def refused_tiff_cases() -> dict:
    im = picture(8, 6, seed=2)
    rgb, grey = im["rgb"], im["grey"]
    return {
        "bigtiff_big_endian": tiff_file(rgb, 2, ">", big=True),
        "fill2_grey16_be": tiff_file(grey.astype(np.uint16), 1, ">", fill=2),
        "fill2_white_raw": tiff_file(grey, 0, fill=2),
        "unsigned32_be": tiff_file(grey.astype(np.uint32), 1, ">"),
        "grey_assoc_alpha": tiff_file(im["rgba"][..., :2], 1, extra=(1,)),
        # Pillow's raw YCbCr: its strip ends the file, 3 bytes short a pixel
        "ycbcr_raw_past_the_end": pillow_bytes(rgb, "TIFF", "YCbCr"),
    }


# ------------------------------------------------------------------- netpbm
def plain(magic: str, vals, W, H, maxval=None) -> bytes:
    """A plain netpbm: comments in the header and between the samples."""
    out = f"{magic}\n# a comment\n{W} {H}\n".encode()
    if maxval is not None:
        out += f"{maxval}\n".encode()
    toks = [str(int(v)) for v in np.asarray(vals).reshape(-1)]
    lines = [" ".join(toks[i:i + 7]) for i in range(0, len(toks), 7)]
    lines.insert(2, "#a comment among the samples")
    return out + "\n".join(lines).encode() + b"\n"


def raw_pnm(magic: str, arr, maxval) -> bytes:
    H, W = arr.shape[:2]
    dt = np.uint8 if maxval < 256 else np.dtype(">u2")
    return (f"{magic}\n{W} {H}\n{maxval}\n".encode()
            + np.asarray(arr).astype(dt).tobytes())


def netpbm_cases() -> dict:
    im = picture(seed=4)
    rgb, grey = im["rgb"], im["grey"]
    H, W = grey.shape
    bits = (grey > 110).astype(int)
    return {
        "pillow_p4": pillow_bytes(grey, "PPM", "1"),
        "pillow_p5": pillow_bytes(grey, "PPM"),
        "pillow_p5_16": pillow_bytes(grey.astype(np.int32) * 200, "PPM"),
        "pillow_p6": pillow_bytes(rgb, "PPM"),
        "pillow_pfm": pillow_bytes(grey.astype(np.float32) / 7, "PPM"),
        "p1": plain("P1", bits, W, H),
        "p1_packed": f"P1\n{W} {H}\n".encode() + b"".join(
            bytes(b"01"[v] for v in row) + b"\n" for row in bits),
        "p2_255": plain("P2", grey, W, H, 255),
        "p2_15": plain("P2", grey // 17, W, H, 15),
        "p2_1000": plain("P2", grey.astype(int) * 3, W, H, 1000),
        "p3_100": plain("P3", rgb.astype(int) * 100 // 255, W, H, 100),
        "p3_4095": plain("P3", rgb.astype(int) * 16, W, H, 4095),
        "p5_100": raw_pnm("P5", grey.astype(int) * 100 // 255, 100),
        "p5_1000": raw_pnm("P5", grey.astype(int) * 3, 1000),
        "p5_65535": raw_pnm("P5", grey.astype(int) * 257, 65535),
        "p6_63": raw_pnm("P6", rgb // 4, 63),
        "p6_1023": raw_pnm("P6", rgb.astype(int) * 4, 1023),
        "p6_65535": raw_pnm("P6", rgb.astype(int) * 257, 65535),
        "p6_above_maxval": raw_pnm("P6", np.full((3, 4, 3), 200), 100),
        "pfm_big_endian": f"Pf\n{W} {H}\n1.0\n".encode()
        + grey.astype(">f4").tobytes(),
        "header_comment_in_token": f"P5\n3#x\n7 {H}\n255\n".encode()
        + grey.tobytes(),
        "pillow_pyp": raw_pnm("PyP", im["index"], 255),
        "pillow_p0cmyk": raw_pnm("P0CMYK", im["rgba"], 255),
    }


def refused_netpbm_cases() -> dict:
    return {
        "pam_p7": (b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\n"
                   b"TUPLTYPE GRAYSCALE\nENDHDR\n" + bytes(4)),
        "plain_above_maxval": plain("P2", np.full((3, 3), 200), 3, 3, 100),
        "plain_short": b"P2\n3 3\n255\n1 2 3\n",
    }


# ---------------------------------------------------------------------- TGA
def tga_file(itype, depth, pix: bytes, W, H, flags=0x20, cmap=None,
             ident=b"") -> bytes:
    """A TGA: header, image id, colour map (start, entries, bits) of zero
    entries, and the pixel bytes as given."""
    hdr = bytes([len(ident), 1 if cmap else 0, itype])
    hdr += struct.pack("<HHB", *cmap) if cmap else bytes(5)
    hdr += struct.pack("<HHHHBB", 0, 0, W, H, depth, flags)
    return hdr + ident + (bytes(cmap[1] * cmap[2] // 8) if cmap else b"") + pix


def tga_rle(px: np.ndarray) -> bytes:
    """TGA RLE of [H, W, bytes] pixels in stored order: runs inside a row,
    literals that may go on into the next row."""
    H, W, nb = px.shape
    flat = px.reshape(-1, nb)
    out, i, n = bytearray(), 0, len(flat)
    while i < n:
        end = (i // W + 1) * W
        j = i
        while j + 1 < end and j - i < 127 and (flat[j + 1] == flat[i]).all():
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + flat[i].tobytes()
            i = j + 1
            continue
        k = i
        while (k + 1 < n and k - i < 127
               and not (k + 2 < n and (flat[k + 2] == flat[k + 1]).all()
                        and (k + 1) // W == (k + 2) // W)):
            k += 1
        out += bytes([k - i]) + flat[i:k + 1].tobytes()
        i = k + 1
    return bytes(out)


def tga_cases() -> dict:
    im = picture(seed=5)
    rgb, rgba = im["rgb"], im["rgba"]
    H, W = im["grey"].shape
    rng = np.random.default_rng(6)
    p16 = rng.integers(0, 65536, (H, W)).astype("<u2")
    blocky = np.repeat(np.repeat(rgba[::3, ::3], 3, 0), 3, 1)[:H, :W]
    cases = {}
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
        src = rgba if mode in ("LA", "RGBA") else rgb
        for rle, orient in ((False, 1), (True, -1)):
            if rle and mode == "1":
                continue
            kw = dict(orientation=orient)
            if rle:
                kw["compression"] = "tga_rle"
            name = (f"pillow_{mode.lower()}_{'rle' if rle else 'raw'}_"
                    f"{'top' if orient == 1 else 'bottom'}")
            cases[name] = pillow_bytes(src, "TGA", mode, **kw)
    cases["pillow_rgb_raw_bottom"] = pillow_bytes(rgb, "TGA",
                                                  orientation=-1)
    for flags in (0x00, 0x10, 0x20, 0x30):
        cases[f"a1r5g5b5_{flags:02x}"] = tga_file(2, 16, p16.tobytes(), W,
                                                  H, flags)
    cases.update({
        "bgra_id": tga_file(2, 32, rgba[..., [2, 1, 0, 3]].tobytes(), W, H,
                            0x30, ident=b"an image id"),
        "cmap24_start": tga_file(1, 8, im["index"].tobytes(), W, H,
                                 cmap=(5, 40, 24)),
        "cmap16": tga_file(1, 8, im["index"].tobytes(), W, H, 0x00,
                           cmap=(0, 40, 16)),
        "grey1": tga_file(3, 1, np.packbits(im["grey"] > 99, axis=1)
                          .tobytes(), W, H),
        "rle_bgra_bottom": tga_file(10, 32, tga_rle(blocky[::-1]), W, H,
                                    0x00),
        "rle_a1r5g5b5_mirrored": tga_file(10, 16, tga_rle(
            np.repeat(p16[:, :13], 3, 1)[:, :W].copy().view(np.uint8)
            .reshape(H, W, 2)), W, H, 0x30),
        "rle_cmap_literals_across_rows": tga_file(
            9, 8, tga_rle(im["index"][..., None]), W, H, 0x10,
            cmap=(0, 40, 24)),
        "rle_grey_alpha": tga_file(11, 16, tga_rle(
            np.repeat(rgba[:, ::4, 2:], 4, 1)[:, :W].copy()), W, H),
    })
    return cases


def refused_tga_cases() -> dict:
    idx = picture(6, 5, seed=7)["index"]
    return {
        "rle_run_across_rows": tga_file(11, 8, bytes([0x85, 7, 0x85, 9,
                                                      0x85, 3, 0x85, 5,
                                                      0x85, 1]), 5, 6),
        "cmap32": tga_file(1, 8, idx.tobytes(), 5, 6, cmap=(0, 40, 32)),
        "cmap15": tga_file(1, 8, idx.tobytes(), 5, 6, cmap=(0, 40, 15)),
        "palette_without_map": tga_file(1, 8, idx.tobytes(), 5, 6),
    }


# ---------------------------------------------------------------------- QOI
def qoi_encode(img: np.ndarray, channels: int) -> bytes:
    """The QOI reference encoder (qoi.h): run, index, diff, luma, RGB and
    RGBA operations."""
    H, W, C = img.shape
    out = bytearray(b"qoif" + struct.pack(">IIBB", W, H, channels, 0))
    index = [(0, 0, 0, 0)] * 64
    prev, run = (0, 0, 0, 255), 0
    flat = img.reshape(-1, C).tolist()
    for i, p in enumerate(flat):
        px = tuple(p) + ((255,) if C == 3 else ())
        if px == prev:
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64
        if index[h] == px:
            out.append(h)
        else:
            index[h] = px
            if px[3] == prev[3]:
                vr, vg, vb = ((px[k] - prev[k] + 128) % 256 - 128
                              for k in range(3))
                gr, gb = vr - vg, vb - vg
                if -2 <= vr <= 1 and -2 <= vg <= 1 and -2 <= vb <= 1:
                    out.append(0x40 | (vr + 2) << 4 | (vg + 2) << 2 | vb + 2)
                elif -8 <= gr <= 7 and -32 <= vg <= 31 and -8 <= gb <= 7:
                    out += bytes([0x80 | (vg + 32), (gr + 8) << 4 | gb + 8])
                else:
                    out += bytes([0xFE]) + bytes(px[:3])
            else:
                out += bytes([0xFF]) + bytes(px)
        prev = px
    return bytes(out) + bytes(7) + b"\x01"


def qoi_cases() -> dict:
    im = picture(seed=8)
    rgb, rgba = im["rgb"], im["rgba"]
    smooth = np.repeat(np.repeat(rgba[::4, ::4], 4, 0), 4, 1)[:29, :37]
    hdr = b"qoif" + struct.pack(">IIBB", 4, 1, 4, 0)
    h0 = (255 * 11) % 64                  # the hash of (0, 0, 0, 255)
    return {
        "pillow_rgb": pillow_bytes(rgb, "QOI"),
        "pillow_rgba": pillow_bytes(rgba, "QOI"),
        "rgb_ops": qoi_encode(rgb // 3 * 3, 3),
        "rgba_runs_index": qoi_encode(smooth, 4),
        "rgb_from_rgba_runs": qoi_encode(smooth[..., :3].copy(), 3),
        # a run from the start pixel enters no index entry in Pillow's
        # decoder, so the index op after it reads (0, 0, 0, 0)
        "run_then_unwritten_index": hdr + bytes([0xC1, h0, 0xFE, 9, 8, 7])
        + bytes(7) + b"\x01",
    }


def refused_qoi_cases() -> dict:
    return {"truncated": qoi_encode(picture(5, 5)["rgb"], 3)[:-20]}


# ------------------------------------------------------------ all the cases
CASES = {"jpeg": jpeg_cases(), "tiff": tiff_cases(),
         "netpbm": netpbm_cases(), "tga": tga_cases(), "qoi": qoi_cases()}
REFUSED = {"jpeg": refused_jpeg_cases(), "tiff": refused_tiff_cases(),
           "netpbm": refused_netpbm_cases(), "tga": refused_tga_cases(),
           "qoi": refused_qoi_cases()}
ALL = sorted((k, n) for k, cases in CASES.items() for n in cases)


def fixture_name(kind: str, name: str) -> str:
    """The committed file of a case; this module's TIFF files are named
    forms_* beside tests/test_torch_imageio.py's."""
    prefix = "forms_" if kind == "tiff" else ""
    return f"formats/{kind}/{prefix}{name}.{EXT[kind]}"


def is_mine(rel: str) -> bool:
    """Whether a formats.json entry is one of this module's files."""
    parts = rel.split("/")
    return parts[0] == "colmap_forms" or (
        parts[0] == "formats" and parts[1] in CASES
        and (parts[1] != "tiff" or parts[2].startswith("forms_")))


@pytest.mark.parametrize("kind,name", ALL)
def test_reads_as_pillow(kind, name, tmp_path):
    data = CASES[kind][name]
    assert_same(port_array(data, tmp_path, f"{name}.{EXT[kind]}"),
                pillow_array(data), f"{kind}/{name}")


@pytest.mark.parametrize("kind,name", sorted(
    (k, n) for k, cases in REFUSED.items() for n in cases))
def test_refused_as_pillow_refuses(kind, name, tmp_path):
    """Pillow cannot read the bytes (open or load raises), and the port
    raises ValueError on them."""
    data = REFUSED[kind][name]
    with pytest.raises(Exception):
        pillow_array(data)
    with pytest.raises(ValueError):
        port_array(data, tmp_path, f"{name}.{EXT[kind]}")


@pytest.mark.parametrize("name,sampling,quality", [
    ("arith_444", S444, 75), ("arith_420_restart_dac", S420, 75),
    ("arith_progressive_420", S420, 75),
    ("arith_progressive_444_restart", S444, 90),
    ("arith_progressive_440_dac", S440, 75), ("arith_411_restart", S411, 75)])
def test_arithmetic_file_holds_the_huffman_files_coefficients(
        name, sampling, quality):
    """The writer's check: an arithmetic-coded file decodes, in Pillow's
    libjpeg-turbo, to the array of the baseline Huffman file of the same
    quantized coefficients."""
    P = ycc(picture()["rgb"])
    want = pillow_array(encode_forms(P, sampling, quality=quality))
    np.testing.assert_array_equal(pillow_array(CASES["jpeg"][name]), want)


def test_tiff_jpeg_tables_reach_the_decoder():
    """A JPEG-compressed TIFF's strips carry no tables of their own: the
    decoder reads them from JPEGTables first, and a strip alone is
    refused."""
    from nerf2mesh_tpu_torch.data.jpeg import (COLOUR_YCBCR,
                                               decode_jpeg_tables)
    P = ycc(picture(16, 16)["rgb"])
    full = encode_forms(P, S420, marker=None)
    tables, image = abbreviated(full)
    assert b"\xff\xdb" not in image and b"\xff\xc4" not in image
    np.testing.assert_array_equal(
        decode_jpeg_tables(tables, image, COLOUR_YCBCR), pillow_array(full))
    with pytest.raises(ValueError):
        decode_jpeg_tables(b"", image, COLOUR_YCBCR)


# ------------------------------------------------------- a capture in these
def encode_frame(img: np.ndarray, kind: str) -> bytes:
    """A capture's frame (RGB) or mask ([H, W]) in one of the forms."""
    rgb = img if img.ndim == 3 else None
    P = ycc(rgb) if rgb is not None else None
    R = [rgb[..., i] for i in range(3)] if rgb is not None else None
    if kind == "pgm":
        return raw_pnm("P5", img, 255)
    if kind == "qoi":
        return qoi_encode(img if rgb is not None else
                          np.repeat(img[..., None], 3, -1), 3)
    return {
        "jpeg_arith": lambda: encode_forms(P, S420, coding="arith",
                                           quality=90),
        "jpeg_arith_progressive": lambda: encode_forms(
            P, S420, coding="arith", progressive=True, restart=6,
            quality=90),
        "jpeg_440": lambda: encode_forms(P, S440, quality=90),
        "jpeg_411": lambda: encode_forms(P, S411, quality=90),
        "jpeg_lossless": lambda: encode_forms(R, coding="lossless",
                                              marker="adobe0", predictor=7),
        "tiff_jpeg_ycbcr": lambda: jpeg_tiff(P, S420, 6, rps=32),
        "bigtiff": lambda: tiff_file(rgb, 2, comp=8, rps=32, big=True),
        "ppm": lambda: raw_pnm("P6", rgb, 255),
        "tga_rle": lambda: tga_file(10, 24, tga_rle(
            rgb[::-1, :, ::-1].copy()), rgb.shape[1], rgb.shape[0], 0x00),
    }[kind]()


def reencode_capture(root: str) -> None:
    """Rewrites a COLMAP capture's frames, the i-th in CAPTURE_KINDS[i %
    10], renaming them in images.bin, and adds a mask a frame, PGM and QOI
    in turn, under the name the providers look for (mask/<stem>.png: both
    packages read a file by its content)."""
    import dataclasses
    from nerf2mesh_tpu_torch.data import colmap_utils as tcu
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
        name = f"{stem}.{EXT[kind.split('_')[0]]}"
        Path(root, "images", name).write_bytes(encode_frame(rgb, kind))
        os.remove(src)
        ims[k] = dataclasses.replace(im, name=name)
        mask = ((rgb.astype(int).sum(-1) > 60) * 255).astype(np.uint8)
        Path(root, "mask", stem + ".png").write_bytes(
            encode_frame(mask, MASK_KINDS[i % 2]))
    tcu.write_images_binary(ims, sp)


def make_capture(root: str) -> None:
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    generate_colmap_dataset(root, H=96, W=96, n_images=16, n_points=400)
    reencode_capture(root)


def test_capture_loads_as_jax(tmp_path):
    """The committed capture fixtures/colmap_forms (frames in the ten forms
    chip_smoke's phase 14 (f) trains on, PGM and QOI masks): JAX's COLMAP
    provider (Pillow) and the port's (Pillow blocked) load equal images,
    masks, poses and intrinsics."""
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
    assert {n.rsplit(".", 1)[1] for n in names} == {"jpg", "tif", "ppm",
                                                     "tga", "qoi"}


# ------------------------------------------------------- committed fixtures
def committed() -> list:
    """The paths under fixtures/ of every committed file this module
    writes: the cases and the capture's frames and masks."""
    out = [fixture_name(k, n) for k, n in ALL]
    for d in ("images", "mask"):
        out += [str(p.relative_to(FIXTURES))
                for p in sorted((CAPTURE / d).iterdir())]
    return out


def write_fixtures() -> None:
    """Writes fixtures/formats/{jpeg,tiff,netpbm,tga,qoi}/ (every case
    above; the TIFF files as forms_*), the COLMAP capture
    fixtures/colmap_forms/ and their entries in fixtures/formats.json,
    Pillow's hash of each image (paths relative to fixtures/); the entries
    of tests/test_torch_imageio.py stay."""
    hashes = json.loads(FORMAT_HASHES.read_text())
    for k in [k for k in hashes if is_mine(k)]:
        (FIXTURES / k).unlink(missing_ok=True)
        del hashes[k]
    for k, n in ALL:
        path = FIXTURES / fixture_name(k, n)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(CASES[k][n])
        hashes[fixture_name(k, n)] = sha(pillow_array(CASES[k][n]))
    shutil.rmtree(CAPTURE, ignore_errors=True)
    make_capture(str(CAPTURE))
    for d in ("images", "mask"):
        for p in sorted((CAPTURE / d).iterdir()):
            hashes[str(p.relative_to(FIXTURES))] = sha(
                pillow_array(p.read_bytes()))
    FORMAT_HASHES.write_text(json.dumps(dict(sorted(hashes.items())),
                                        indent=1) + "\n")


def test_committed_files_hash_to_pillow(tmp_path):
    """Every committed file of this module (the cases and the capture's
    frames and masks) hashes to Pillow's array in formats.json, and the
    port reads each to the same hash."""
    want = json.loads(FORMAT_HASHES.read_text())
    files = committed()
    assert set(files) == {k for k in want if is_mine(k)}
    assert len([f for f in files if f.startswith("colmap_forms/")]) == 32
    for rel in files:
        data = (FIXTURES / rel).read_bytes()
        assert sha(pillow_array(data)) == want[rel], rel
        assert sha(port_array(data, tmp_path, rel.replace("/", "_"))) == \
            want[rel], rel


@pytest.mark.parametrize("kind,name", [
    ("jpeg", "arith_progressive_420"), ("jpeg", "lossless_rgb_p4_restart"),
    ("jpeg", "ycck_420"), ("tiff", "jpeg_ycbcr_420_tiles"),
    ("tiff", "bigtiff_deflate_strips"), ("netpbm", "p3_4095"),
    ("tga", "rle_cmap_literals_across_rows"), ("qoi", "rgba_runs_index")])
def test_writers_reproduce_the_committed_bytes(kind, name):
    """One file of each writer, written again, equals the committed one."""
    assert (FIXTURES / fixture_name(kind, name)).read_bytes() == \
        CASES[kind][name]


def test_capture_writer_reproduces_a_frame(tmp_path):
    """The capture's writer gives the committed frame and mask bytes again
    from the same synthetic frame (frames 0-3: arithmetic baseline and
    progressive, 4:4:0 and 4:1:1 JPEG; PGM and QOI masks)."""
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    root = tmp_path / "c"
    generate_colmap_dataset(str(root), H=96, W=96, n_images=16, n_points=400)
    names = sorted(os.listdir(root / "images"))[:4]
    for i, n in enumerate(names):
        with Image.open(root / "images" / n) as f:
            rgb = np.asarray(f.convert("RGB"))
        stem = os.path.splitext(n)[0]
        assert encode_frame(rgb, CAPTURE_KINDS[i]) == (
            CAPTURE / "images" / f"{stem}.jpg").read_bytes(), n
        mask = ((rgb.astype(int).sum(-1) > 60) * 255).astype(np.uint8)
        assert encode_frame(mask, MASK_KINDS[i % 2]) == (
            CAPTURE / "mask" / f"{stem}.png").read_bytes(), n


def test_readers_import_no_pillow():
    """Every reader module of the port decodes a committed file of its
    format in a process where Pillow cannot be imported, and leaves no
    PIL module loaded."""
    picks = {"jpeg": "arith_progressive_420", "tiff": "jpeg_ycbcr_420_tiles",
             "netpbm": "p2_1000", "tga": "rle_bgra_bottom",
             "qoi": "rgba_runs_index"}
    paths = [str(FIXTURES / fixture_name(k, n)) for k, n in picks.items()]
    code = f"""
import sys
sys.modules["PIL"] = None
from nerf2mesh_tpu_torch.data import (bmp, gif, imgdec, jpeg, netpbm, png,
                                      qoi, tga, tiff, webp)
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
