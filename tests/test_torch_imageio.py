"""The port's BMP, TIFF, GIF and WebP readers (data/bmp.py, data/tiff.py,
data/gif.py, data/webp.py, reached through data/png.read_image) against
Pillow, on the CPU.

The oracle is ``np.asarray(Image.open(p))``, the array the JAX package's
providers see: every case must give its dtype, shape and values exactly.
Files Pillow writes come from Pillow; the variants it does not write (BMP
palettes below 8 bits, 16-bit and BI_BITFIELDS pixels, RLE, OS/2 and
top-down rows; TIFF tiles, planar samples, big-endian files, PackBits and
the predictor; GIF local palettes and interlacing) come from small writers
here, and WebP encoder options Pillow's save does not pass on (the simple
loop filter, sharpness, segments, the ALPH chunk's filters and raw alpha)
from Pillow's own libwebp through ctypes, with Pillow's decode of the same
bytes as the oracle.  The port's
side runs with Pillow blocked in sys.modules.  The committed files under
nerf2mesh_tpu_torch/fixtures/formats (written by ``python
tests/test_torch_imageio.py``) still hash to Pillow's arrays.
"""

import contextlib
import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu_torch.data import png

FIXTURES = (Path(__file__).resolve().parent.parent / "nerf2mesh_tpu_torch"
            / "fixtures")


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


def assert_same(got: np.ndarray, want: np.ndarray, name: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (
        name, got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)


def pillow_bytes(img: np.ndarray, fmt: str, mode=None, **kw) -> bytes:
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def images(seed=0, h=29, w=37):
    """A smooth RGB picture with noise, its grey and an alpha ramp."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    (xx + yy) * 4 % 256], -1).astype(np.int32)
    rgb = np.clip(rgb + rng.integers(-20, 21, rgb.shape), 0, 255).astype(
        np.uint8)
    alpha = ((xx * 3 + yy * 5) % 256).astype(np.uint8)
    return {"rgb": rgb, "grey": rgb.mean(-1).astype(np.uint8),
            "rgba": np.concatenate([rgb, alpha[..., None]], -1),
            "index": rng.integers(0, 16, (h, w)).astype(np.uint8)}


# ---------------------------------------------------------------------- BMP
def bmp_file(rows, w, h, bits, comp=0, palette=None, masks=None, hsize=40,
             top_down=False):
    """A BMP of the given pixel rows (bytes each, top row first, unpadded;
    for RLE one stream of bytes) and header fields."""
    if comp in (1, 2):
        pix = rows
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        order = rows if top_down else rows[::-1]
        pix = b"".join(r.ljust(stride, b"\0") for r in order)
    pal = b""
    if palette is not None:
        entry = 3 if hsize == 12 else 4
        pal = b"".join(bytes([b, g, r]) + b"\0" * (entry - 3)
                       for r, g, b in palette)
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h,
                           1, bits, comp, len(pix), 2835, 2835,
                           len(palette or ()), 0)
        extra = b""
        if masks is not None and hsize >= 52:
            extra = struct.pack("<4I", *masks)
        head = (head + extra).ljust(hsize, b"\0")
        if masks is not None and hsize == 40:
            head += struct.pack("<3I", *masks[:3])
    off = 14 + len(head) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off) + head
            + pal + pix)


def pack_bits(idx: np.ndarray, bits: int) -> list:
    per = 8 // bits
    out = []
    for row in idx:
        row = np.concatenate([row, np.zeros((-len(row)) % per, np.uint8)])
        v = np.zeros(len(row) // per, np.uint16)
        for k in range(per):
            v = (v << bits) | row[k::per]
        out.append(v.astype(np.uint8).tobytes())
    return out


def rle8(idx: np.ndarray) -> bytes:
    """RLE8: an encoded run where a value repeats, an absolute run of the
    rest, an end of line a row and an end of bitmap (rows bottom-up)."""
    out = bytearray()
    for row in idx[::-1]:
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or len(row) - x < 3:
                out += bytes([n, row[x]])
                x += n
            else:
                m = min(len(row) - x, 255, 8)
                out += bytes([0, m]) + row[x:x + m].tobytes()
                if m % 2:
                    out += b"\0"
                x += m
        out += b"\0\0"
    return bytes(out[:-2] + b"\0\1")


def rle4(idx: np.ndarray) -> bytes:
    """RLE4: alternating-pair encoded runs and even absolute runs."""
    out = bytearray()
    for row in idx[::-1]:
        x = 0
        while x < len(row):
            if x + 4 <= len(row) and (x // 4) % 2 == 0:
                out += bytes([4, (row[x] << 4) | row[x + 1]])
                x += 4 - 2 * (row[x + 2] != row[x] or row[x + 3] != row[x + 1])
            else:
                m = min(len(row) - x, 6) & ~1
                if m < 2:
                    out += bytes([1, row[x] << 4])
                    x += 1
                    continue
                out += bytes([0, m]) + bytes(
                    (row[x + i] << 4) | row[x + i + 1] for i in range(0, m, 2))
                if (m // 2) % 2:
                    out += b"\0"
                x += m
        out += b"\0\0"
    return bytes(out[:-2] + b"\0\1")


def bmp_cases():
    im = images()
    rgb, idx = im["rgb"], im["index"]
    h, w = idx.shape
    rng = np.random.default_rng(5)
    pal16 = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(16)]
    pal256 = [tuple(int(v) for v in rng.integers(0, 256, 3))
              for _ in range(256)]
    bw = (idx > 7).astype(np.uint8)
    p16 = rng.integers(0, 65536, (h, w)).astype("<u2")
    rgba = im["rgba"]
    return {
        "pillow_1bit": pillow_bytes(im["grey"], "BMP", "1"),
        "pillow_grey": pillow_bytes(im["grey"], "BMP"),
        "pillow_p": pillow_bytes(rgb, "BMP", "P"),
        "pillow_rgb": pillow_bytes(rgb, "BMP"),
        "pillow_rgba": pillow_bytes(rgba, "BMP"),
        "pal1": bmp_file(pack_bits(bw, 1), w, h, 1,
                         palette=[(200, 10, 10), (10, 200, 10)]),
        "pal4": bmp_file(pack_bits(idx, 4), w, h, 4, palette=pal16),
        "pal8_top_down": bmp_file([r.tobytes() for r in idx * 16], w, h, 8,
                                  palette=pal256, top_down=True),
        "os2_pal8": bmp_file([r.tobytes() for r in idx], w, h, 8, hsize=12,
                             palette=pal256),
        "rle8": bmp_file(rle8(idx * 16), w, h, 8, comp=1, palette=pal256),
        "rle4": bmp_file(rle4(idx), w, h, 4, comp=2, palette=pal16),
        "rgb555": bmp_file([r.tobytes() for r in p16], w, h, 16),
        "rgb565_bitfields": bmp_file([r.tobytes() for r in p16], w, h, 16,
                                     comp=3, masks=(0xF800, 0x7E0, 0x1F, 0)),
        "bgra_bitfields_v4": bmp_file(
            [r[:, [2, 1, 0, 3]].tobytes() for r in rgba], w, h, 32, comp=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), hsize=108),
        "xbgr_bitfields": bmp_file(
            [r[:, [3, 2, 1, 0]].tobytes() for r in rgba], w, h, 32, comp=3,
            masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
        "bgrx_raw32": bmp_file([r[:, [2, 1, 0, 3]].tobytes() for r in rgba],
                               w, h, 32),
        "rgb24_top_down_v5": bmp_file([r[:, ::-1].tobytes() for r in rgb], w,
                                      h, 24, hsize=124, top_down=True),
    }


BMP_CASES = bmp_cases()


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_bmp_reads_as_pillow(case, tmp_path):
    data = BMP_CASES[case]
    assert_same(port_array(data, tmp_path, case + ".bmp"),
                pillow_array(data), case)


# --------------------------------------------------------------------- TIFF
def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW: a clear code, the codes (9-12 bits, MSB first; the
    encoder's table runs one entry ahead of a decoder's, so it widens at
    2^n entries where the decoder widens at 2^n - 1), a clear whenever the
    table fills, EOI."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc, nacc = (acc << width) | code, nacc + width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8

    table = {bytes([i]): i for i in range(256)}
    nxt, width, w = 258, 9, b""
    put(256, width)
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
        if nxt >= 4094:
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([c])
    if w:
        put(table[w], width)
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3+ equal bytes replicated, the rest literal."""
    out, i = bytearray(), 0
    while i < len(data):
        n = 1
        while i + n < len(data) and n < 128 and data[i + n] == data[i]:
            n += 1
        if n >= 3:
            out += bytes([(257 - n) & 255, data[i]])
            i += n
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_file(samples, photo, bo="<", bits=8, comp=1, pred=1, planar=1,
              tile=None, rps=None, extra=(), colormap=None):
    """A one-page TIFF of samples [H, W, spp] (values < 2^bits)."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    H, W, spp = s.shape
    dt = np.dtype(bo + "u2") if bits == 16 else np.dtype(np.uint8)
    planes = [s[..., i:i + 1] for i in range(spp)] if planar == 2 else [s]
    tw, th = tile if tile else (W, rps or H)
    chunks = []
    for p in planes:
        for y in range(0, H, th):
            for x in range(0, W, tw):
                blk = p[y:y + th, x:x + tw]
                if tile:
                    blk = np.pad(blk, ((0, th - blk.shape[0]),
                                       (0, tw - blk.shape[1]), (0, 0)))
                blk = blk.astype(np.int64)
                if pred == 2:
                    d = blk.copy()
                    d[:, 1:] = blk[:, 1:] - blk[:, :-1]
                    blk = d % (1 << bits)
                if bits < 8:
                    raw = b"".join(pack_bits(blk[..., 0].astype(np.uint8),
                                             bits))
                else:
                    raw = blk.astype(dt).tobytes()
                chunks.append({1: raw, 5: lzw_encode(raw), 8: zlib.compress(
                    raw), 32773: packbits_encode(raw)}[comp])
    tags = {256: (4, [W]), 257: (4, [H]), 258: (3, [bits] * spp),
            259: (3, [comp]), 262: (3, [photo]), 277: (3, [spp]),
            284: (3, [planar]), 317: (3, [pred])}
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    body = bytearray(b"\0" * 8)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\0" * (len(c) % 2)
    if tile:
        tags.update({322: (4, [tw]), 323: (4, [th]), 324: (4, offsets),
                     325: (4, [len(c) for c in chunks])})
    else:
        tags.update({278: (4, [th]), 273: (4, offsets),
                     279: (4, [len(c) for c in chunks])})
    ifd_at = len(body)
    n = len(tags)
    ext = ifd_at + 2 + 12 * n + 4
    entries, blobs = b"", b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        fmt = "H" if typ == 3 else "I"
        blob = struct.pack(f"{bo}{len(vals)}{fmt}", *vals)
        if len(blob) <= 4:
            field = blob.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", ext + len(blobs))
            blobs += blob
        entries += struct.pack(bo + "HHI", tag, typ, len(vals)) + field
    body += struct.pack(bo + "H", n) + entries + b"\0\0\0\0" + blobs
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "I",
                                                                ifd_at)
    return head + bytes(body[8:])


def tiff_cases():
    im = images()
    rgb, grey, rgba, idx = im["rgb"], im["grey"], im["rgba"], im["index"]
    deep = (grey.astype(np.uint16) * 257 + np.arange(grey.size).reshape(
        grey.shape) % 251).astype(np.uint16)
    cmap = list(range(0, 65536, 256)) * 3
    cases = {}
    for comp in ("tiff_lzw", "tiff_adobe_deflate", "packbits", "raw"):
        cases[f"pillow_rgb_{comp}"] = pillow_bytes(rgb, "TIFF",
                                                   compression=comp)
    cases.update({
        "pillow_rgb_lzw_predictor": pillow_bytes(
            rgb, "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "pillow_rgba_lzw": pillow_bytes(rgba, "TIFF", compression="tiff_lzw"),
        "pillow_grey_deflate_predictor": pillow_bytes(
            grey, "TIFF", compression="tiff_adobe_deflate",
            tiffinfo={317: 2}),
        "pillow_grey16_lzw_predictor": pillow_bytes(
            deep, "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "pillow_1bit_lzw": pillow_bytes(grey, "TIFF", "1",
                                        compression="tiff_lzw"),
        "pillow_p_lzw": pillow_bytes(rgb, "TIFF", "P", compression="tiff_lzw"),
        "pillow_la": pillow_bytes(rgba[..., [0, 3]], "TIFF"),
        "be_rgb_tiles_lzw": tiff_file(rgb, 2, ">", comp=5, tile=(16, 16)),
        "be_grey16_predictor_deflate": tiff_file(deep, 1, ">", 16, comp=8,
                                                 pred=2, rps=5),
        "le_grey16_tiles_packbits": tiff_file(deep, 1, "<", 16, comp=32773,
                                              tile=(16, 32)),
        "planar_rgb_lzw_predictor": tiff_file(rgb, 2, "<", comp=5, pred=2,
                                              planar=2, rps=7),
        "planar_rgba_tiles_deflate": tiff_file(rgba, 2, ">", comp=8,
                                               planar=2, tile=(32, 16),
                                               extra=(2,)),
        "be_rgba16_strips": tiff_file(deep[..., None].repeat(4, -1), 2, ">",
                                      16, rps=8, extra=(2,)),
        "min_is_white_packbits": tiff_file(grey, 0, ">", comp=32773, rps=4),
        "min_is_white_1bit": tiff_file(idx > 7, 0, "<", 1, comp=32773),
        "grey4_lzw": tiff_file(idx, 1, "<", 4, comp=5, rps=9),
        "grey2_tiles": tiff_file(idx % 4, 1, ">", 2, tile=(16, 16)),
        "palette4_lzw": tiff_file(idx, 3, "<", 4, comp=5,
                                  colormap=list(range(0, 65536, 4096)) * 3),
        "palette8_be_packbits": tiff_file(idx * 16, 3, ">", comp=32773,
                                          colormap=cmap),
    })
    return cases


TIFF_CASES = tiff_cases()


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_reads_as_pillow(case, tmp_path):
    data = TIFF_CASES[case]
    assert_same(port_array(data, tmp_path, case + ".tiff"),
                pillow_array(data), case)


# ---------------------------------------------------------------------- GIF
def gif_lzw(idx: bytes, min_bits: int) -> bytes:
    """GIF LZW (codes LSB first), a clear code when the table fills."""
    clear, out, acc, nacc = 1 << min_bits, bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, clear + 2, min_bits + 1

    table, nxt, width = reset()
    put(clear, width)
    w = b""
    for c in idx:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt > (1 << width) and width < 12:
            width += 1
        if nxt >= 4095:
            put(clear, width)
            table, nxt, width = reset()
        w = bytes([c])
    put(table[w], width)
    put(clear + 1, width)
    if nacc:
        out.append(acc & 255)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + out[i:i + 255]
                      for i in range(0, len(out), 255))
    return bytes([min_bits]) + blocks + b"\0"


def gif_file(idx, screen, at=(0, 0), global_pal=None, local_pal=None,
             interlace=False, transparency=None):
    """A GIF89a of one frame of indices idx [h, w] at `at` on a screen."""
    h, w = idx.shape
    rows = (np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                            np.arange(2, h, 4), np.arange(1, h, 2)])
            if interlace else np.arange(h))

    def table(pal):
        n = max(1, (len(pal) - 1).bit_length())
        return n, bytes(v for rgb in pal for v in rgb).ljust(3 << n, b"\0")

    out = b"GIF89a" + struct.pack("<HH", *screen[::-1])
    if global_pal:
        n, t = table(global_pal)
        out += bytes([0x80 | (n - 1), 0, 0]) + t
    else:
        out += b"\0\0\0"
    if transparency is not None:
        out += b"\x21\xf9\x04\x01\0\0" + bytes([transparency]) + b"\0"
    flags, t = 0, b""
    if local_pal:
        n, t = table(local_pal)
        flags = 0x80 | (n - 1)
    if interlace:
        flags |= 0x40
    out += b"," + struct.pack("<HHHHB", at[1], at[0], w, h, flags) + t
    bits = max(2, int(idx.max()).bit_length())
    return out + gif_lzw(idx[rows].tobytes(), bits) + b";"


def gif_cases():
    im = images(h=41, w=53)
    rng = np.random.default_rng(7)
    pal = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(256)]
    noise = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    idx = im["index"]
    return {
        "pillow_p": pillow_bytes(im["rgb"], "GIF"),
        "pillow_grey": pillow_bytes(im["grey"], "GIF"),
        "pillow_noise_256": pillow_bytes(noise, "GIF", "P"),
        "pillow_p_interlaced": pillow_bytes(im["rgb"], "GIF", interlace=True),
        "global_interlaced": gif_file(idx, (41, 53), global_pal=pal[:16],
                                      interlace=True),
        "local_palette": gif_file(noise, (64, 64), local_pal=pal),
        "local_over_global_offset": gif_file(
            idx[:20, :30], (41, 53), at=(5, 9), global_pal=pal[:4],
            local_pal=pal[:16], transparency=3),
        "no_palette_interlaced": gif_file(idx * 8, (41, 53), interlace=True),
    }


GIF_CASES = gif_cases()


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_gif_reads_as_pillow(case, tmp_path):
    data = GIF_CASES[case]
    assert_same(port_array(data, tmp_path, case + ".gif"),
                pillow_array(data), case)


# --------------------------------------------------------------------- WebP
def webp_cases():
    im = images(h=45, w=61)
    rgb, rgba = im["rgb"], im["rgba"]
    rng = np.random.default_rng(11)
    few = rng.integers(0, 4, (45, 61)) * 60
    few = np.stack([few, 255 - few, few // 2], -1).astype(np.uint8)
    noise = rng.integers(0, 256, (40, 50, 4)).astype(np.uint8)
    frames = [Image.fromarray(rgb), Image.fromarray(rgb[::-1])]
    anim, anim_lossy = io.BytesIO(), io.BytesIO()
    frames[0].save(anim, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=True)
    frames[0].save(anim_lossy, "WEBP", save_all=True,
                   append_images=frames[1:], quality=60)
    yy, xx = np.mgrid[0:96, 0:128]
    big = np.stack([np.sin(xx / 9.0) * 120 + 128, np.cos(yy / 7.0) * 120 + 128,
                    (xx + yy) % 256], -1).astype(np.uint8)
    cases = {
        "lossless_rgb": pillow_bytes(rgb, "WEBP", lossless=True),
        "lossless_rgba": pillow_bytes(rgba, "WEBP", lossless=True),
        "lossless_palette": pillow_bytes(few, "WEBP", lossless=True),
        "lossless_noise_rgba": pillow_bytes(noise, "WEBP", lossless=True),
        "lossless_exact_q0": pillow_bytes(rgba, "WEBP", lossless=True,
                                          quality=0, method=0, exact=True),
        "lossless_q100_m6": pillow_bytes(rgb, "WEBP", lossless=True,
                                         quality=100, method=6),
        "animated_lossless": anim.getvalue(),
        "lossy_rgb": pillow_bytes(rgb, "WEBP", quality=80),
        "lossy_rgba": pillow_bytes(rgba, "WEBP", quality=80),
        "lossy_rgba_alpha_q30": pillow_bytes(rgba, "WEBP", quality=60,
                                             alpha_quality=30),
        "lossy_q1_m0": pillow_bytes(rgb, "WEBP", quality=1, method=0),
        "lossy_q100_m6": pillow_bytes(rgb, "WEBP", quality=100, method=6),
        "lossy_noise_q50": pillow_bytes(noise[..., :3], "WEBP", quality=50),
        "lossy_1x1": pillow_bytes(rgb[:1, :1], "WEBP"),
        "lossy_odd_17x33": pillow_bytes(rgb[:17, :33], "WEBP", quality=70),
        "lossy_even_smooth": pillow_bytes(big, "WEBP", quality=90),
        "animated_lossy": anim_lossy.getvalue(),
    }
    return cases


def libwebp():
    """Pillow's own libwebp through ctypes (loaded with its libsharpyuv by
    importing PIL._webp): the encoder options Pillow's save does not pass
    on (the simple loop filter, sharpness, filter strength, segments, the
    alpha filter and compression)."""
    import ctypes
    import glob
    import os
    import PIL
    from PIL import _webp  # noqa: F401
    path, = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                   "pillow.libs", "libwebp-*.so*"))
    return ctypes.CDLL(path)


def libwebp_encode(img: np.ndarray, **options) -> bytes:
    """WebPEncode of an RGB or RGBA image with WebPConfig fields set."""
    import ctypes
    lib = libwebp()
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fields = ["lossless", "quality", "method", "image_hint", "target_size",
              "target_PSNR", "segments", "sns_strength", "filter_strength",
              "filter_sharpness", "filter_type", "autofilter",
              "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
              "show_compressed", "preprocessing", "partitions",
              "partition_limit", "emulate_jpeg_size", "thread_level",
              "low_memory", "near_lossless", "exact", "use_delta_palette",
              "use_sharp_yuv", "qmin", "qmax"]

    class Config(ctypes.Structure):
        _fields_ = [(n, f if n in ("quality", "target_PSNR") else i)
                    for n in fields] + [("pad", ctypes.c_uint32 * 8)]

    writer_t = ctypes.CFUNCTYPE(i, p, ctypes.c_size_t, p)

    class Picture(ctypes.Structure):
        _fields_ = [("use_argb", i), ("colorspace", i), ("width", i),
                    ("height", i), ("y", p), ("u", p), ("v", p),
                    ("y_stride", i), ("uv_stride", i), ("a", p),
                    ("a_stride", i), ("pad1", ctypes.c_uint32 * 2),
                    ("argb", p), ("argb_stride", i),
                    ("pad2", ctypes.c_uint32 * 3), ("writer", writer_t),
                    ("custom_ptr", p), ("extra_info_type", i),
                    ("extra_info", p), ("stats", p), ("error_code", i),
                    ("progress_hook", p), ("user_data", p),
                    ("pad3", ctypes.c_uint32 * 3), ("pad4", p), ("pad5", p),
                    ("pad6", ctypes.c_uint32 * 8), ("memory_", p),
                    ("memory_argb_", p), ("pad7", p * 2)]

    cfg, pic, out = Config(), Picture(), bytearray()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, f(75), 0x0210)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg))
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), 0x0210)
    img = np.ascontiguousarray(img)
    pic.height, pic.width, ch = img.shape
    imp = lib.WebPPictureImportRGBA if ch == 4 else lib.WebPPictureImportRGB
    assert imp(ctypes.byref(pic), img.ctypes.data_as(p), pic.width * ch)

    @writer_t
    def write(data, size, _):
        out.extend(ctypes.string_at(data, size))
        return 1

    pic.writer = write
    try:
        assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), \
            pic.error_code
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
    return bytes(out)


def libwebp_cases():
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:96, 0:112]
    img = np.stack([np.sin(xx / 9.0) * 120 + 128, np.cos(yy / 7.0) * 120 + 128,
                    (xx + yy) % 256], -1).astype(np.uint8)
    img[48:] = rng.integers(0, 256, (48, 112, 3))       # noise below
    rgba = np.concatenate([img, ((xx * 7 + yy) % 256).astype(np.uint8)[
        ..., None]], -1)
    return {
        "simple_filter": libwebp_encode(img, filter_type=0),
        "simple_filter_sharp7_strong": libwebp_encode(
            img, filter_type=0, filter_sharpness=7, filter_strength=100),
        "complex_sharp3": libwebp_encode(img, filter_sharpness=3,
                                         filter_strength=60),
        "no_filter": libwebp_encode(img, filter_strength=0),
        "one_segment": libwebp_encode(img, segments=1),
        "four_segments_sns100": libwebp_encode(img, segments=4,
                                               sns_strength=100),
        "q5_level63": libwebp_encode(img, quality=5),
        "sharp_yuv": libwebp_encode(img, use_sharp_yuv=1),
        "alpha_unfiltered": libwebp_encode(rgba, alpha_filtering=0),
        "alpha_best_filter": libwebp_encode(rgba, alpha_filtering=2),
        "alpha_raw": libwebp_encode(rgba, alpha_compression=0),
        "alpha_q20": libwebp_encode(rgba, alpha_quality=20),
    }


WEBP_CASES = webp_cases()
WEBP_CASES.update({"libwebp_" + k: v for k, v in libwebp_cases().items()})


@pytest.mark.parametrize("case", sorted(WEBP_CASES))
def test_webp_reads_as_pillow(case, tmp_path):
    data = WEBP_CASES[case]
    assert_same(port_array(data, tmp_path, case + ".webp"),
                pillow_array(data), case)


# ------------------------------------------------ a capture in these formats
def encode_as(img: np.ndarray, kind: str) -> bytes:
    """A frame's bytes in one of the formats a capture may hold."""
    return {
        "tiff_lzw": lambda: pillow_bytes(img, "TIFF", compression="tiff_lzw"),
        "tiff_deflate_predictor": lambda: pillow_bytes(
            img, "TIFF", compression="tiff_adobe_deflate", tiffinfo={317: 2}),
        "webp_lossy": lambda: pillow_bytes(img, "WEBP", quality=85),
        "webp_lossless": lambda: pillow_bytes(img, "WEBP", lossless=True),
        "bmp": lambda: pillow_bytes(img, "BMP"),
        "gif": lambda: pillow_bytes(img, "GIF"),
        "tiff16": lambda: tiff_file(img.astype(np.uint16) * 257 + 3, 1, "<",
                                    16, comp=5),
        "bmp_palette": lambda: pillow_bytes(img, "BMP", "P"),
    }[kind]()


def reencode_capture(root: str, kinds, mask_kind=None) -> None:
    """Rewrites a COLMAP capture's frames (the i-th in kinds[i % len]),
    renaming them in images.bin, and, with mask_kind, adds a mask a frame
    in that format under the name the providers look for (mask/<stem>.png:
    both packages read a file by its content)."""
    import dataclasses
    import os
    from nerf2mesh_tpu_torch.data import colmap_utils as tcu
    sp = os.path.join(root, "sparse", "0", "images.bin")
    ims = tcu.read_images_binary(sp)
    ext = {"tiff": ".tif", "webp": ".webp", "bmp": ".bmp", "gif": ".gif"}
    if mask_kind:
        os.makedirs(os.path.join(root, "mask"), exist_ok=True)
    for i, k in enumerate(sorted(ims)):
        im = ims[k]
        src = os.path.join(root, "images", im.name)
        with Image.open(src) as f:
            rgb = np.asarray(f.convert("RGB"))
        kind = kinds[i % len(kinds)]
        stem = os.path.splitext(im.name)[0]
        name = stem + ext[kind.split("_")[0].rstrip("16")]
        frame = rgb.mean(-1).astype(np.uint8) if kind == "tiff16" else rgb
        Path(root, "images", name).write_bytes(encode_as(frame, kind))
        os.remove(src)
        ims[k] = dataclasses.replace(im, name=name)
        if mask_kind:
            mask = ((rgb.astype(int).sum(-1) > 60) * 255).astype(np.uint8)
            Path(root, "mask", stem + ".png").write_bytes(
                encode_as(mask, mask_kind))
    tcu.write_images_binary(ims, sp)


def load_both(root: str, split: str = "train"):
    from nerf2mesh_tpu.config import parse_args as jparse
    from nerf2mesh_tpu.data.colmap import load_colmap_dataset as jload
    from nerf2mesh_tpu_torch.config import parse_args as tparse
    from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset as tload
    want = jload(jparse([root]), split)
    with no_pillow():
        got = tload(tparse([root]), split)
    return got, want


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    root = tmp_path_factory.mktemp("formats") / "scene"
    generate_colmap_dataset(str(root), H=32, W=32, n_images=8, n_points=200)
    return root


def test_colmap_capture_in_other_formats_loads_as_jax(colmap_scene,
                                                      tmp_path):
    """A COLMAP capture whose frames are TIFF (LZW; deflate with the
    predictor), lossy and lossless WebP and BMP, with TIFF masks: the port
    (Pillow blocked) loads the arrays the JAX package loads through
    Pillow."""
    import shutil
    root = str(tmp_path / "c")
    shutil.copytree(colmap_scene, root)
    reencode_capture(root, ["tiff_lzw", "webp_lossy", "webp_lossless", "bmp",
                            "tiff_deflate_predictor"], mask_kind="tiff_lzw")
    for split in ("train", "val"):
        got, want = load_both(root, split)
        assert got.images.shape == want.images.shape
        assert got.images.shape[-1] == 4                 # the masks' alpha
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.poses, want.poses)


def test_colmap_raw_modes_match_the_reference(colmap_scene, tmp_path):
    """The reference's behaviour, not a contract: JAX's providers take
    np.asarray(Image.open(p)) as the frame, so a GIF or palette-BMP frame
    reaches them as its palette indices repeated to three channels, and a
    16-bit TIFF frame is cut to its low byte by the COLMAP provider's
    astype(np.uint8); the port gives the same arrays."""
    import shutil
    root = str(tmp_path / "c")
    shutil.copytree(colmap_scene, root)
    reencode_capture(root, ["gif", "bmp_palette", "tiff16"])
    got, want = load_both(root, "all")
    np.testing.assert_array_equal(got.images, want.images)
    import os
    from nerf2mesh_tpu_torch.data import colmap_utils as tcu
    ims = tcu.read_images_binary(os.path.join(root, "sparse", "0",
                                              "images.bin"))
    names = [ims[k].name for k in sorted(ims)]
    for i, name in enumerate(names):
        with Image.open(os.path.join(root, "images", name)) as f:
            raw = np.asarray(f)
        assert raw.ndim == 2                         # indices or I;16 grey
        np.testing.assert_array_equal(
            got.images[i], raw.astype(np.uint8)[..., None].repeat(3, -1))
    assert {n.rsplit(".", 1)[1] for n in names} == {"gif", "bmp", "tif"}


# ------------------------------------------------------- committed fixtures
FORMATS = FIXTURES / "formats"
FORMAT_HASHES = FIXTURES / "formats.json"
# the COLMAP capture chip_smoke.py's phase 14 (e) trains on: 16 views at
# 96^2, frames in four formats, TIFF masks
CAPTURE = FIXTURES / "colmap_formats"
CAPTURE_KINDS = ["tiff_lzw", "webp_lossy", "webp_lossless", "bmp"]


def sha(a) -> dict:
    """SHA-256 of an array's values (bool as 0/1), its dtype and shape."""
    a = np.asarray(a)
    v = a.astype(np.uint8) if a.dtype == bool else a
    return {"sha256": hashlib.sha256(np.ascontiguousarray(v).tobytes())
            .hexdigest(), "dtype": str(a.dtype), "shape": list(a.shape)}


def all_cases() -> dict:
    out = {}
    for ext, cases in (("bmp", BMP_CASES), ("tiff", TIFF_CASES),
                       ("gif", GIF_CASES), ("webp", WEBP_CASES)):
        for name, data in cases.items():
            out[f"formats/{ext}/{name}.{ext}"] = data
    return out


def is_mine(rel: str) -> bool:
    """Whether a formats.json entry is one of this module's files (the
    other entries are tests/test_torch_imageforms.py's)."""
    parts = rel.split("/")
    return parts[0] == "colmap_formats" or (
        parts[0] == "formats" and parts[1] in ("bmp", "tiff", "gif", "webp")
        and not parts[2].startswith("forms_"))


def write_fixtures() -> None:
    """Writes this module's files under fixtures/formats/ (every case
    above), the COLMAP capture fixtures/colmap_formats/ and their entries
    in fixtures/formats.json, Pillow's hash of each of their images (paths
    relative to fixtures/); the other entries stay."""
    import shutil
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
    hashes = json.loads(FORMAT_HASHES.read_text())
    for rel in [k for k in hashes if is_mine(k)]:
        (FIXTURES / rel).unlink(missing_ok=True)
        del hashes[rel]
    for rel, data in all_cases().items():
        (FIXTURES / rel).parent.mkdir(parents=True, exist_ok=True)
        (FIXTURES / rel).write_bytes(data)
    shutil.rmtree(CAPTURE, ignore_errors=True)
    generate_colmap_dataset(str(CAPTURE), H=96, W=96, n_images=16,
                            n_points=400)
    reencode_capture(str(CAPTURE), CAPTURE_KINDS, mask_kind="tiff_lzw")
    files = list(all_cases()) + [str(p.relative_to(FIXTURES)) for d in (
        CAPTURE / "images", CAPTURE / "mask") for p in sorted(d.iterdir())]
    for rel in files:
        hashes[rel] = sha(pillow_array((FIXTURES / rel).read_bytes()))
    FORMAT_HASHES.write_text(json.dumps(dict(sorted(hashes.items())),
                                        indent=1) + "\n")


def test_committed_format_files(tmp_path):
    """The committed files (every case above and the COLMAP capture's
    frames and masks) hash to Pillow's arrays in formats.json, and the
    port reads each to the same hash."""
    want = json.loads(FORMAT_HASHES.read_text())
    assert set(want) >= set(all_cases())
    kinds = {p.rsplit(".", 1)[1] for p in want if "colmap_formats" in p}
    assert kinds == {"tif", "webp", "bmp", "png"}       # masks: TIFF bytes
    for rel, h in want.items():
        data = (FIXTURES / rel).read_bytes()
        assert sha(pillow_array(data)) == h, rel
        assert sha(port_array(data, tmp_path, rel.replace("/", "_"))) == h, \
            rel


if __name__ == "__main__":
    write_fixtures()
