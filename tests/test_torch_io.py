"""The port's PNG codec (data/png.py) against Pillow, and its perceptual
loss and filters (utils/losses.py) against the JAX package, on the CPU.

The codec must give exactly the bytes' pixels both ways: PNGs it writes
read back equal through Pillow, and PNGs written with each of the five row
filters read equal to Pillow's decode of the same bytes.  The reader must
give Pillow's array, dtype and shape for every PNG kind: bit depths 1-16,
grey, RGB, palette, grey + alpha and RGBA, Adam7-interlaced or not, with
and without tRNS (files Pillow cannot write come from a small encoder
here, with Pillow's decode as the oracle); the committed PNG files
(nerf2mesh_tpu_torch/fixtures/png, written by ``python
tests/test_torch_io.py``) still hash to Pillow's arrays.  The filter file
must equal ``_perceptual_filters()`` exactly; ``perceptual_loss`` is held
to JAX's at atol 1e-5 (fp32 convolutions summed in another order), on an
even and an odd image size, where XLA's "SAME" padding at stride 2 differs.
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf2mesh_tpu.utils import losses as jlosses
from nerf2mesh_tpu_torch.data import png
from nerf2mesh_tpu_torch.utils import losses as tlosses

FIXTURES = Path(__file__).resolve().parent.parent / "nerf2mesh_tpu_torch" / "fixtures"


def _images(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:37, 0:23]
    smooth = ((xx * 7 + yy * 3) % 256).astype(np.uint8)
    return {
        "gray": rng.integers(0, 256, (37, 23), dtype=np.uint8),
        "rgb": np.stack([smooth, smooth[::-1], rng.integers(
            0, 256, (37, 23), dtype=np.uint8)], -1),
        "rgba": rng.integers(0, 256, (37, 23, 4), dtype=np.uint8),
    }


def _filtered_png(img, filters):
    """PNG bytes of img with row y written through filter filters[y % len]
    (the PNG standard's forward filters)."""
    a = img[..., None] if img.ndim == 2 else img
    H, W, C = a.shape
    rows = a.reshape(H, W * C).astype(np.int32)
    out = []
    for y in range(H):
        f = filters[y % len(filters)]
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(C, np.int32), x[:-C]])
        ul = np.concatenate([np.zeros(C, np.int32), up[:-C]])
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ctype = {1: 0, 3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_png_writer_reads_back_in_pillow(kind, tmp_path):
    img = _images()[kind]
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
def test_png_reader_undoes_every_filter(filters):
    for kind, img in _images(1).items():
        data = _filtered_png(img, filters)
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im)
        np.testing.assert_array_equal(want, img, err_msg=kind)
        np.testing.assert_array_equal(png.decode_png(data), want,
                                      err_msg=kind)


def test_png_reader_reads_pillow_files_and_rejects_others(tmp_path):
    for kind, img in _images(2).items():
        path = str(tmp_path / f"{kind}.png")
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(png.read_png(path), img, err_msg=kind)
    # 16-bit grey and palette files read as Pillow reads them
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999).save(
        tmp_path / "deep.png")
    Image.fromarray(_images()["rgb"]).convert("P").save(tmp_path / "pal.png")
    for name in ("deep.png", "pal.png"):
        with Image.open(tmp_path / name) as im:
            want = np.asarray(im)
        got = png.read_png(str(tmp_path / name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # a depth the colour type does not allow, and bytes that are not PNG
    data = _encode_png(np.zeros((2, 2, 3), np.uint8), 4, 2, False)
    with pytest.raises(ValueError, match="bit depth 4"):
        png.decode_png(data)
    with pytest.raises(ValueError):
        png.decode_png(b"not a png")
    # BMP, TIFF, WebP, ICO and DDS read as Pillow reads them (every
    # variant: tests/test_torch_imageio.py, test_torch_legacyforms.py,
    # test_torch_textureforms.py); a format the port does not read still
    # raises, naming its ROADMAP item (AVIF: A6 (j) 10)
    for ext in ("bmp", "tiff", "webp", "ico", "dds"):
        path = tmp_path / f"frame.{ext}"
        Image.fromarray(_images()["rgb"]).save(path)
        with Image.open(path) as im:
            want = np.asarray(im)
        np.testing.assert_array_equal(png.read_image(str(path)), want)
    path = tmp_path / "frame.avif"
    Image.fromarray(_images()["rgb"]).save(path, "AVIF")
    with pytest.raises(NotImplementedError, match=r"A6 \(j\) 10"):
        png.read_image(str(path))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack_rows(samples, depth):
    """[h, w, ch] samples -> the PNG rows' bytes (MSB first below 8 bits,
    big-endian at 16)."""
    h, w, ch = samples.shape
    flat = samples.reshape(h, w * ch).astype(np.int64)
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in flat]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in flat]
    bits = ((flat[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1)
    bits = bits.reshape(h, -1).astype(np.uint8)
    return [np.packbits(r).tobytes() for r in bits]


def _filter_rows(rows, bpp, first):
    """The forward filters, row y through filter (first + y) % 5."""
    out, prior = [], None
    for y, r in enumerate(rows):
        x = np.frombuffer(r, np.uint8).astype(np.int32)
        up = prior if prior is not None else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])[:len(x)]
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])[:len(x)]
        f = (first + y) % 5
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prior = x
    return out


def _encode_png(samples, depth, ctype, interlace, plte=None, trns=None):
    """A PNG of any bit depth and colour type, interlaced (Adam7) or not,
    every filter type used: what Pillow cannot write (interlaced files,
    16-bit RGB(A), 2- and 4-bit grey) for Pillow to decode as the oracle."""
    H, W, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = []
    for k, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace
                                         else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack_rows(sub, depth), bpp, k)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return (out + chunk(b"IDAT", zlib.compress(b"".join(raw)))
            + chunk(b"IEND", b""))


PNG_KINDS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + [
    (3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)]


def _png_case(ctype, depth, interlace, trns, H=13, W=9, seed=0):
    rng = np.random.default_rng(seed + 31 * depth + ctype)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.integers(0, 1 << depth, (H, W, ch))
    plte = t = None
    if ctype == 3:
        plte = rng.integers(0, 256, 3 << depth, dtype=np.uint8).tobytes()
        if trns:
            t = rng.integers(0, 256, max(1, (1 << depth) // 2),
                             dtype=np.uint8).tobytes()
    elif trns and ctype in (0, 2):
        t = struct.pack(">" + "H" * ch, *map(int, samples[0, 0]))
    return _encode_png(samples, depth, ctype, interlace, plte, t)


@pytest.mark.parametrize("trns", [False, True])
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_reader_matches_pillow_on_every_kind(ctype, depth, interlace,
                                                 trns):
    """Every bit depth and colour type, Adam7 or not, with and without a
    tRNS chunk, at odd sizes (a pass of a 13x9 or 3x2 image can be empty):
    the array, its dtype and its shape are Pillow's."""
    for H, W in ((13, 9), (3, 2), (1, 1)):
        data = _png_case(ctype, depth, interlace, trns, H, W)
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im)
        got = png.decode_png(data)
        assert got.dtype == want.dtype and got.shape == want.shape, (H, W)
        np.testing.assert_array_equal(got, want, err_msg=str((H, W)))


# the committed PNG files (phase 14 of chip_smoke.py decodes them on the
# card host): name -> (colour type, bit depth, interlaced, tRNS), written
# by Pillow where it can write the kind, else by _encode_png
PNG_FIXTURE = FIXTURES / "png"
PNG_FIXTURE_KINDS = {
    "gray1_pillow": (0, 1, False, False),
    "gray16_pillow": (0, 16, False, False),
    "palette_trns_pillow": (3, 8, False, True),
    "gray_alpha_pillow": (4, 8, False, False),
    "gray2_adam7": (0, 2, True, False),
    "palette4_adam7": (3, 4, True, True),
    "rgb16_adam7": (2, 16, True, False),
    "gray_alpha16": (4, 16, False, False),
    "rgba16_adam7": (6, 16, True, False),
}


def _pillow_png(ctype, depth, trns, seed=0):
    rng = np.random.default_rng(seed)
    kw = {}
    if ctype == 0 and depth == 1:
        im = Image.fromarray(rng.random((24, 32)) > 0.5)
    elif ctype == 0:
        im = Image.fromarray(rng.integers(0, 65536, (24, 32),
                                          dtype=np.uint16))
    elif ctype == 3:
        im = Image.fromarray(rng.integers(0, 256, (24, 32, 3),
                                          dtype=np.uint8)).quantize(64)
        kw["transparency"] = 3
    else:
        im = Image.fromarray(rng.integers(0, 256, (24, 32, 2),
                                          dtype=np.uint8), "LA")
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def write_png_fixture(out_dir=PNG_FIXTURE):
    """Writes the committed PNG files and png.json (the SHA-256, dtype and
    shape of each file's np.asarray(Image.open(...)))."""
    out_dir.mkdir(parents=True, exist_ok=True)
    hashes = {}
    for i, (name, (ctype, depth, adam7, trns)) in enumerate(
            PNG_FIXTURE_KINDS.items()):
        data = (_pillow_png(ctype, depth, trns, i) if name.endswith("pillow")
                else _png_case(ctype, depth, adam7, trns, 24, 32, i))
        (out_dir / f"{name}.png").write_bytes(data)
        with Image.open(io.BytesIO(data)) as im:
            hashes[f"{name}.png"] = _sha(np.asarray(im))
    (FIXTURES / "png.json").write_text(json.dumps(hashes, indent=1) + "\n")


def _sha(a):
    """SHA-256 of the array's values (bool as 0/1: Pillow's mode "1" arrays
    hold 255 for True), its dtype and shape."""
    v = a.astype(np.uint8) if a.dtype == bool else a
    return {"sha256": hashlib.sha256(np.ascontiguousarray(v).tobytes())
            .hexdigest(), "dtype": str(a.dtype), "shape": list(a.shape)}


def test_committed_png_files():
    want = json.loads((FIXTURES / "png.json").read_text())
    assert sorted(want) == sorted(f"{n}.png" for n in PNG_FIXTURE_KINDS)
    for name, h in want.items():
        path = PNG_FIXTURE / name
        with Image.open(path) as im:
            assert _sha(np.asarray(im)) == h, name
        assert _sha(png.read_image(str(path))) == h, name


def test_perceptual_filters_match_jax():
    want = [np.asarray(w) for w in jlosses._perceptual_filters()]
    got = tlosses.perceptual_filters()
    assert [w.shape for w in got] == [(3, 3, 3, 16), (3, 3, 16, 32),
                                      (3, 3, 32, 64)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("H,W", [(32, 48), (33, 21)])
def test_perceptual_loss_matches_jax(H, W):
    rng = np.random.default_rng(H)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = float(jlosses.perceptual_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(tlosses.perceptual_loss(torch.from_numpy(a),
                                        torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert want > 1e-3
    # the same shapes of feature maps as XLA's "SAME" convolutions
    jf = jlosses._perceptual_features(jnp.asarray(a))
    tf = tlosses._perceptual_features(torch.from_numpy(a))
    for j, t in zip(jf, tf):
        np.testing.assert_allclose(t[0].permute(1, 2, 0).numpy(),
                                   np.asarray(j[0]), atol=1e-5)


if __name__ == "__main__":
    write_png_fixture()
