"""The port's PNG codec (data/png.py) against Pillow, and its perceptual
loss and filters (utils/losses.py) against the JAX package, on the CPU.

The codec must give exactly the bytes' pixels both ways: PNGs it writes
read back equal through Pillow, and PNGs written with each of the five row
filters read equal to Pillow's decode of the same bytes.  The filter file
must equal ``_perceptual_filters()`` exactly; ``perceptual_loss`` is held
to JAX's at atol 1e-5 (fp32 convolutions summed in another order), on an
even and an odd image size, where XLA's "SAME" padding at stride 2 differs.
"""

import io
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf2mesh_tpu.utils import losses as jlosses
from nerf2mesh_tpu_torch.data import png
from nerf2mesh_tpu_torch.utils import losses as tlosses


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
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999).save(
        tmp_path / "deep.png")
    Image.fromarray(_images()["rgb"]).convert("P").save(tmp_path / "pal.png")
    for name in ("deep.png", "pal.png"):
        with pytest.raises(NotImplementedError):
            png.read_png(str(tmp_path / name))


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
