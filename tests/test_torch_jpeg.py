"""The port's JPEG writer and bilinear downscale (data/jpeg.py), which the
stage-1 export uses where Pillow is missing, against Pillow: the port's
baseline JPEG (4:4:4, standard tables, quality 95) decodes in Pillow to
within 40 dB PSNR of its input (a noise texture: within 0.1 dB of Pillow's
own 4:4:4 file, 39.8 dB); the downscale is within 1/255 of
Image.resize(BILINEAR) on at least 99% of the pixels; the port's decoder
reads the port's files as Pillow does (within Pillow's integer IDCT)."""

import io
import sys

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu_torch.data import jpeg
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames


def images():
    rng = np.random.default_rng(0)
    scene = render_synthetic_frames(H=120, W=136, n_train=1, n_val=0,
                                    n_test=0)["train"]["images"][0][..., :3]
    y, x = np.mgrid[0:97, 0:131]
    ramp = np.stack([x * 255 / 130, y * 255 / 96, (x + y) * 255 / 226],
                    -1).astype(np.uint8)
    texture = np.asarray(Image.fromarray(rng.integers(
        0, 256, (24, 32, 3), dtype=np.uint8)).resize((128, 96),
                                                     Image.BILINEAR))
    return {"scene": scene, "ramp": ramp, "texture": texture}


IMAGES = images()


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_port_jpeg_decodes_in_pillow_within_40_db(name):
    img = IMAGES[name]
    data = jpeg.encode_jpeg(img, 95)
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "JPEG" and im.mode == "RGB"
        assert im.size == (img.shape[1], img.shape[0])
        dec = np.asarray(im)
    # the texture (bilinear-upsampled noise) is past what q95 keeps at 40
    # dB even in Pillow's own 4:4:4 writer (39.8): hold it to that instead
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=95, subsampling=0)
    with Image.open(buf) as im:
        pil = psnr(np.asarray(im), img)
    floor = 40.0 if name != "texture" else pil - 0.1
    assert psnr(dec, img) >= floor, (psnr(dec, img), pil)
    gray = jpeg.encode_jpeg(img[..., 1], 95)
    with Image.open(io.BytesIO(gray)) as im:
        assert im.mode == "L"
        assert psnr(np.asarray(im), img[..., 1]) >= min(floor, 40.0)


def test_quality_tables_are_libjpegs():
    for q in (50, 75, 95):
        buf = io.BytesIO()
        Image.fromarray(IMAGES["scene"]).save(buf, "JPEG", quality=q)
        with Image.open(buf) as im:
            pil = im.quantization
        mine = jpeg.quant_tables(q)
        for k in (0, 1):
            assert list(mine[k]) == list(pil[k]), q


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_port_decoder_reads_its_files_as_pillow_does(name):
    data = jpeg.encode_jpeg(IMAGES[name], 95)
    mine = jpeg.decode_jpeg(data).astype(int)
    with Image.open(io.BytesIO(data)) as im:
        pil = np.asarray(im).astype(int)
    assert mine.shape == pil.shape
    assert np.abs(mine - pil).max() <= 8 and np.abs(mine - pil).mean() < 1


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("factor", [2, 3])
def test_downscale_matches_pillow_bilinear(name, factor):
    img = IMAGES[name]
    h, w = img.shape[0] // factor, img.shape[1] // factor
    mine = jpeg.downscale(img, w, h).astype(int)
    pil = np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    d = np.abs(mine - pil.astype(int))
    assert (d <= 1).mean() >= 0.99, (d <= 1).mean()


def test_without_pillow_the_port_codec_writes(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = IMAGES["scene"]
    small = jpeg.resize_bilinear(img, 68, 60)
    np.testing.assert_array_equal(small, jpeg.downscale(img, 68, 60))
    path = str(tmp_path / "t.jpg")
    jpeg.save_jpeg(path, small, quality=95)
    with open(path, "rb") as f:       # Pillow's default sampling, 4:2:0
        assert f.read() == jpeg.encode_jpeg(small, 95, "4:2:0")
