"""Real-capture input without Pillow, cv2 or sklearn, against those
libraries and the JAX package's readers, on the CPU at small sizes.

* JPEG decode (data/jpeg.py, native/jpegdec.cpp): files written by Pillow
  at 4:4:4, 4:2:2, 4:2:0 and grey, qualities 50/75/95, with and without
  restart intervals, at 67x45: within 1 of 255 of Pillow's decode
  everywhere and equal on at least 99% of the values (the share is
  printed; it is 100% where libjpeg's islow IDCT, fancy upsampling and
  fixed-point colour conversion are matched).  Progressive files (DC and
  AC scans, first and refine, end-of-band runs, restart intervals), grey
  and CMYK: byte-equal to Pillow's decode; arithmetic-coded and 12-bit
  files raise.
* JPEG encode: the port's 4:2:0 and 4:2:2 files carry those sampling
  factors and decode in Pillow within the 40 dB floor of
  tests/test_torch_jpeg.py, or within 0.1 dB of Pillow's own file at the
  same sampling where that is below 40 dB.
* Resize (data/resize.py): INTER_AREA against cv2.resize and Pillow's
  BICUBIC against Image.resize, within 1 of 255 on at least 99% of the
  values and within 2 everywhere, at integer and non-integer factors;
  INTER_LINEAR on float32 against cv2 to rtol 1e-5.
* RANSAC (data/ransac.py) against sklearn's RANSACRegressor on noisy data
  with outliers: both within the noise of the true line.
* Providers: blender downscale and the trainval/all splits, a COLMAP frame
  of another size and a JPEG capture, against JAX's datasets (images within
  1 of 255 on at least 99%, poses and intrinsics equal); sparse depth
  (pixels and weights equal, depths to rtol 1e-6) and dense depth from
  exact affine maps with outliers (within 1e-4 relative of JAX's, which
  fits with cv2 and sklearn).
* The committed progressive capture (nerf2mesh_tpu_torch/fixtures/
  progressive, written by ``python tests/test_torch_captures.py``): its
  hashes still equal Pillow's decode, the port's decode equals them, and
  the blender provider reads it as JAX's does.
"""

import dataclasses
import hashlib
import io
import json
import os
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image
from sklearn.linear_model import RANSACRegressor

from nerf2mesh_tpu.config import parse_args as jparse
from nerf2mesh_tpu.data.colmap import load_colmap_dataset as jload_colmap
from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
from nerf2mesh_tpu.data.synthetic import generate_colmap_dataset as jgen_colmap
from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset as jgen
from nerf2mesh_tpu_torch.config import parse_args as tparse
from nerf2mesh_tpu_torch.data import colmap_utils as tcu
from nerf2mesh_tpu_torch.data import jpeg, resize
from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset as tload_colmap
from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset as tload
from nerf2mesh_tpu_torch.data.ransac import ransac_line
from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset

REPO = Path(__file__).resolve().parent.parent


def photo(H, W, C=3, seed=0):
    """Smooth colour fields with sharp edges and noise: a capture's
    statistics at a small size."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 120,
                     ((x + y) % 50) * 4.0, (x * 3.0) % 256][:C], -1)
    base[(x - W / 2) ** 2 + (y - H / 3) ** 2 < (H / 5) ** 2] = 30
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(
        np.uint8)


def close_to(got, want, equal_share=None):
    """Within 1 of 255 on >= 99% of the values and within 2 everywhere;
    returns the share of equal values."""
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape
    assert (d <= 1).mean() >= 0.99 and d.max() <= 2, (d.max(),
                                                      (d <= 1).mean())
    return float((d == 0).mean())


# ------------------------------------------------------------------- JPEG

@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_decoder_matches_pillow(sampling, quality, restart):
    img = photo(67, 45)
    if sampling == "grey":
        img = img[..., 1]
    kw = dict(quality=quality)
    if sampling != "grey":
        kw["subsampling"] = sampling
    if restart:
        kw["restart_marker_blocks"] = 1
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    data = buf.getvalue()
    assert (b"\xff\xdd" in data) == restart
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im)
    got = jpeg.decode_jpeg(data)
    d = np.abs(got.astype(int) - want.astype(int))
    share = float((d == 0).mean())
    print(f"{sampling} q{quality} restart={restart}: {share:.6f} equal")
    assert got.shape == want.shape and d.max() <= 1 and share >= 0.99


def test_decoder_refuses_progressive_and_garbage():
    """Progressive files read (test_progressive_decoder_matches_pillow), and
    so do arithmetic-coded ones (every form: tests/test_torch_imageforms.py):
    a baseline file whose SOF marker is rewritten to SOF9 decodes, as
    garbage, to the shape Pillow's libjpeg-turbo gives and to its values
    but where the garbage's coefficients leave the range of the SIMD
    IDCT's 16-bit arithmetic.  What is refused raises ValueError, as Pillow
    refuses it: 12-bit samples (the precision of a baseline file
    rewritten), and garbage."""
    buf = io.BytesIO()
    Image.fromarray(photo(32, 40)).save(buf, "JPEG", progressive=True)
    with Image.open(buf) as im:
        np.testing.assert_array_equal(jpeg.decode_jpeg(buf.getvalue()),
                                      np.asarray(im))
    buf = io.BytesIO()
    Image.fromarray(photo(32, 40)).save(buf, "JPEG")
    base = buf.getvalue()
    sof = base.index(b"\xff\xc0")
    sof9 = base[:sof + 1] + b"\xc9" + base[sof + 2:]
    with Image.open(io.BytesIO(sof9)) as im:
        want = np.asarray(im)
    got = jpeg.decode_jpeg(sof9)
    assert got.shape == want.shape and (got == want).mean() > 0.99
    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(twelve)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(twelve)).load()
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(b"not a jpeg")
    # a Huffman table with more codes than its lengths allow (3 of 1 bit)
    buf = io.BytesIO()
    Image.fromarray(photo(16, 16)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    i = data.index(b"\xff\xc4") + 5           # the first table's counts
    n = sum(data[i:i + 16])
    data[i:i + 16] = bytes([3, n - 3] + [0] * 14)
    with pytest.raises(ValueError, match="bad Huffman table"):
        jpeg.decode_jpeg(bytes(data))


@pytest.mark.parametrize("form", ["rgb", "grey", "cmyk"])
@pytest.mark.parametrize("options", [
    dict(progressive=True), dict(progressive=True, optimize=True),
    dict(progressive=True, restart_marker_blocks=3),
    dict(progressive=True, restart_marker_rows=1, optimize=True),
    dict(optimize=True)])
def test_progressive_decoder_matches_pillow(form, options):
    """Progressive files of Pillow's writer (its scan script: DC first and
    refine, spectral bands, successive approximation), optimized Huffman
    tables, restart intervals, at 4:4:4, 4:2:2 and 4:2:0, grey and CMYK,
    odd sizes: byte-equal to Pillow's decode, dtype and shape included."""
    for i, (H, W) in enumerate(((67, 45), (1, 1), (17, 250), (64, 64))):
        c = {"rgb": 3, "grey": 1, "cmyk": 4}[form]
        img = photo(H, W, c, seed=i)
        im = (Image.fromarray(img[..., 0]) if c == 1 else
              Image.fromarray(img, "CMYK") if c == 4 else Image.fromarray(img))
        for sub in ((0, 1, 2) if c == 3 else (-1,)):
            buf = io.BytesIO()
            im.save(buf, "JPEG", quality=(50, 90)[i % 2], subsampling=sub,
                    **options)
            with Image.open(io.BytesIO(buf.getvalue())) as f:
                want = np.asarray(f)
            got = jpeg.decode_jpeg(buf.getvalue())
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=str((H, W, sub)))


def test_decoder_reads_odd_sizes_and_tiny_chroma():
    """Chroma planes 1-2 samples wide take libjpeg's plain replication."""
    for H, W in ((1, 1), (3, 5), (17, 2), (2, 33)):
        img = photo(H, W, seed=H * W)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        with Image.open(buf) as im:
            want = np.asarray(im)
        np.testing.assert_array_equal(jpeg.decode_jpeg(buf.getvalue()), want)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("sampling,factors", [("4:2:0", (2, 2)),
                                              ("4:2:2", (2, 1))])
def test_encoder_subsamples_as_pillow(sampling, factors, tmp_path,
                                      monkeypatch):
    img = photo(70, 90)
    data = jpeg.encode_jpeg(img, 95, sampling)
    with Image.open(io.BytesIO(data)) as im:
        assert [(h, v) for _, h, v, _ in im.layer] == [factors, (1, 1),
                                                        (1, 1)]
        dec = np.asarray(im)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=95, subsampling=sampling)
    with Image.open(buf) as im:
        pil = _psnr(np.asarray(im), img)
    assert _psnr(dec, img) >= min(40.0, pil - 0.1), (_psnr(dec, img), pil)
    # the port's decoder reads it as Pillow does
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), dec)
    # without Pillow, save_jpeg writes 4:2:0 by default, as Pillow does
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = str(tmp_path / "a.jpg")
    jpeg.save_jpeg(path, img, quality=95)
    assert Path(path).read_bytes() == jpeg.encode_jpeg(img, 95, "4:2:0")
    np.testing.assert_array_equal(jpeg.read_jpeg(path),
                                  jpeg.decode_jpeg(Path(path).read_bytes()))


# ----------------------------------------------------------------- resize

SIZES = [(64, 96, 32, 48), (90, 60, 30, 20), (67, 45, 33, 22),
         (64, 64, 21, 23), (40, 50, 30, 70), (33, 21, 70, 60)]


@pytest.mark.parametrize("H,W,h,w", SIZES)
def test_resize_area_matches_cv2(H, W, h, w):
    img = photo(H, W, 4)
    close_to(resize.resize_area(img, w, h),
             cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))
    close_to(resize.resize_area(img[..., 0], w, h),
             cv2.resize(img[..., 0], (w, h), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("H,W,h,w", SIZES)
def test_resize_bicubic_matches_pillow(H, W, h, w):
    for C in (3, 4):
        img = photo(H, W, C)
        close_to(resize.resize_bicubic(img, w, h),
                 np.asarray(Image.fromarray(img).resize((w, h))))


@pytest.mark.parametrize("H,W,h,w", SIZES)
def test_resize_linear_matches_cv2(H, W, h, w):
    m = np.random.default_rng(H).uniform(0.5, 30.0, (H, W)).astype(np.float32)
    np.testing.assert_allclose(
        resize.resize_linear(m, w, h),
        cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR), rtol=1e-5)


# ----------------------------------------------------------------- RANSAC

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_matches_sklearn_within_the_noise(seed):
    rng = np.random.default_rng(seed)
    n = 400
    x = rng.uniform(0.5, 4.0, n)
    y = 1.7 * x + 0.3 + rng.normal(0, 0.01, n)
    # 30% outliers, off the line by more than the inlier threshold (the
    # MAD of y, ~1.5 here)
    bad = rng.random(n) < 0.3
    y[bad] += rng.choice([-1, 1], bad.sum()) * rng.uniform(3, 8, bad.sum())
    w = rng.uniform(0.2, 2.0, n)
    s, b = ransac_line(x, y, w, np.random.default_rng(seed))
    sk = RANSACRegressor(random_state=seed).fit(x[:, None], y, w)
    for slope, icpt in ((s, b), (sk.estimator_.coef_[0],
                                 sk.estimator_.intercept_)):
        assert abs(slope - 1.7) < 0.01 and abs(icpt - 0.3) < 0.02
    assert abs(s - sk.estimator_.coef_[0]) < 0.01


# -------------------------------------------------------------- providers

def _jcfg(root, argv=()):
    return jparse([root, *argv])


def _tcfg(root, argv=()):
    return tparse([root, *argv])


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blender"))
    jgen(root, H=45, W=67, n_train=4, n_val=2, n_test=2)
    return root


@pytest.mark.parametrize("split,downscale", [("train", 2), ("trainval", 1),
                                             ("all", 3), ("val", 2)])
def test_blender_downscale_and_splits_match_jax(blender, split, downscale):
    argv = ["--downscale", str(downscale)]
    got = tload(_tcfg(blender, argv), split)
    want = jload(_jcfg(blender, argv), split)
    assert (got.H, got.W) == (want.H, want.W)
    assert got.num_frames == want.num_frames
    close_to(got.images, want.images)
    for name in ("poses", "intrinsics", "projection", "mvps"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.training == want.training


def test_blender_frame_of_another_size_matches_jax(tmp_path):
    root = str(tmp_path / "s")
    jgen(root, H=40, W=40, n_train=3, n_val=1, n_test=1)
    with open(os.path.join(root, "transforms_train.json")) as f:
        t = json.load(f)
    t.update(h=36, w=44, fl_x=45.0, cx=22.5, cy=17.0)
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(t, f)
    for argv in ((), ("--downscale", "2")):
        got = tload(_tcfg(root, argv), "train")
        want = jload(_jcfg(root, argv), "train")
        close_to(got.images, want.images)
        np.testing.assert_array_equal(got.intrinsics, want.intrinsics)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A COLMAP capture with depth maps (72x72 frames, 54x54 maps of
    0.7 z + 0.3 with 5% outliers) written by the JAX generator's draws."""
    root = str(tmp_path_factory.mktemp("capture") / "c")
    generate_colmap_dataset(root, H=72, W=72, n_images=10, n_points=600,
                            depth_size=(54, 54), depth_affine=(0.7, 0.3),
                            depth_outliers=0.05)
    return root


def test_generator_writes_jpeg_frames_and_depth_maps(capture, tmp_path):
    sp = os.path.join(capture, "sparse", "0", "images.bin")
    names = sorted(im.name for im in tcu.read_images_binary(sp).values())
    assert names == [f"frame_{k:04d}.png" for k in range(10)]
    d = np.load(os.path.join(capture, "depths", "frame_0003.npy"))
    assert d.shape == (54, 54) and d.dtype == np.float32
    root = str(tmp_path / "j")
    generate_colmap_dataset(root, H=40, W=48, n_images=3, n_points=200,
                            image_format="jpeg", jpeg_quality=80)
    ims = tcu.read_images_binary(os.path.join(root, "sparse", "0",
                                              "images.bin"))
    for im in ims.values():
        assert im.name.endswith(".jpg")
        with Image.open(os.path.join(root, "images", im.name)) as f:
            assert f.format == "JPEG" and f.size == (48, 40)
            assert [(h, v) for _, h, v, _ in f.layer][0] == (2, 2)
    # without the depth options the output is the JAX generator's
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    generate_colmap_dataset(a, H=24, W=24, n_images=3, n_points=100)
    jgen_colmap(b, H=24, W=24, n_images=3, n_points=100)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert Path(a, "sparse", "0", name).read_bytes() == Path(
            b, "sparse", "0", name).read_bytes()


def test_colmap_jpeg_and_resized_frames_match_jax(capture, tmp_path):
    """A capture of 4:2:0 JPEGs with one frame of another size: the port's
    decoder and BICUBIC against Pillow's through JAX's reader."""
    root = str(tmp_path / "jpg")
    shutil.copytree(capture, root)
    sp = os.path.join(root, "sparse", "0", "images.bin")
    ims = tcu.read_images_binary(sp)
    for k, im in ims.items():
        src = os.path.join(root, "images", im.name)
        jpg = im.name.replace(".png", ".jpg")
        img = np.asarray(Image.open(src))
        if k == 3:
            img = photo(61, 83, seed=3)             # another size
        Image.fromarray(img).save(os.path.join(root, "images", jpg),
                                  quality=90)
        os.remove(src)
        ims[k] = dataclasses.replace(im, name=jpg)
    tcu.write_images_binary(ims, sp)
    for argv in (["--data_format", "colmap"],
                 ["--data_format", "colmap", "--downscale", "2"]):
        for split in ("train", "val"):
            want = jload_colmap(_jcfg(root, argv), split)
            got = tload_colmap(_tcfg(root, argv), split)
            print(split, argv, close_to(got.images, want.images))
            np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
            np.testing.assert_array_equal(got.poses, want.poses)


def test_sparse_depth_matches_jax(capture):
    argv = ["--data_format", "colmap", "--enable_sparse_depth"]
    for split in ("train", "val"):
        want = jload_colmap(_jcfg(capture, argv), split)
        got = tload_colmap(_tcfg(capture, argv), split)
        assert len(got.sparse_depth) == len(want.sparse_depth) == \
            got.num_frames
        for (gx, gd, gw), (wx, wd, ww) in zip(got.sparse_depth,
                                              want.sparse_depth):
            assert len(gx) > 20
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_allclose(gd, wd, rtol=1e-6)
    cfg = _tcfg(capture, argv)
    assert cfg.random_image_batch is False


@pytest.mark.parametrize("global_seed", [0, 1, 2, 3])
def test_dense_depth_matches_jax(capture, tmp_path, global_seed):
    """Maps that are an exact affine of the sparse depths at the sparse
    points' pixels (and the analytic depth elsewhere), with a tenth of
    those pixels replaced by outliers: both fits find the same line, so the
    calibrated maps agree within 1e-4 relative.  JAX's fit is sklearn's
    RANSACRegressor() without a random_state, which draws from numpy's
    global RNG: the test seeds that RNG itself, at each of several seeds,
    and gives back the state it found, so its outcome does not depend on
    the tests that ran before it."""
    state = np.random.get_state()
    np.random.seed(global_seed)
    try:
        _dense_depth_matches_jax(capture, tmp_path)
    finally:
        np.random.set_state(state)


def _dense_depth_matches_jax(capture, tmp_path):
    root = str(tmp_path / "exact")
    shutil.copytree(capture, root)
    argv = ["--data_format", "colmap", "--enable_sparse_depth"]
    sparse = tload_colmap(_tcfg(root, argv), "all").sparse_depth
    rng = np.random.default_rng(0)
    names = sorted(os.listdir(os.path.join(root, "depths")))
    for (xy, d, _), name in zip(sparse, names):
        path = os.path.join(root, "depths", name)
        m = resize.resize_linear(np.load(path), 72, 72)
        m[tuple(xy.T)] = (d - 0.25) / 1.3            # d = 1.3 m + 0.25
        out = xy[rng.random(len(xy)) < 0.1]
        m[tuple(out.T)] = rng.uniform(m.min(), m.max(), len(out))
        np.save(path, m.astype(np.float32))
    argv = ["--data_format", "colmap", "--enable_dense_depth"]
    want = jload_colmap(_jcfg(root, argv), "train")
    got = tload_colmap(_tcfg(root, argv), "train")
    assert got.dense_depth.shape == want.dense_depth.shape == (
        got.num_frames, got.H, got.W)
    rel = np.abs(got.dense_depth - want.dense_depth) / np.abs(
        want.dense_depth)
    assert rel.max() <= 1e-4, rel.max()


def test_generator_depth_maps_are_the_affine_of_z(tmp_path):
    """Without outliers and at the frames' size, the map at the pixel of
    each sparse point a view lists is 0.7 z + 0.3 of the point's z-depth in
    that camera, within 1% on 3/4 of them (0.8 and more found): a sphere's
    visible points crowd towards its silhouette, where a pixel's centre
    can see the background."""
    root = str(tmp_path / "d")
    generate_colmap_dataset(root, H=64, W=64, n_images=4, n_points=400,
                            depth_size=(64, 64), depth_affine=(0.7, 0.3))
    sp = os.path.join(root, "sparse", "0")
    ims = tcu.read_images_binary(os.path.join(sp, "images.bin"))
    pts = tcu.read_points3d_binary(os.path.join(sp, "points3D.bin"))
    for im in ims.values():
        m = np.load(os.path.join(root, "depths",
                                 im.name.replace(".png", ".npy")))
        P = np.array([pts[i].xyz for i in im.point3D_ids])
        z = (P @ im.qvec2rotmat().T + im.tvec)[:, 2]
        u = np.clip(im.xys.astype(int), 0, 63)
        r = np.abs(m[u[:, 1], u[:, 0]] - (0.7 * z + 0.3)) / (0.7 * z + 0.3)
        assert len(z) > 30 and (r < 0.01).mean() >= 0.75, (r < 0.01).mean()


def test_dense_depth_without_maps_raises(tmp_path):
    root = str(tmp_path / "c")
    generate_colmap_dataset(root, H=24, W=24, n_images=4, n_points=100)
    with pytest.raises(RuntimeError, match="dense depth missing"):
        tload_colmap(_tcfg(root, ["--data_format", "colmap",
                                  "--enable_dense_depth"]), "train")


# ------------------------------------------------- the progressive capture
FIXTURES = REPO / "nerf2mesh_tpu_torch" / "fixtures"
CAPTURE = FIXTURES / "progressive"
CAPTURE_VIEWS = dict(n_train=8, n_val=2, n_test=2)


def _sha(a):
    return {"sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest(), "dtype": str(a.dtype), "shape": list(a.shape)}


def write_progressive_fixture(out_dir=CAPTURE):
    """Writes the committed capture: the synthetic blender scene at 256^2,
    12 views (8 train, 2 val, 2 test), each saved by Pillow as a
    progressive 4:2:0 JPEG (quality 75, optimized tables) of its RGBA over
    a white background, the transforms pointing at the .jpg files; and progressive.json, the
    SHA-256, dtype and shape of each file's np.asarray(Image.open(...))."""
    import tempfile
    tmp = tempfile.mkdtemp()
    root = jgen(os.path.join(tmp, "scene"), H=256, W=256, **CAPTURE_VIEWS)
    shutil.rmtree(out_dir, ignore_errors=True)
    hashes = {}
    for split in ("train", "val", "test"):
        meta = json.loads(Path(root, f"transforms_{split}.json").read_text())
        (out_dir / split).mkdir(parents=True)
        for fr in meta["frames"]:
            src = Path(root, fr["file_path"] + ".png")
            rel = fr["file_path"].lstrip("./") + ".jpg"
            with Image.open(src) as im:
                rgba = np.asarray(im.convert("RGBA"), np.float32) / 255
            rgb = rgba[..., :3] * rgba[..., 3:] + 1 - rgba[..., 3:]
            Image.fromarray(np.round(rgb * 255).astype(np.uint8)).save(
                out_dir / rel, "JPEG", quality=75, progressive=True,
                optimize=True)
            with Image.open(out_dir / rel) as im:
                hashes[rel] = _sha(np.asarray(im))
            fr["file_path"] = "./" + rel
        Path(out_dir, f"transforms_{split}.json").write_text(
            json.dumps(meta, indent=1) + "\n")
    (FIXTURES / "progressive.json").write_text(
        json.dumps(hashes, indent=1) + "\n")
    shutil.rmtree(tmp)


def test_committed_progressive_capture():
    want = json.loads((FIXTURES / "progressive.json").read_text())
    assert len(want) == sum(CAPTURE_VIEWS.values())
    for rel, h in want.items():
        data = (CAPTURE / rel).read_bytes()
        assert data[:2] == b"\xff\xd8" and b"\xff\xc2" in data, rel
        with Image.open(io.BytesIO(data)) as im:
            assert _sha(np.asarray(im)) == h, rel
        assert _sha(jpeg.decode_jpeg(data)) == h, rel
    jcfg = jparse([str(CAPTURE), "--bound", "1", "--scale", "0.8"])
    tcfg = tparse([str(CAPTURE), "--bound", "1", "--scale", "0.8"])
    for split in ("train", "val"):
        j, t = jload(jcfg, split), tload(tcfg, split)
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.poses, j.poses)


if __name__ == "__main__":
    write_progressive_fixture()
