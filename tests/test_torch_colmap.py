"""The port's COLMAP reader (nerf2mesh_tpu_torch.data.colmap) and its copy
of the binary format module against the JAX package's, on small scenes
written here by both packages' ``generate_colmap_dataset`` (32^2, 10
views, 300 sparse points).

``colmap_utils`` is a copy: its source below the docstring is the JAX
module's, the files each package writes are byte-equal, and each reads
what the other writes.  ``load_colmap_dataset`` must give the JAX reader's
arrays for the train, val and test splits, with --enable_cam_center on and
off, the auto-scale of --scale -1 and a fixed scale, the circle
trajectory, a mask folder, the images_{downscale} folder with a
SIMPLE_RADIAL camera, and a view that sees no sparse point: poses,
intrinsics, projection, MVPs, cam_near_far and pts_aabb within 1e-6 (both
do the same float64 numpy arithmetic, so they agree to the bit), images
bit-equal.  What the reader does not port raises, naming its ROADMAP item.
"""

import dataclasses
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from nerf2mesh_tpu.config import parse_args as jparse
from nerf2mesh_tpu.data import colmap_utils as jcu
from nerf2mesh_tpu.data.colmap import load_colmap_dataset as jload
from nerf2mesh_tpu.data.synthetic import generate_colmap_dataset as jgen
from nerf2mesh_tpu_torch.config import parse_args as tparse
from nerf2mesh_tpu_torch.data import colmap_utils as tcu
from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset as tload
from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset as tgen

REPO = Path(__file__).resolve().parent.parent
SCENE = dict(H=32, W=32, n_images=10, n_points=300)
BINS = ("cameras.bin", "images.bin", "points3D.bin")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX's scene, the port's scene) from the same seed."""
    root = tmp_path_factory.mktemp("colmap")
    jgen(str(root / "j"), **SCENE)
    tgen(str(root / "t"), **SCENE)
    return str(root / "j"), str(root / "t")


def _body(path):
    src = Path(path).read_text()
    return src[src.index('"""\n\nfrom __future__') + 4:]


def test_colmap_utils_is_a_copy(scenes, tmp_path):
    assert _body(REPO / "nerf2mesh_tpu" / "data" / "colmap_utils.py") == \
        _body(REPO / "nerf2mesh_tpu_torch" / "data" / "colmap_utils.py")
    jroot, _ = scenes
    sp = os.path.join(jroot, "sparse", "0")
    readers = ("read_cameras_binary", "read_images_binary",
               "read_points3d_binary")
    writers = ("write_cameras_binary", "write_images_binary",
               "write_points3d_binary")
    for name, rd, wr in zip(BINS, readers, writers):
        jm = getattr(jcu, rd)(os.path.join(sp, name))
        tm = getattr(tcu, rd)(os.path.join(sp, name))
        assert sorted(jm) == sorted(tm)
        # each writes what the other reads, byte for byte
        getattr(tcu, wr)(jm, str(tmp_path / ("t_" + name)))
        getattr(jcu, wr)(tm, str(tmp_path / ("j_" + name)))
        a = (tmp_path / ("t_" + name)).read_bytes()
        assert a == (tmp_path / ("j_" + name)).read_bytes()
        assert a == Path(sp, name).read_bytes()
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    np.testing.assert_array_equal(tcu.rotmat2qvec(q), jcu.rotmat2qvec(q))
    qv = tcu.rotmat2qvec(q)
    np.testing.assert_array_equal(tcu.qvec2rotmat(qv), jcu.qvec2rotmat(qv))


@pytest.mark.parametrize("pillow", [True, False])
def test_generate_colmap_dataset_matches_jax(scenes, tmp_path, monkeypatch,
                                             pillow):
    """The same model files and frames; without Pillow the port writes its
    PNGs with data/png.py."""
    from PIL import Image
    jroot, troot = scenes
    if not pillow:
        monkeypatch.setitem(sys.modules, "PIL", None)
        troot = str(tmp_path / "t")
        tgen(troot, **SCENE)
        monkeypatch.delitem(sys.modules, "PIL")
    for name in BINS:
        assert Path(jroot, "sparse", "0", name).read_bytes() == \
            Path(troot, "sparse", "0", name).read_bytes(), name
    names = sorted(os.listdir(os.path.join(jroot, "images")))
    assert names == sorted(os.listdir(os.path.join(troot, "images")))
    assert len(names) == SCENE["n_images"]
    for n in names:
        a = np.asarray(Image.open(os.path.join(jroot, "images", n)))
        b = np.asarray(Image.open(os.path.join(troot, "images", n)))
        assert a.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)


def _assert_same(a, b):
    for k in ("poses", "intrinsics", "mvps", "projection", "cam_near_far",
              "pts_aabb"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_allclose(y, x, atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(b.pts3d, a.pts3d, atol=1e-6, rtol=0)
    assert (a.H, a.W, a.training) == (b.H, b.W, b.training)
    assert (a.images is None) == (b.images is None)
    if a.images is not None:
        np.testing.assert_array_equal(b.images, a.images)


@pytest.mark.parametrize("flags", [
    [], ["--enable_cam_center"], ["--scale", "0.5", "--camera_traj", "circle"],
    ["--enable_cam_center", "--enable_cam_near_far", "--bound", "16"]])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_load_colmap_dataset_matches_jax(scenes, flags, split):
    jroot, troot = scenes
    a = jload(jparse([jroot, "--bound", "4"] + flags), split)
    b = tload(tparse([troot, "--bound", "4"] + flags), split)
    _assert_same(a, b)
    if split == "test":
        assert b.images is None and b.cam_near_far is None
        assert b.num_frames == (100 if "circle" in flags else 4 * 25)
    else:
        assert b.num_frames == (2 if split == "val" else 8)
        assert (b.cam_near_far[:, 1] > b.cam_near_far[:, 0]).all()


def _rewrite(root, cams=None, strip_image=None):
    """Rewrite the model with other cameras, or with one image's points
    taken away (it then sees no sparse point)."""
    sp = os.path.join(root, "sparse", "0")
    if cams is not None:
        tcu.write_cameras_binary(cams, os.path.join(sp, "cameras.bin"))
    if strip_image is not None:
        ims = tcu.read_images_binary(os.path.join(sp, "images.bin"))
        im = ims[strip_image]
        ims[strip_image] = dataclasses.replace(
            im, xys=im.xys[:0], point3D_ids=im.point3D_ids[:0])
        tcu.write_images_binary(ims, os.path.join(sp, "images.bin"))


def test_colmap_reader_options_match_jax(scenes, tmp_path):
    """A SIMPLE_RADIAL camera at twice the size with --downscale 2 and the
    frames under images_2/, a mask folder (alpha), and a view with no
    visible sparse point ([min_near, 1000])."""
    from PIL import Image
    jroot, _ = scenes
    root = str(tmp_path / "opts")
    shutil.copytree(jroot, root)
    fl = 32 / (2 * np.tan(np.deg2rad(45) / 2))
    _rewrite(root, cams={1: tcu.Camera(1, "SIMPLE_RADIAL", 64, 64, np.array(
        [2 * fl, 32.0, 32.0, 0.01]))}, strip_image=3)
    os.rename(os.path.join(root, "images"), os.path.join(root, "images_2"))
    os.makedirs(os.path.join(root, "mask"))
    rng = np.random.default_rng(1)
    for n in os.listdir(os.path.join(root, "images_2")):
        Image.fromarray((rng.random((32, 32)) > 0.5).astype(np.uint8) * 255
                        ).save(os.path.join(root, "mask", n))
    for split in ("train", "val"):
        argv = [root, "--bound", "4", "--downscale", "2"]
        a, b = jload(jparse(argv), split), tload(tparse(argv), split)
        _assert_same(a, b)
        assert b.images.shape[-1] == 4 and b.H == 32
    b = tload(tparse([root, "--downscale", "2"]), "all")
    assert b.intrinsics[0, 0] == pytest.approx(fl, rel=1e-6)
    # image id 3 is the third view
    np.testing.assert_array_equal(b.cam_near_far[2],
                                  np.float32([0.05, 1000.0]))
    assert (np.delete(b.cam_near_far, 2, 0)[:, 1] < 1000).all()


def test_unported_colmap_options_raise(scenes, tmp_path, monkeypatch):
    """Depth supervision, resizing and JPEG captures without Pillow are
    ported (A6 (a)-(c); against JAX in tests/test_torch_captures.py), and
    so are progressive JPEG captures (A6 (a')): both read without Pillow
    as JAX's loader reads them with it."""
    from PIL import Image
    _, troot = scenes
    assert len(tload(tparse([troot, "--enable_sparse_depth"]),
                     "train").sparse_depth) == 8
    with pytest.raises(RuntimeError, match="dense depth missing"):
        tload(tparse([troot, "--enable_dense_depth"]), "train")
    # a frame whose size differs from the camera's: resized, as JAX does
    root = str(tmp_path / "resize")
    shutil.copytree(troot, root)
    p = os.path.join(root, "images", "frame_0001.png")
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(p)
    assert tload(tparse([root]), "train").images.shape == (8, 32, 32, 3)
    # a JPEG capture, then the same as progressive JPEGs
    for progressive in (False, True):
        root = str(tmp_path / f"jpeg{int(progressive)}")
        shutil.copytree(troot, root)
        sp = os.path.join(root, "sparse", "0", "images.bin")
        ims = tcu.read_images_binary(sp)
        for k, im in ims.items():
            src = os.path.join(root, "images", im.name)
            jpg = im.name.replace(".png", ".jpg")
            Image.open(src).save(os.path.join(root, "images", jpg),
                                 progressive=progressive)
            os.remove(src)
            ims[k] = dataclasses.replace(im, name=jpg)
        tcu.write_images_binary(ims, sp)
        with_pil = jload(jparse([root]), "train").images
        assert with_pil.shape == (8, 32, 32, 3)
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "PIL", None)
            np.testing.assert_array_equal(
                tload(tparse([root]), "train").images, with_pil)