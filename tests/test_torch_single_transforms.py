"""The single transforms.json (what colmap2nerf.py writes) through the
port's blender reader against JAX's ``load_nerf_dataset`` in its "colmap"
mode, and the port's colmap2nerf.py against scripts/colmap2nerf.py.

A COLMAP capture from JAX's ``generate_colmap_dataset`` (32x32, 6 views)
goes through both converters: the same frames, poses and intrinsics
(within 1e-9) and sharpness scores (the port's numpy Laplacian against
cv2's, within 1e-9 relative).  Then, with grey masks under mask/, every
split (train = frames[1:], val = frames[:1], test = the 11-pose slerp,
trainval, all) at downscale 2: poses, intrinsics, projection and MVPs
within 1e-6 and the images byte-equal (cv2's INTER_AREA in JAX, its numpy
copy in the port; cv2 imports on this host).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.data.provider import load_nerf_dataset as jax_load
from nerf2mesh_tpu.data.synthetic import generate_colmap_dataset
from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset

REPO = Path(__file__).resolve().parent.parent
SPLITS = ("train", "val", "test", "trainval", "all")


def _convert(script_args, root):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, *script_args, "--path", root],
                         cwd=str(REPO), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    with open(os.path.join(root, "transforms.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    base = tmp_path_factory.mktemp("single")
    src = str(base / "capture")
    generate_colmap_dataset(src, H=32, W=32, n_images=6, n_points=200)
    port_root, jax_root = str(base / "port"), str(base / "jax")
    shutil.copytree(src, port_root)
    shutil.copytree(src, jax_root)
    got = _convert(["-m", "nerf2mesh_tpu_torch.scripts.colmap2nerf"],
                   port_root)
    want = _convert([str(REPO / "scripts" / "colmap2nerf.py")], jax_root)
    return port_root, got, want


def test_colmap2nerf_matches_jax(converted):
    _, got, want = converted
    assert sorted(got) == sorted(want)
    for k in got:
        if k != "frames":
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert len(got["frames"]) == len(want["frames"]) == 6
    for g, w in zip(got["frames"], want["frames"]):
        assert g["file_path"] == w["file_path"]
        assert g["sharpness"] == pytest.approx(w["sharpness"], rel=1e-9)
        assert g["sharpness"] != 100.0          # scored, not the fallback
        np.testing.assert_allclose(g["transform_matrix"],
                                   w["transform_matrix"], atol=1e-9)


def test_single_transforms_matches_jax(converted):
    root = converted[0]
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "mask"), exist_ok=True)
    for name in os.listdir(os.path.join(root, "images")):
        m = rng.integers(0, 256, (32, 32), dtype=np.uint8)
        Image.fromarray(m).save(os.path.join(root, "mask", name))
    kw = dict(scale=0.8, downscale=2)
    tcfg = dataclasses.replace(Config(path=root), **kw).finalize()
    jcfg = dataclasses.replace(JConfig(path=root), **kw).finalize()
    frames = {"train": 5, "val": 1, "test": 11, "trainval": 6, "all": 6}
    for split in SPLITS:
        got, want = load_nerf_dataset(tcfg, split), jax_load(jcfg, split)
        assert (got.H, got.W, got.training) == (want.H, want.W,
                                                want.training) == (
            16, 16, split in ("train", "trainval", "all"))
        assert got.num_frames == frames[split]
        for k in ("poses", "intrinsics", "projection", "mvps"):
            np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{split} {k}")
        if split == "test":
            assert got.images is None and want.images is None
        else:
            assert got.images.shape[-1] == 4            # the mask as alpha
            np.testing.assert_array_equal(got.images, want.images)
