"""The port's DTU reader (nerf2mesh_tpu_torch.data.dtu) against JAX's
``load_dtu_dataset`` on a 9-view DTU directory written here (random
cameras K[R|t] with a scale matrix, RGB frames and grey masks at 32x32):
``decompose_projection`` on random projections within 1e-6; every split
(train, val = every 8th view, test = the slerp path, all) at downscale 1
and 2 with poses, intrinsics, projection and MVPs within 1e-6 and the
images byte-equal (at downscale 2 Pillow's BICUBIC on RGBA against the
port's resize_bicubic); and the same load with Pillow blocked, in a
subprocess, giving the same arrays.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.data.dtu import decompose_projection as jax_decompose
from nerf2mesh_tpu.data.dtu import load_dtu_dataset as jax_load
from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.data.dtu import decompose_projection, load_dtu_dataset

REPO = Path(__file__).resolve().parent.parent
SPLITS = ("train", "val", "test", "all")
KEYS = ("poses", "intrinsics", "projection", "mvps")


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))[None, :]
    return q if np.linalg.det(q) > 0 else -q


def _projection(rng):
    K = np.array([[rng.uniform(30, 50), rng.uniform(-0.5, 0.5),
                   rng.uniform(14, 18)],
                  [0, rng.uniform(30, 50), rng.uniform(14, 18)],
                  [0, 0, 1]])
    R = _rotation(rng)
    C = rng.normal(size=3) * 3
    return K @ np.concatenate([R, -(R @ C)[:, None]], 1)


def write_dtu(root, n=9, H=32, W=32, seed=0):
    """cameras_sphere.npz (world_mat_i = s K [R|t], scale_mat_i a scale and
    a shift), image/%03d.png RGB and mask/%03d.png grey."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "image"))
    os.makedirs(os.path.join(root, "mask"))
    cams = {}
    for i in range(n):
        world = np.eye(4)
        world[:3] = _projection(rng) * rng.uniform(0.5, 2)
        scale = np.diag([1.7, 1.7, 1.7, 1.0])
        scale[:3, 3] = rng.normal(size=3) * 0.2
        cams[f"world_mat_{i}"], cams[f"scale_mat_{i}"] = world, scale
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        m = (rng.uniform(size=(H, W)) > 0.3).astype(np.uint8) * 255
        m[: H // 3] = rng.integers(0, 256, (H // 3, W), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "image", f"{i:03d}.png"))
        Image.fromarray(m).save(os.path.join(root, "mask", f"{i:03d}.png"))
    np.savez(os.path.join(root, "cameras_sphere.npz"), **cams)
    return root


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    return write_dtu(str(tmp_path_factory.mktemp("dtu") / "scan"))


def _configs(root, downscale):
    kw = dict(scale=0.8, downscale=downscale, data_format="dtu")
    return (dataclasses.replace(Config(path=root), **kw).finalize(),
            dataclasses.replace(JConfig(path=root), **kw).finalize())


def test_decompose_projection_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(32):
        P = _projection(rng) * rng.uniform(0.1, 10)
        (ki, kp), (ji, jp) = decompose_projection(P), jax_decompose(P)
        np.testing.assert_allclose(ki, ji, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(kp, jp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("downscale", [1, 2])
def test_dtu_reader_matches_jax(dtu_root, downscale):
    tcfg, jcfg = _configs(dtu_root, downscale)
    for split in SPLITS:
        got, want = load_dtu_dataset(tcfg, split), jax_load(jcfg, split)
        assert (got.H, got.W, got.training) == (want.H, want.W, want.training)
        assert got.H == 32 // downscale
        for k in KEYS:
            np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{split} {k}")
        if split == "test":
            assert got.images is None and want.images is None
            assert got.num_frames == 11
        else:
            np.testing.assert_array_equal(got.images, want.images)
            assert got.images.shape[-1] == 4
    assert load_dtu_dataset(tcfg, "val").num_frames == 2        # ids 0, 8
    assert load_dtu_dataset(tcfg, "train").num_frames == 7


def test_dtu_reader_without_pillow(dtu_root, tmp_path):
    out = tmp_path / "arrays.npz"
    code = f"""
import sys
sys.modules["PIL"] = None
import dataclasses
import numpy as np
from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.data.dtu import load_dtu_dataset
arrays = {{}}
for ds in (1, 2):
    cfg = dataclasses.replace(Config(path={dtu_root!r}), scale=0.8,
                              downscale=ds, data_format="dtu").finalize()
    for split in {SPLITS!r}:
        d = load_dtu_dataset(cfg, split)
        for k in ("poses", "intrinsics", "mvps", "images"):
            if getattr(d, k) is not None:
                arrays[f"{{ds}}_{{split}}_{{k}}"] = getattr(d, k)
np.savez({str(out)!r}, **arrays)
assert not [m for m in sys.modules if m.startswith("PIL.")]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout[-2000:] + res.stderr[-2000:]
    got = np.load(out)
    for ds in (1, 2):
        tcfg = _configs(dtu_root, ds)[0]
        for split in SPLITS:
            want = load_dtu_dataset(tcfg, split)
            for k in ("poses", "intrinsics", "mvps", "images"):
                if getattr(want, k) is not None:
                    np.testing.assert_array_equal(
                        got[f"{ds}_{split}_{k}"], getattr(want, k))
