"""The port's blender reader (nerf2mesh_tpu_torch.data.provider) against
JAX's ``load_nerf_dataset`` on small scenes written here: intrinsics from
``fl_x`` / ``fl_y`` / ``cx`` / ``cy`` or ``camera_angle_y``, the size from
``h`` / ``w`` or the first image, and a ``mask`` directory read as alpha.
Poses, images, intrinsics, projection and MVPs must be equal (exactly: both
read the same PNGs and do the same float32 arithmetic).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.data.provider import load_nerf_dataset as jax_load
from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset

H, W = 12, 16


def _pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = q, rng.normal(size=3) * 2
    return pose.tolist()


def write_scene(root, keys, channels=3, mask=True, n=3, seed=0):
    """A blender split file with `keys` and n frames under images/ (RGB or
    RGBA PNGs), with grayscale masks under mask/ when `mask`."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "mask"))
    frames = []
    for i in range(n):
        img = rng.integers(0, 256, (H, W, channels), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", f"r_{i}.png"))
        if mask:
            m = rng.integers(0, 256, (H, W), dtype=np.uint8)
            Image.fromarray(m).save(os.path.join(root, "mask", f"r_{i}.png"))
        frames.append({"file_path": f"./images/r_{i}", "transform_matrix": _pose(rng)})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({**keys, "frames": frames}, f)
    return root


def _configs(root, **kw):
    return (dataclasses.replace(Config(path=root), scale=0.8, **kw).finalize(),
            dataclasses.replace(JConfig(path=root), scale=0.8, **kw).finalize())


@pytest.mark.parametrize("case", ["fl_cx_hw_mask", "fl_y_rgba_mask",
                                  "angle_y_rgb"])
def test_blender_reader_matches_jax(tmp_path, case):
    if case == "fl_cx_hw_mask":
        keys, channels, mask = dict(fl_x=20.5, fl_y=21.25, cx=7.5, cy=6.25,
                                    h=H, w=W), 3, True
    elif case == "fl_y_rgba_mask":
        keys, channels, mask = dict(fl_y=18.0, h=H, w=W), 4, True
    else:
        keys, channels, mask = dict(camera_angle_y=0.9), 3, False
    root = write_scene(str(tmp_path / "scene"), keys, channels, mask)
    cfg, jcfg = _configs(root)
    got, want = load_nerf_dataset(cfg, "train"), jax_load(jcfg, "train")
    assert (got.H, got.W) == (want.H, want.W) == (H, W)
    for name in ("poses", "images", "intrinsics", "projection", "mvps"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.images.shape[-1] == (4 if mask or channels == 4 else 3)
    if mask:                       # the mask replaced the alpha channel
        m = np.asarray(Image.open(os.path.join(root, "mask", "r_0.png")))
        np.testing.assert_array_equal(got.images[0, ..., 3], m)
    if case == "fl_y_rgba_mask":
        assert got.intrinsics.tolist() == [18.0, 18.0, W / 2, H / 2]


def test_blender_reader_raises_on_what_is_not_ported(tmp_path):
    # resizing to the json's size and downscale are ported (A6; against
    # JAX in tests/test_torch_captures.py)
    root = write_scene(str(tmp_path / "a"), dict(fl_x=20.0, h=H + 1, w=W))
    assert load_nerf_dataset(_configs(root)[0], "train").H == H + 1
    root = write_scene(str(tmp_path / "b"), dict(fl_x=20.0))
    assert load_nerf_dataset(_configs(root, downscale=2)[0],
                             "train").H == H // 2
    with pytest.raises(FileNotFoundError):       # no val split written
        load_nerf_dataset(_configs(root)[0], "trainval")
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"frames": []}, f)
    # the single transforms.json is ported (tests/test_torch_single_
    # transforms.py); one without frames has nothing to stack, as in JAX
    for load, cfg in zip((load_nerf_dataset, jax_load), _configs(root)):
        with pytest.raises(ValueError):
            load(cfg, "train")
    root = write_scene(str(tmp_path / "c"), dict(h=H, w=W))
    with pytest.raises(RuntimeError, match="focal"):
        load_nerf_dataset(_configs(root)[0], "train")
