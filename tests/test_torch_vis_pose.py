"""--vis_pose: the port's poses.ply (utils/vis_pose.py) byte-equal to JAX's
``write_pose_vis`` on the same poses, without and with sparse points (also
more than 20000, which both subsample), and the CLI with --vis_pose on a
DTU scene (no points) and a COLMAP capture (its sparse points): it writes
the file JAX would write for the loaded training views and trains.
"""

import os

import numpy as np
import pytest
import torch

from nerf2mesh_tpu.utils.vis_pose import write_pose_vis as jax_write
from nerf2mesh_tpu_torch.data.synthetic import (generate_colmap_dataset,
                                                generate_dtu_dataset)
from nerf2mesh_tpu_torch.main import main
from nerf2mesh_tpu_torch.utils.vis_pose import write_pose_vis


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n_points", [0, 500, 45000])
def test_pose_ply_matches_jax(tmp_path, n_points):
    rng = np.random.default_rng(n_points)
    poses = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    for p in poses:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        p[:3, :3], p[:3, 3] = q, rng.normal(size=3) * 2
    pts = (rng.normal(size=(n_points, 3)).astype(np.float32)
           if n_points else None)
    got = write_pose_vis(str(tmp_path / "port"), poses, 1.5, points=pts)
    want = jax_write(str(tmp_path / "jax"), poses, 1.5, points=pts)
    assert _read(got) == _read(want)
    header = _read(got).split(b"end_header\n")[0].decode()
    n = 4 * 3 * 16 + 7 * 64 + (len(pts[::max(1, n_points // 20000)])
                               if n_points else 0)
    assert f"element vertex {n}" in header


CLI = ["--bound", "1", "--scale", "0.8", "--dt_gamma", "0", "--iters", "4",
       "--num_rays", "256", "--num_points", "4096", "--grid_size", "16",
       "--num_levels", "4", "--log2_hashmap_size", "12", "--grid_layout",
       "ref", "--random_image_batch", "--n_eval", "1", "--n_ckpt", "1",
       "--test_no_mesh", "--test_no_video", "--vis_pose"]


@pytest.mark.parametrize("fmt", ["dtu", "colmap"])
def test_cli_vis_pose_writes_and_trains(tmp_path, fmt):
    root, ws = str(tmp_path / "scene"), str(tmp_path / "ws")
    if fmt == "dtu":
        generate_dtu_dataset(root, H=32, W=32, n_views=9)
    else:
        generate_colmap_dataset(root, H=32, W=32, n_images=6, n_points=300)
    t = main([root, "--workspace", ws, "--data_format", fmt] + CLI,
             device="cpu")
    assert t.step == 4 and np.isfinite(t.train_log[-1]["loss"])
    from nerf2mesh_tpu_torch.main import dataset_loader
    train = dataset_loader(t.cfg)(t.cfg, split="train")
    assert (train.pts3d is None) == (fmt == "dtu")
    want = jax_write(str(tmp_path / "jax"), train.poses, 1.0,
                     points=train.pts3d)
    assert _read(os.path.join(ws, "poses.ply")) == _read(want)
