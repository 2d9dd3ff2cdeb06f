"""The port's HTTP viewer (nerf2mesh_tpu_torch.viewer) on the CPU: the
server on port 0 (a free port) answers /, /render (a PNG that the port's
decoder reads, at the controller's size: the first frame at each shape is
left out, then the downscale moves against the budget), /option (dt_gamma,
max_steps, the box) and /status (the training thread advancing in 16-step
turns until cfg.iters, then done), and a stage-1 frame.  A stage-0 frame
equals ``render_image(stochastic=True)`` on the same orbit pose.  A
stress test sends more request threads than cores against the training
thread.
"""

import dataclasses
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.data.png import decode_png
from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
from nerf2mesh_tpu_torch.data.rays import orbit_pose
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
from nerf2mesh_tpu_torch.entry import uv_sphere
from nerf2mesh_tpu_torch.meshing.io import write_ply
from nerf2mesh_tpu_torch.utils.trainer import Trainer
from nerf2mesh_tpu_torch.viewer import ViewerServer

SCENE = dict(H=64, W=64, n_train=4, n_val=1, n_test=0)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfg_(**kw):
    base = dict(bound=1.0, scale=0.8, dt_gamma=0.0, iters=32, num_rays=256,
                num_points=4096, grid_size=16, num_levels=4,
                log2_hashmap_size=12, grid_layout="ref",
                random_image_batch=True, mark_untrained=True, n_ckpt=1)
    base.update(kw)
    return dataclasses.replace(Config(path=""), **base).finalize()


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=300) as r:
        return r.status, r.headers["Content-Type"], r.read()


@pytest.fixture(scope="module")
def frames():
    return render_synthetic_frames(**SCENE)


def test_viewer_serves_and_trains(tmp_path, frames):
    cfg = cfg_(workspace=str(tmp_path))
    train = dataset_from_frames(cfg, frames, "train")
    val = dataset_from_frames(cfg, frames, "val")
    t = Trainer(cfg, device="cpu")
    t.mark_untrained(train)
    v = ViewerServer(t, val, port=0, budget_ms=1e9, train_dataset=train,
                     host="127.0.0.1")
    port = v.start()
    try:
        assert port > 0
        status, kind, page = get(port, "/")
        assert status == 200 and kind == "text/html" and b"/render" in page
        shapes = []
        for _ in range(4):
            want = v.frame_shape()
            _, kind, png = get(port, "/render?theta=1.1&phi=0.3&radius=2.4")
            img = decode_png(png)
            assert kind == "image/png" and img.shape == want + (3,)
            shapes.append(img.shape[:2])
        # 64 // 4 -> 32 (the floor) twice, then 64 // 1: frames well under
        # the budget halve the downscale after each shape's first frame
        assert shapes == [(32, 32), (32, 32), (32, 32), (64, 64)], shapes
        assert v.downscale == 1
        _, kind, body = get(port, "/option?dtg=0.01&mst=256&bnd=0.5")
        assert json.loads(body) == {}
        assert t.render_spec.dt_gamma == 0.01
        assert t.render_spec.max_steps == 256
        np.testing.assert_allclose(t._aabb, [-0.5] * 3 + [0.5] * 3)
        deadline = time.time() + 300
        while not v.train_status.get("done") and time.time() < deadline:
            assert v.train_error is None, v.train_error
            time.sleep(0.2)
        _, _, body = get(port, "/status")
        st = json.loads(body)
        assert st["done"] and st["step"] == st["iters"] == 32, st
        assert np.isfinite(st["loss"]) and st["steps_per_sec"] > 0
        assert (tmp_path / "checkpoints" / "ngp_stage0_latest.ckpt").exists()
        with pytest.raises(urllib.error.HTTPError, match="404"):
            get(port, "/nothing")
    finally:
        v.close()
    assert v.train_error is None, v.train_error


def test_viewer_frame_is_the_stochastic_render(tmp_path, frames):
    cfg = cfg_(workspace=str(tmp_path), grid_layout="block512",
               num_levels=16, log2_hashmap_size=19)
    val = dataset_from_frames(cfg, frames, "val")
    t = Trainer(cfg, device="cpu")
    v = ViewerServer(t, val, port=0, host="127.0.0.1")
    port = v.start()
    try:
        H, W = v.frame_shape()
        _, _, png = get(port, "/render?theta=1.0&phi=0.7&radius=2.6")
    finally:
        v.close()
    want = t.render_image(orbit_pose(1.0, 0.7, 2.6),
                          val.intrinsics_for(0) / 4, H, W, stochastic=True)
    np.testing.assert_array_equal(
        decode_png(png), (np.clip(want["image"], 0, 1) * 255).astype(np.uint8))


def test_viewer_stage1_frame(tmp_path, frames):
    cfg = cfg_(workspace=str(tmp_path), stage=1, s1_crop=16)
    val = dataset_from_frames(cfg, frames, "val")
    v_, f_ = uv_sphere()
    (tmp_path / "mesh_stage0").mkdir()
    write_ply(str(tmp_path / "mesh_stage0" / "mesh_0.ply"), v_ * 0.8, f_)
    t = Trainer(cfg, device="cpu")
    t.setup_stage1(val)
    v = ViewerServer(t, val, port=0, host="127.0.0.1")
    port = v.start()
    try:
        imgs = [decode_png(get(port, "/render?theta=1.2&phi=0.5&radius=2.5")[2])
                for _ in range(2)]
    finally:
        v.close()
    assert imgs[0].shape == (32, 32, 3)
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].std() > 0                    # the sphere on white


def test_viewer_concurrent_requests(tmp_path, frames):
    """More request threads than cores against the training thread, with a
    short switch interval: every frame decodes, no request fails, and the
    training thread reaches cfg.iters exactly (the lock serialises every
    use of the trainer)."""
    import sys
    import threading
    cfg = cfg_(workspace=str(tmp_path), iters=48)
    train = dataset_from_frames(cfg, frames, "train")
    val = dataset_from_frames(cfg, frames, "val")
    t = Trainer(cfg, device="cpu")
    v = ViewerServer(t, val, port=0, train_dataset=train, host="127.0.0.1")
    port = v.start()
    errors, shapes = [], []

    def client(i):
        try:
            for k in range(2):
                png = get(port, f"/render?theta=1.0&phi={0.1 * (i + k)}"
                          f"&radius=2.5")[2]
                shapes.append(decode_png(png).shape)
                get(port, f"/option?dtg={0.001 * i}")
        except Exception as e:              # collected and asserted below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2 * (os.cpu_count() or 4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        assert not any(th.is_alive() for th in threads)
        deadline = time.time() + 300
        while not v.train_status.get("done") and time.time() < deadline:
            time.sleep(0.2)
    finally:
        sys.setswitchinterval(old)
        v.close()
    assert not errors, errors
    assert len(shapes) == 2 * len(threads)
    assert all(s[2] == 3 and s[0] >= 32 for s in shapes), shapes
    assert v.train_error is None, v.train_error
    assert v.train_status["done"] and t.step == 48
