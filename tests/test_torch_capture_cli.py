"""The port's CLI on a real-capture recipe with Pillow, cv2, sklearn and JAX
blocked by a meta-path hook: a runall_sdf_outdoor.sh-style COLMAP capture
(4:2:0 JPEG frames at 128^2 decoded and downscaled 4x, dense depth maps at
48^2 with 5% outliers) through stages 0 and 1; the LLFF recipe with sparse
depth; and a blender scene under the trainer options (downscale, trainval,
patches, linear colour, the trainable grid, per-image codes).  The SDF
pretrain is cut to 600 iterations of 2048 points, enough to form its outer
shell; the recipe's --scale 0.2 becomes 0.5 for the generator's scene
(cameras at 1.4, the environment sphere at 2.8), so that shell, at radius
2 after uncontraction, lies inside the points' box and the outer cascade
is not empty (an empty one fails stage 1 in both packages, ROADMAP C); the
SDF run passes -O's flags but the visibility cull, which the cameras
inside the marched box would make diverge (ROADMAP C); the LLFF run (-O)
has no sharpen phase and no mesh."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


BLOCKER = """
import importlib.abc, importlib.machinery, sys


class _Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise ImportError(f"{spec.name} is blocked")

    def exec_module(self, module):
        pass


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, _Refuse())
        return None


sys.meta_path.insert(0, _Block())
"""


def test_port_imports_no_pillow_cv2_or_sklearn():
    """Every module of the port and chip_smoke.py imports with Pillow, cv2,
    sklearn and JAX blocked, and none of them is loaded after."""
    mods = sorted(
        "nerf2mesh_tpu_torch." + p.relative_to(
            REPO / "nerf2mesh_tpu_torch").with_suffix("").as_posix()
        .replace("/", ".")
        for p in (REPO / "nerf2mesh_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    assert "nerf2mesh_tpu_torch.data.resize" in mods
    code = ("BLOCKED = ('PIL', 'cv2', 'sklearn', 'jax', 'nerf2mesh_tpu')\n"
            + BLOCKER + f"""
import importlib
for m in {mods!r} + ["chip_smoke"]:
    importlib.import_module(m)
bad = [k for k in sys.modules if k.split(".")[0] in BLOCKED]
assert not bad, bad
print("ok", len({mods!r}))
""")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout[-2000:] + res.stderr[-3000:]


def test_capture_recipes_run_through_the_cli(tmp_path):
    code = ("BLOCKED = ('PIL', 'cv2', 'sklearn', 'jax', 'nerf2mesh_tpu')\n"
            + BLOCKER + f"""
import math, os
import numpy as np
import torch
torch.set_num_threads(2)
from nerf2mesh_tpu_torch.data.synthetic import (generate_colmap_dataset,
                                                generate_synthetic_dataset)
from nerf2mesh_tpu_torch.main import main
from nerf2mesh_tpu_torch.meshing.io import read_ply
from nerf2mesh_tpu_torch.utils.trainer import Trainer

real = Trainer.sdf_pretrain
Trainer.sdf_pretrain = lambda self, iters=2000, batch_size=8192, points=None: \\
    real(self, iters=600, batch_size=2048)
depth_steps = []
real_step = Trainer.train_step
def step(self, *a, **k):
    m = real_step(self, *a, **k)
    if "depth_loss" in m:
        depth_steps.append(float(m["depth_loss"]))
    return m
Trainer.train_step = step

tmp = {str(tmp_path)!r}
cap = os.path.join(tmp, "capture")
generate_colmap_dataset(cap, H=128, W=128, n_images=10, n_points=600,
                        image_format="jpeg", jpeg_quality=90,
                        depth_size=(48, 48), depth_affine=(0.7, 0.3),
                        depth_outliers=0.05)
small = ["--num_rays", "256", "--num_points", "4096", "--grid_size", "16",
         "--num_levels", "6", "--log2_hashmap_size", "12", "--max_steps",
         "256", "--n_eval", "1", "--n_ckpt", "1", "--test_no_video"]
ws = os.path.join(tmp, "sdf")
# -O's flags but the visibility cull (-O has no way to turn it off)
O = ["--fp16", "--preload", "--mark_untrained", "--random_image_batch",
     "--adaptive_num_rays", "--refine"]
sdf = [cap, "--workspace", ws, "--sdf", "--data_format", "colmap",
       "--bound", "16", "--scale", "0.5", "--downscale", "4",
       "--enable_cam_center", "--enable_cam_near_far", "--enable_dense_depth",
       "--lambda_entropy", "1e-3", "--lambda_normal", "1e-1"] + O + small
t0 = main(sdf + ["--ckpt", "scratch", "--iters", "16", "--mcubes_reso",
                 "32"], device="cpu")
assert t0.cfg.fp16 and t0.cfg.contract and t0.step == 16
assert t0._train_depth["dense"].shape == (8, 32, 32)
assert all(math.isfinite(e["loss"]) for e in t0.train_log), t0.train_log
assert len(depth_steps) == 16 and all(math.isfinite(v) for v in depth_steps)
assert max(depth_steps) > 0
for c in (0, 1):
    v, f = read_ply(os.path.join(ws, "mesh_stage0", f"mesh_{{c}}.ply"))
    assert len(f) > 0, c
t1 = main(sdf + ["--stage", "1", "--iters", "4", "--texture_size", "64"],
          device="cpu")
assert t1.step == 4 and all(math.isfinite(e["loss"]) and e["overflow"] == 0
                            for e in t1.train_log), t1.train_log
out = sorted(os.listdir(os.path.join(ws, "mesh_stage1")))
assert [n for n in out if n.endswith(".obj")] == ["mesh_0.obj",
                                                   "mesh_1.obj"], out

depth_steps.clear()
t2 = main([cap, "--workspace", os.path.join(tmp, "llff"), "-O",
           "--data_format", "colmap", "--bound", "4", "--downscale", "4",
           "--enable_cam_near_far", "--enable_sparse_depth", "--iters", "12",
           "--sharpen_steps", "-1", "--test_no_mesh"] + small, device="cpu")
assert t2.cfg.fp16 and t2.step == 12
assert not t2.cfg.random_image_batch and "sparse" in t2._train_depth
assert all(math.isfinite(e["loss"]) for e in t2.train_log)
assert len(depth_steps) == 12, depth_steps

scene = generate_synthetic_dataset(os.path.join(tmp, "blender"), H=64,
                                   W=64, n_train=4, n_val=2, n_test=1)
t3 = main([scene, "--workspace", os.path.join(tmp, "opts"), "--bound", "1",
           "--scale", "0.8", "--downscale", "2", "--train_split", "trainval",
           "--patch_size", "4", "--color_space", "linear",
           "--trainable_density_grid", "--lambda_density", "1e-4",
           "--ind_dim", "4", "--iters", "12", "--test_no_mesh"] + small,
          device="cpu")
assert t3.params.individual_codes.shape == (500, 4)
assert all(math.isfinite(e["loss"]) for e in t3.train_log)
assert all(math.isfinite(v) for r in t3.stats["results"] for v in r.values())
bad = [k for k in sys.modules if k.split(".")[0] in BLOCKED]
assert not bad, bad
print("ok")
""")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout[-3000:] + res.stderr[-3000:]
