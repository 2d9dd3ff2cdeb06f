"""The port's CLI (nerf2mesh_tpu_torch.main) end to end on the CPU at the
small-table ref layout, sharpen phase included, with Pillow and JAX blocked,
so that the PNG codec writes and reads the scene and the eval images and
the video falls back to an .npz; and the CLI's and the Trainer's refusal to run without a card
unless the caller asks for the CPU.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.main import main
from nerf2mesh_tpu_torch.utils.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
ITERS = 24
SHARPEN = 4


def test_main_trains_checkpoints_and_reloads_without_pil(tmp_path):
    code = f"""
import sys
for m in ("PIL", "jax", "nerf2mesh_tpu"):
    sys.modules[m] = None
import math, os
import torch
torch.set_num_threads(2)
from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
from nerf2mesh_tpu_torch.main import main
root, ws = {str(tmp_path / "scene")!r}, {str(tmp_path / "ws")!r}
generate_synthetic_dataset(root, H=32, W=32, n_train=6, n_val=2, n_test=2)
argv = [root, "--workspace", ws, "--bound", "1", "--scale", "0.8",
        "--dt_gamma", "0", "--iters", "{ITERS}", "--num_rays", "256",
        "--num_points", "4096", "--grid_size", "32", "--num_levels", "6",
        "--grid_layout", "ref", "--log2_hashmap_size", "14",
        "--random_image_batch", "--mark_untrained", "--adaptive_num_rays",
        "--lr", "0.05", "--n_eval", "1", "--n_ckpt", "2", "--test_no_mesh"]
t = main(argv + ["--sharpen_steps", "{SHARPEN}"], device="cpu")
assert t.step == {ITERS + SHARPEN} and t.net_spec.grid_layout == "ref"
assert all(math.isfinite(e["loss"]) for e in t.train_log), t.train_log
assert t.train_log[-1]["step"] == {ITERS + SHARPEN}, t.train_log
assert t.dynamics({ITERS}).lambda_entropy > 0
names = [sorted(r) for r in t.stats["results"]]
assert names == [["PSNR"]] + [["LPIPS (proxy)", "PSNR", "SSIM"]] * 2, names
ck = sorted(os.listdir(os.path.join(ws, "checkpoints")))
assert ck == ["ngp_stage0_{ITERS:07d}.ckpt",
              "ngp_stage0_{ITERS + SHARPEN:07d}.ckpt",
              "ngp_stage0_best.ckpt", "ngp_stage0_latest.ckpt"], ck
assert os.path.exists(os.path.join(ws, "test_frames.npz"))
assert len(os.listdir(os.path.join(ws, "validation"))) == 12
# the sharpened state, which the latest checkpoint holds
from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
from nerf2mesh_tpu_torch.utils.metrics import PSNRMeter
t.metrics = [PSNRMeter()]
test_psnr = t.evaluate(load_nerf_dataset(t.cfg, split="test"))["PSNR"]
t2 = main(argv + ["--test"], device="cpu")
assert t2.step == {ITERS + SHARPEN}
assert t2.stats["results"][0]["PSNR"] == test_psnr, (t2.stats, test_psnr)
mods = [k for k in sys.modules if k.split(".")[0] in ("PIL", "jax",
        "jaxlib", "nerf2mesh_tpu") and sys.modules[k] is not None]
assert not mods, mods
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout[-3000:] + res.stderr[-3000:]
    frames = np.load(tmp_path / "ws" / "test_frames.npz")["frames"]
    assert frames.shape == (2, 32, 32, 3) and frames.dtype == np.uint8


def test_cli_without_a_card_exits_nonzero(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "nerf2mesh_tpu_torch.main", str(tmp_path),
         "--workspace", str(tmp_path / "ws")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr
    assert not (tmp_path / "ws").exists()


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    cfg = dataclasses.replace(Config(), bound=1.0, num_levels=4,
                              log2_hashmap_size=12, grid_size=16).finalize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    assert Trainer(cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("test", [False, True])
def test_cli_mesh_export_raises_before_any_work(tmp_path, test):
    """Without --test_no_mesh the run would end in the unported mesh export,
    so main raises at once, naming ROADMAP A3: no Trainer, no data read, no
    workspace file; with the flag the same command gets past that check."""
    from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
    root = generate_synthetic_dataset(str(tmp_path / "scene"), H=8, W=8,
                                      n_train=2, n_val=1, n_test=1)
    ws = tmp_path / "ws"
    argv = [root, "--workspace", str(ws), "--bound", "1", "--num_levels", "4",
            "--log2_hashmap_size", "12", "--grid_size", "16", "--iters", "1"]
    argv += ["--test"] if test else []
    built = []
    real = Trainer.__init__

    def counted(self, *a, **k):
        built.append(1)
        real(self, *a, **k)

    Trainer.__init__ = counted
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP A3"):
            main(argv, device="cpu")
        assert not built and not ws.exists()
        with pytest.raises(NotImplementedError, match="A3"):
            Trainer.save_mesh(None)
        main(argv + ["--test_no_mesh", "--test_no_video"], device="cpu")
        assert built
    finally:
        Trainer.__init__ = real


def test_unported_cli_paths_raise(tmp_path):
    base = [str(tmp_path), "--workspace", str(tmp_path / "ws"), "--bound",
            "1", "--num_levels", "4", "--log2_hashmap_size", "12",
            "--grid_size", "16", "--test_no_mesh"]
    for extra, item in ((["--data_format", "colmap"], "A7"),
                        (["--mesh_shape", "2"], "A7"),
                        (["--stage", "1"], "A4"), (["--sdf"], "A5")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            main(base + extra, device="cpu")
        # stage 1 and SDF name their own item with or without the flag
        if item in ("A4", "A5"):
            with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
                main(base[:-1] + extra, device="cpu")
    cfg = dataclasses.replace(Config(), bound=1.0, num_levels=4,
                              log2_hashmap_size=12, grid_size=16,
                              workspace=str(tmp_path / "ws"),
                              ckpt_backend="orbax").finalize()
    t = Trainer(cfg, device="cpu")
    for fn in (t.save_checkpoint, t.save_mesh, t.export_stage1):
        with pytest.raises(NotImplementedError):
            fn()
    (tmp_path / "ws" / "checkpoints" / "ngp_stage0_latest.ocp").mkdir(
        parents=True)
    with pytest.raises(NotImplementedError):
        t.load_checkpoint()
