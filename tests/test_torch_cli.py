"""The port's CLI (nerf2mesh_tpu_torch.main) end to end on the CPU at the
small-table ref layout, with Pillow and JAX blocked, so that the PNG codec
writes and reads the scene and the eval images, the video falls back to an
.npz and the JPEG writer writes the textures: stage 0 with the sharpen
phase, and the two-stage flow (mesh export, stage 1 with a refine, the
textured export, --test and a reload); the unbounded flow on a COLMAP
capture at bound 4 (three cascades, the views' near/far); stage-1
checkpoints between the JAX package and the port both ways; mlp.json through the viewer emulation; the
orbax backend's round trip; and
the CLI's and the Trainer's refusal to run without a card unless the
caller asks for the CPU.
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


def test_two_stage_cli_on_the_cpu(tmp_path):
    """Stage 0 with the culled mesh export at 32^3, stage 1 for 8 steps
    with a refine at step 4 and the textured export at 64^2, then --test,
    with Pillow and JAX blocked (the port's PNG and JPEG codecs); a fresh
    stage-1 Trainer reloads the checkpoint and reproduces its val PSNR."""
    code = f"""
import sys
for m in ("PIL", "jax", "nerf2mesh_tpu"):
    sys.modules[m] = None
import json, math, os
import numpy as np
import torch
torch.set_num_threads(2)
from nerf2mesh_tpu_torch.config import parse_args
from nerf2mesh_tpu_torch.data.jpeg import decode_jpeg
from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
from nerf2mesh_tpu_torch.main import main
from nerf2mesh_tpu_torch.meshing.io import read_ply
from nerf2mesh_tpu_torch.utils.convert import read_jax_checkpoint
from nerf2mesh_tpu_torch.utils.trainer import Trainer
root, ws = {str(tmp_path / "scene")!r}, {str(tmp_path / "ws")!r}
generate_synthetic_dataset(root, H=32, W=32, n_train=6, n_val=2, n_test=2)
argv = [root, "--workspace", ws, "--bound", "1", "--scale", "0.8",
        "--dt_gamma", "0", "--num_rays", "256", "--num_points", "4096",
        "--grid_size", "32", "--num_levels", "6", "--grid_layout", "ref",
        "--log2_hashmap_size", "14", "--random_image_batch",
        "--mark_untrained", "--lr", "0.05", "--n_eval", "1", "--n_ckpt", "1",
        "--test_no_video"]
t0 = main(argv + ["--iters", "{ITERS}", "--mcubes_reso", "32",
                  "--mesh_visibility_culling"], device="cpu")
v, f = read_ply(os.path.join(ws, "mesh_stage0", "mesh_0.ply"))
assert len(f) > 0, f.shape
assert set(t0.stats["mesh_seconds"]) == {{"density", "mcubes", "cull",
                                         "clean_decimate"}}
s1 = argv + ["--stage", "1", "--iters", "8", "--refine",
             "--refine_steps_ratio", "0.5", "--texture_size", "64"]
t1 = main(s1, device="cpu")
assert t1.step == 8 and t1.stats["refines"][0][0] == 4, t1.stats
assert all(math.isfinite(e["loss"]) and e["overflow"] == 0
           for e in t1.train_log), t1.train_log
out = os.path.join(ws, "mesh_stage1")
assert sorted(os.listdir(out)) == ["feat0_0.jpg", "feat1_0.jpg",
                                   "mesh_0.mtl", "mesh_0.obj", "mlp.json"]
for n in ("feat0_0.jpg", "feat1_0.jpg"):
    img = decode_jpeg(open(os.path.join(out, n), "rb").read())
    assert img.shape == (64, 64, 3), img.shape
mlp = json.load(open(os.path.join(out, "mlp.json")))
assert len(mlp["net.0.weight"]) == 6 and mlp["cascade"] == 1
saved = read_jax_checkpoint(os.path.join(ws, "checkpoints",
                                         "ngp_stage1_latest.ckpt"))
psnr = saved["stats"]["results"][0]["PSNR"]
t2 = main(s1 + ["--test"], device="cpu")
assert t2.step == 8
cfg = parse_args(s1)
fresh = Trainer(cfg, device="cpu")
fresh.setup_stage1(load_nerf_dataset(cfg, "train"))
assert fresh.load_checkpoint() and fresh.step == 8
res = fresh.evaluate(load_nerf_dataset(cfg, "val"), track_best=False)
assert abs(res["PSNR"] - psnr) <= 1e-4, (res, psnr)
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


def test_colmap_cascade_cli_on_the_cpu(tmp_path):
    """--data_format colmap --bound 4 --enable_cam_near_far through both
    stages at 32^2 with Pillow and JAX blocked, as tests/test_cascade_e2e.py
    runs the JAX CLI: the inner mesh within the unit box, an outer
    cascade's mesh past it and within the bound, then stage 1 over every
    cascade's mesh and one OBJ set a cascade."""
    code = f"""
import sys
for m in ("PIL", "jax", "nerf2mesh_tpu"):
    sys.modules[m] = None
import json, math, os
import numpy as np
import torch
torch.set_num_threads(2)
from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset
from nerf2mesh_tpu_torch.main import main
from nerf2mesh_tpu_torch.meshing.io import read_ply
root, ws = {str(tmp_path / "scene")!r}, {str(tmp_path / "ws")!r}
generate_colmap_dataset(root, H=32, W=32, n_images=12, n_points=400)
argv = [root, "--workspace", ws, "--data_format", "colmap", "--bound", "4",
        "--scale", "1", "--enable_cam_near_far", "--num_rays", "256",
        "--num_points", "8192", "--samples_per_ray", "32", "--max_steps",
        "64", "--grid_size", "32", "--num_levels", "6", "--log2_hashmap_size",
        "14", "--random_image_batch", "--n_eval", "1", "--n_ckpt", "1",
        "--test_no_video"]
t0 = main(argv + ["--ckpt", "scratch", "--diffuse_step", "20", "--iters",
                  "40", "--mcubes_reso", "48", "--env_reso", "32",
                  "--decimate_target", "3000", "--clean_min_f", "0"],
          device="cpu")
assert t0.render_spec.cascades == 3 and t0._train_cnf is not None
assert all(math.isfinite(e["loss"]) for e in t0.train_log), t0.train_log
assert "outer" in t0.stats["mesh_seconds"]
mdir = os.path.join(ws, "mesh_stage0")
v0, f0 = read_ply(os.path.join(mdir, "mesh_0.ply"))
assert len(f0) > 10 and np.abs(v0).max() <= 1.0 + 1e-5
outer = sorted(p for p in os.listdir(mdir) if p != "mesh_0.ply")
assert outer == ["mesh_1.ply", "mesh_2.ply"], outer
vs = [read_ply(os.path.join(mdir, p)) for p in outer]
assert all(len(f) > 0 for _, f in vs)
assert 1.0 < max(np.abs(v).max() for v, _ in vs) <= 4.0 + 1e-4
t1 = main(argv + ["--stage", "1", "--iters", "8", "--lr_vert", "1e-4",
                  "--texture_size", "64", "--s1_crop", "32"], device="cpu")
assert t1.step == 8 and len(t1.stage1_mesh.v_cumsum) == 4
assert all(math.isfinite(e["loss"]) and e["overflow"] == 0
           for e in t1.train_log), t1.train_log
out = os.path.join(ws, "mesh_stage1")
objs = sorted(p for p in os.listdir(out) if p.endswith(".obj"))
assert objs == ["mesh_0.obj", "mesh_1.obj", "mesh_2.obj"], objs
mlp = json.load(open(os.path.join(out, "mlp.json")))
assert mlp["bound"] == 4.0 and mlp["cascade"] == 3
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


def test_sdf_cli_pretrains_skips_sharpen_and_runs_stage1(tmp_path,
                                                         monkeypatch):
    """--sdf --ckpt scratch at 32^2, 6 levels of the ref table: the
    double-sphere pretrain runs (cut to 200 steps of 2048 points for the
    CPU), the sharpen phase does not (the JAX CLI skips it under SDF), and
    the SDF mesh is written; then --stage 1 --iters 4 loads it and the
    stage-0 checkpoint, trains the offsets through the field query and
    writes mesh_stage1/."""
    from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
    from nerf2mesh_tpu_torch.meshing.io import read_ply
    root = generate_synthetic_dataset(str(tmp_path / "scene"), H=32, W=32,
                                      n_train=6, n_val=2, n_test=2)
    ws = tmp_path / "ws"
    pretrains = []
    real = Trainer.sdf_pretrain

    def short(self, iters=2000, batch_size=8192, points=None):
        pretrains.append((iters, batch_size))
        return real(self, iters=200, batch_size=2048)

    monkeypatch.setattr(Trainer, "sdf_pretrain", short)
    argv = [root, "--workspace", str(ws), "--sdf", "--bound", "1",
            "--scale", "0.8", "--dt_gamma", "0", "--num_rays", "256",
            "--num_points", "4096", "--grid_size", "32", "--num_levels", "6",
            "--grid_layout", "ref", "--log2_hashmap_size", "14",
            "--random_image_batch", "--mark_untrained", "--n_eval", "1",
            "--n_ckpt", "1", "--test_no_video"]
    t0 = main(argv + ["--ckpt", "scratch", "--iters", "8", "--sharpen_steps",
                      "4", "--mcubes_reso", "32"], device="cpu")
    assert pretrains == [(2000, 8192)]
    assert t0.cfg.sharpen_steps == 4 and t0.step == 8
    assert [e["step"] for e in t0.train_log][-1] == 8
    assert all(np.isfinite(e["loss"]) for e in t0.train_log)
    v, f = read_ply(str(ws / "mesh_stage0" / "mesh_0.ply"))
    assert len(f) > 0
    t1 = main(argv + ["--stage", "1", "--iters", "4", "--texture_size", "64"],
              device="cpu")
    assert pretrains == [(2000, 8192)] and t1.step == 4
    assert t1.cfg.enable_offset_nerf_grad and not t1.cfg.s1_stochastic
    assert all(np.isfinite(e["loss"]) and e["overflow"] == 0
               for e in t1.train_log), t1.train_log
    assert float(t1.vertices_offsets.detach().abs().max()) > 0
    assert sorted(os.listdir(ws / "mesh_stage1")) == [
        "feat0_0.jpg", "feat1_0.jpg", "mesh_0.mtl", "mesh_0.obj", "mlp.json"]


def stage1_workspace(tmp_path):
    """A 32^2 scene and a workspace holding a stage-0 icosphere mesh; the
    stage-1 configs of both packages for it."""
    import nerf2mesh_tpu.config as jconfig
    from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
    from nerf2mesh_tpu_torch.meshing.io import write_ply
    from nerf2mesh_tpu_torch.meshing.meshops import midpoint_subdivide
    root = generate_synthetic_dataset(str(tmp_path / "scene"), H=32, W=32,
                                      n_train=4, n_val=1, n_test=0)
    ws = tmp_path / "ws"
    (ws / "mesh_stage0").mkdir(parents=True)
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
                  [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    for _ in range(3):
        v, f = midpoint_subdivide(v, f, np.ones(len(f), bool))
    v = 0.45 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    write_ply(str(ws / "mesh_stage0" / "mesh_0.ply"), v, f)
    kw = dict(path=root, workspace=str(ws), bound=1.0, scale=0.8,
              num_levels=6, log2_hashmap_size=14, grid_size=32, stage=1,
              iters=100, s1_snap_surface=False)
    return (dataclasses.replace(jconfig.Config(), **kw).finalize(),
            dataclasses.replace(Config(), **kw).finalize())


def test_jax_stage1_checkpoint_loads_into_the_port(tmp_path):
    import jax.numpy as jnp
    import optax.tree_utils as otu
    from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
    from nerf2mesh_tpu.utils import trainer as jtr
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    jcfg, tcfg = stage1_workspace(tmp_path)
    jt = jtr.Trainer(jcfg)
    jt.setup_stage1(jload(jcfg, "train"))
    rng = np.random.default_rng(0)
    offs = jt.state.params["vertices_offsets"]
    offs = jnp.asarray(0.01 * rng.standard_normal(offs.shape), jnp.float32)
    params = dict(jt.state.params, vertices_offsets=offs)
    jt.state = jt.state._replace(
        params=params, ema_params=params, step=jnp.asarray(5, jnp.int32),
        opt_state=otu.tree_set(jt.state.opt_state,
                               count=jnp.asarray(5, jnp.int32)))
    jt.save_checkpoint()

    t = Trainer(tcfg, device="cpu")
    t.setup_stage1(load_nerf_dataset(tcfg, "train"))
    assert t._s1_real_shape == jt._s1_real_shape
    assert t.load_checkpoint()
    np.testing.assert_array_equal(t.vertices_offsets.detach().numpy(),
                                  np.asarray(offs))
    np.testing.assert_array_equal(t.params.table.detach().numpy(),
                                  np.asarray(params["table"]))
    assert t.step == 5 and t.lr_scheduler.last_epoch == 5
    st = t.optimizer.state[t.vertices_offsets]
    assert int(st["step"]) == 5 and st["exp_avg"].shape == offs.shape


def test_port_stage1_checkpoint_loads_into_jax(tmp_path):
    import jax
    from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
    from nerf2mesh_tpu.utils import trainer as jtr
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    from nerf2mesh_tpu_torch.utils.convert import write_jax_checkpoint
    jcfg, tcfg = stage1_workspace(tmp_path)
    t = Trainer(tcfg, device="cpu")
    t.setup_stage1(load_nerf_dataset(tcfg, "train"))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        t.vertices_offsets.copy_(torch.from_numpy(
            0.01 * rng.standard_normal(tuple(t.vertices_offsets.shape))))
    t.step = 7
    for p in (t.vertices_offsets, t.params.table):
        t.optimizer.state[p] = {
            "step": torch.tensor(7.0),
            "exp_avg": torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)),
            "exp_avg_sq": torch.rand(tuple(p.shape))}
    path = str(tmp_path / "port_stage1.ckpt")
    write_jax_checkpoint(t._payload(), path)

    jt = jtr.Trainer(jcfg)
    jt.setup_stage1(jload(jcfg, "train"))
    assert jt.load_checkpoint(path)
    assert int(jt.state.step) == 7
    np.testing.assert_array_equal(
        np.asarray(jt.state.params["vertices_offsets"]),
        t.vertices_offsets.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jt.state.params["table"]),
                                  t.params.table.detach().numpy())
    inner = jt.state.opt_state.inner_states
    adam = inner["vert"].inner_state[0]
    assert int(adam.count) == 7
    np.testing.assert_array_equal(
        np.asarray(adam.mu["vertices_offsets"]),
        t.optimizer.state[t.vertices_offsets]["exp_avg"].numpy())
    np.testing.assert_array_equal(
        np.asarray(inner["base"].inner_state[0].nu["table"]),
        t.optimizer.state[t.params.table]["exp_avg_sq"].numpy())
    assert jax.tree_util.tree_structure(jt.state.opt_state) == \
        jax.tree_util.tree_structure(jt.optimizer.init(jt.state.params))


def test_mlp_json_passes_the_viewer_emulation(tmp_path):
    """The port's mlp.json through tests/test_export_contract.py's port of
    the reference viewer reproduces the port's specular network."""
    import json
    from test_export_contract import _evaluate_network, _weight_texture
    from nerf2mesh_tpu_torch.meshing.export import write_mlp_json
    from nerf2mesh_tpu_torch.models.mlp import MLP
    net = MLP(6, 3, 32, 2, torch.Generator().manual_seed(5))
    path = write_mlp_json([layer.w for layer in net], 1.0, 1, str(tmp_path))
    mlp = json.load(open(path))
    assert set(mlp) == {"net.0.weight", "net.1.weight", "bound", "cascade"}
    w0 = _weight_texture(mlp["net.0.weight"])
    w1 = _weight_texture(mlp["net.1.weight"])
    rng = np.random.default_rng(3)
    for _ in range(16):
        f0 = rng.uniform(0, 1, 3).astype(np.float32)
        d = rng.standard_normal(3).astype(np.float32)
        d /= np.linalg.norm(d)
        want = torch.sigmoid(net(torch.from_numpy(
            np.concatenate([d, f0])[None])))[0].detach().numpy()
        np.testing.assert_allclose(_evaluate_network(w0, w1, 32, f0, d),
                                   want, atol=1e-5)


def test_unported_cli_paths_raise(tmp_path):
    # dtu and --vis_pose run (tests/test_torch_vis_pose.py), and so does
    # data parallelism under a launcher (tests/test_torch_parallel.py);
    # --mesh_shape 2 in one process says how to launch, before any work
    base = [str(tmp_path), "--workspace", str(tmp_path / "ws"), "--bound",
            "1", "--num_levels", "4", "--log2_hashmap_size", "12",
            "--grid_size", "16", "--test_no_mesh"]
    for argv in (base + ["--mesh_shape", "2"], base[:-1] + ["--mesh_shape",
                                                            "2", "1"]):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            main(argv, device="cpu")
    assert not (tmp_path / "ws").exists()
    cfg = dataclasses.replace(Config(), bound=1.0, num_levels=4,
                              log2_hashmap_size=12, grid_size=16,
                              workspace=str(tmp_path / "ws"),
                              ckpt_backend="orbax").finalize()
    # orbax checkpoints are ported: the .ocp directory round-trips, and so
    # does the same state rewritten by orbax as zarr3 (use_zarr3)
    t = Trainer(cfg, device="cpu")
    t.step = 3
    t.save_checkpoint()
    ocp = tmp_path / "ws" / "checkpoints" / "ngp_stage0_latest.ocp"
    assert (ocp / "_METADATA").is_file()
    t2 = Trainer(cfg, device="cpu")
    assert t2.load_checkpoint() and t2.step == 3
    import orbax.checkpoint as orbax_ckpt
    with orbax_ckpt.PyTreeCheckpointer() as c:
        raw = c.restore(str(ocp))
    z3 = tmp_path / "z3.ocp"
    with orbax_ckpt.Checkpointer(orbax_ckpt.PyTreeCheckpointHandler(
            use_zarr3=True)) as c:
        c.save(str(z3), raw)
    (z3 / "n2m_meta.json").write_bytes((ocp / "n2m_meta.json").read_bytes())
    t3 = Trainer(cfg, device="cpu")
    assert t3.load_checkpoint(str(z3)) and t3.step == 3
    for a, b in zip(t2.params.parameters(), t3.params.parameters()):
        assert torch.equal(a, b)


def test_stage1_export_matches_jax(tmp_path):
    """export_stage1 of the port (its bake rasterizes each 256^2 tile's own
    faces and queries the field for many tiles at once) against the JAX
    package's (all faces, one query a tile) on the same mesh, offsets and
    weights: the same OBJ, and textures that decode within one level on
    99% of the texels.  (The thin-shell bake is the same loop over 4
    layers; compiling JAX's shell bake on the CPU takes a minute.)"""
    import jax.numpy as jnp
    from PIL import Image
    from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
    from nerf2mesh_tpu.utils import trainer as jtr
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    from nerf2mesh_tpu_torch.utils.convert import load_params, params_from_jax
    jcfg, tcfg = stage1_workspace(tmp_path)
    jcfg = dataclasses.replace(jcfg, ssaa=1)
    tcfg = dataclasses.replace(tcfg, ssaa=1)
    jt = jtr.Trainer(jcfg)
    jt.setup_stage1(jload(jcfg, "train"))
    rng = np.random.default_rng(2)
    params = dict(jt.state.params)
    params["table"] = jnp.asarray(rng.uniform(
        -0.5, 0.5, params["table"].shape).astype(np.float32))
    offs = 0.01 * rng.standard_normal(params["vertices_offsets"].shape)
    params["vertices_offsets"] = jnp.asarray(offs, jnp.float32)
    jt.state = jt.state._replace(params=params)
    t = Trainer(tcfg, device="cpu")
    t.setup_stage1(load_nerf_dataset(tcfg, "train"))
    field = {k: v for k, v in params.items() if k != "vertices_offsets"}
    load_params(t.params, params_from_jax(field))
    with torch.no_grad():
        t.vertices_offsets.copy_(torch.from_numpy(np.array(
            params["vertices_offsets"])))
    jt.workspace = str(tmp_path / "j")
    t.workspace = str(tmp_path / "t")
    jt.export_stage1(resolution=320)
    t.export_stage1(resolution=320)
    jd, td = tmp_path / "j" / "mesh_stage1", tmp_path / "t" / "mesh_stage1"
    assert (jd / "mesh_0.obj").read_text() == (td / "mesh_0.obj").read_text()
    for n in ("feat0_0.jpg", "feat1_0.jpg"):
        a = np.asarray(Image.open(jd / n)).astype(int)
        b = np.asarray(Image.open(td / n)).astype(int)
        assert a.shape == b.shape == (320, 320, 3)
        assert (np.abs(a - b) <= 1).mean() >= 0.99, n
