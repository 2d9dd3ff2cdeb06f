"""The port's stage-0 training slice against nerf2mesh_tpu.utils.trainer, on
the CPU at a small size (6 levels, 2^14 tables, 32^3 grid, 256 rays, a 32^2
scene).

One step's loss and gradients are compared on identical parameters, grid
and random draws (the JAX trainer's own keys) with the exact encode
(stochastic_fine=False, the JAX CPU path): loss rtol 1e-4; MLP gradients
rtol 1e-3 with atol 1e-6 * max|g| (fp32 sums in another order through a
whole step).  The hash-table gradient is held to atol 1e-4 * max|g| and 1e-4
relative L2: the jitted JAX step fuses multiply-adds (ray directions, sample
positions, the encoder's lattice position) and sums its cumsums in blocks of
16, so sample positions differ by an ulp, which moves the lattice fraction
at the finest level by up to ~1.5e-5; a corner whose weight is itself that
small then differs in relative terms (0.4% of the entries, all below
7.7e-5 * max|g|).  Adam is compared with optax for three steps at atol 1e-7.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.config import parse_args as jparse
from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset as jgen
from nerf2mesh_tpu.utils import trainer as jtr
from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.config import parse_args as tparse
from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
from nerf2mesh_tpu_torch.models.renderer import RenderState
from nerf2mesh_tpu_torch.utils import trainer as ttr
from nerf2mesh_tpu_torch.utils.convert import load_params, params_from_jax

REPO = Path(__file__).resolve().parent.parent
SCENE = dict(H=32, W=32, n_train=6, n_val=0, n_test=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side, and torch's default of a thread per core
    in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cls, root="", **kw):
    base = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
                num_points=4096, grid_size=32, num_levels=6,
                log2_hashmap_size=14, random_image_batch=True,
                background="random", mark_untrained=True,
                adaptive_num_rays=True, diffuse_step=1000)
    base.update(kw)
    return dataclasses.replace(cls(path=root), **base).finalize()


def test_config_copy_matches_jax():
    jf = [(f.name, f.default if f.default is not dataclasses.MISSING
           else f.default_factory()) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default if f.default is not dataclasses.MISSING
           else f.default_factory()) for f in dataclasses.fields(TConfig)]
    assert jf == tf
    argv = ["/x", "-O", "--bound", "1", "--num_rays", "1024", "--no-pool_points"]
    assert dataclasses.asdict(jparse(argv)) == dataclasses.asdict(tparse(argv))


def test_adam_and_schedule_match_optax():
    cfg = tiny(TConfig, iters=2000)
    sched_j, sched_t = jtr.lr_schedule(cfg), ttr.lr_schedule(cfg)
    for it in (0, 1, 250, 500, 501, 1200, 1999):
        np.testing.assert_allclose(sched_t(it), float(sched_j(it)), rtol=1e-6)
    rng = np.random.default_rng(0)
    params = {"table": rng.uniform(-1, 1, (64, 3)).astype(np.float32),
              "sigma_net": [{"w": rng.uniform(-1, 1, (5, 4)).astype(np.float32)}]}
    opt = jtr.make_optimizer(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(v) for k, v in params_from_jax(params).items()}
    topt, tsched = ttr.make_optimizer(cfg, list(tp.values()))
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, g in params_from_jax(grads).items():
            tp[k].grad = g
        topt.step()
        tsched.step()
        for k, want in params_from_jax(jp).items():
            np.testing.assert_allclose(tp[k].detach().numpy(), want.numpy(),
                                       atol=1e-7, rtol=0, err_msg=k)


@pytest.mark.parametrize("layout,lambda_entropy", [
    ("block512", 0.0), ("ref", 0.0), ("ref", 0.1)])
def test_one_step_loss_and_grads_match_jax(tmp_path, layout, lambda_entropy):
    """block512: the splat path; ref (2^14 table): the sweep encode; with
    lambda_entropy the weight-entropy term (a tenth of the loss or more)."""
    kw = dict(stochastic_fine=False, grid_layout=layout,
              lambda_entropy=lambda_entropy)
    root = str(tmp_path / "scene")
    jgen(root, **SCENE)
    jcfg = tiny(JConfig, root, workspace=str(tmp_path / "ws"), **kw)
    jds = jload(jcfg, "train")
    jt = jtr.Trainer(jcfg)
    jt.mark_untrained(jds)
    jt.update_grid(0)

    tcfg = tiny(TConfig, **kw)
    tds = dataset_from_frames(tcfg, render_synthetic_frames(**SCENE))
    np.testing.assert_array_equal(tds.images, jds.images)
    pt = ttr.Trainer(tcfg, device="cpu", workspace=str(tmp_path / "tws"))
    load_params(pt.params, params_from_jax(jt.state.params))
    r = jt.state.render
    pt.render = RenderState(torch.tensor(np.asarray(r.density_grid)),
                            torch.tensor(np.asarray(r.occ_grid)),
                            torch.tensor(np.asarray(r.mean_density)),
                            int(r.iter_density))
    assert pt.net_spec.encode_gather_levels == jt.net_spec.encode_gather_levels

    N, Kf = 256, jcfg.samples_per_ray
    B, H, W, _ = jds.images.shape
    key = jax.random.PRNGKey(11)
    images, poses = jnp.asarray(jds.images), jnp.asarray(jds.poses)
    intr = jnp.asarray(jds.intrinsics)
    dyn = jt.dynamics(0)

    def loss_fn(p):
        return jt._loss_and_metrics(p, r, key, images, poses, intr, None,
                                    dyn, N)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jt.state.params)
    # the JAX step's draws, from its own keys (trainer.py _loss_and_metrics)
    k_img, k_pix, k_bg, k_march, _ = jax.random.split(key, 5)
    draws = {
        "img_idx": torch.tensor(np.asarray(jax.random.randint(k_img, (N,), 0, B))),
        "pix_idx": torch.tensor(np.asarray(jax.random.randint(k_pix, (N,), 0, H * W))),
        "bg": torch.tensor(np.asarray(jax.random.uniform(k_bg, (N, 3)))),
        "u": torch.tensor(np.asarray(jax.random.uniform(k_march, (N, Kf)))),
    }
    images_t, poses_t, intr_t = pt._prep_train_arrays(tds)
    loss, tm = pt._loss_and_metrics(pt.params, pt.render, images_t, poses_t,
                                    intr_t, pt.dynamics(0), N, draws)
    loss.backward()
    assert int(tm["num_points"]) == int(jm["num_points"]) > 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-4)
    jg = params_from_jax(jgrads)
    for name, p in pt.params.named_parameters():
        want = jg[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(want).max())
        if name.startswith("specular_net"):     # diffuse warmup: no gradient
            assert scale == 0 and not got.any(), name
            continue
        # the table's entries of near-zero corner weights carry ulp-level
        # position differences (see module docstring): atol 1e-4 * max|g|
        # there, and the whole gradient within 1e-4 in relative L2
        atol = (1e-4 if name == "table" else 1e-6) * scale
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol,
                                   err_msg=name)
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), name
    if layout == "ref":
        # the stochastic 1-corner estimate exists only on the splat path: a
        # ref run with stochastic_fine computes the exact encode
        pt.cfg = dataclasses.replace(pt.cfg, stochastic_fine=True)
        loss2, _ = pt._loss_and_metrics(pt.params, pt.render, images_t,
                                        poses_t, intr_t, pt.dynamics(0), N,
                                        draws)
        assert float(loss2.detach()) == float(loss.detach())


def test_sharpen_schedule_matches_jax(tmp_path):
    kw = dict(iters=100, sharpen_steps=40, sharpen_entropy=0.02,
              lambda_entropy=0.001)
    jt = jtr.Trainer(tiny(JConfig, workspace=str(tmp_path), **kw))
    pt = ttr.Trainer(tiny(TConfig, **kw), device="cpu")
    for step in (0, 99, 100, 119, 120, 139, 200):
        assert pt.dynamics(step).lambda_entropy == pytest.approx(
            float(jt.dynamics(step).lambda_entropy), rel=1e-6), step



def test_port_training_loss_falls(tmp_path):
    """30 port steps (stochastic encode, as trained on the card) on the CPU:
    finite, falling loss; the grid, ray and routing probes run."""
    cfg = tiny(TConfig, lr=0.2, n_ckpt=1, workspace=str(tmp_path))
    ds = dataset_from_frames(cfg, render_synthetic_frames(**SCENE))
    t = ttr.Trainer(cfg, device="cpu")
    t.mark_untrained(ds)
    losses = [float(t.train_steps(ds, 1)["loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < 0.9 * np.mean(losses[:8]), losses
    assert t.render.iter_density == 8 + 1          # full refresh + slab at 16
    assert t.ema_count == 30 and t.num_rays != cfg.num_rays
    last = t.train(ds, None, max_steps=32)
    assert t.step == 32 and np.isfinite(float(last["loss"]))
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "ngp_stage0_0000032.ckpt", "ngp_stage0_latest.ckpt"]


def test_unported_options_raise(tmp_path):
    # the trainer options are ported: each builds a trainer; so is orbax,
    # whose checkpoint is the JAX trainer's .ocp directory
    for kw in (dict(enable_sparse_depth=True), dict(enable_dense_depth=True),
               dict(patch_size=4), dict(color_space="linear"),
               dict(ind_dim=4), dict(trainable_density_grid=True)):
        ttr.Trainer(tiny(TConfig, **kw), device="cpu")
    t = ttr.Trainer(tiny(TConfig, ckpt_backend="orbax"), device="cpu",
                    workspace=str(tmp_path))
    path = t.save_checkpoint()
    assert path.endswith("ngp_stage0_0000000.ocp") and os.path.isfile(
        os.path.join(path, "manifest.ocdbt"))
    cfg = tiny(TConfig)
    ds = dataset_from_frames(cfg, render_synthetic_frames(**SCENE))
    # the stage-1 eval is ported; without a stage-1 mesh it says so
    with pytest.raises(RuntimeError, match="setup_stage1"):
        ttr.Trainer(cfg, device="cpu").evaluate(ds, stage1=True)


def test_port_imports_no_jax_source():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|optax|nerf2mesh_tpu)\b(?!_torch)")
    files = sorted((REPO / "nerf2mesh_tpu_torch").rglob("*.py"))
    names = {f.relative_to(REPO / "nerf2mesh_tpu_torch").as_posix()
             for f in files}
    assert {"main.py", "ops/pallas_encode.py", "utils/convert.py",
            "utils/losses.py", "data/png.py"} <= names
    files.append(REPO / "chip_smoke.py")
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.search(line)]
    assert files and not bad, bad


def test_port_runs_with_jax_and_pil_blocked(tmp_path):
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["PIL"] = None
import dataclasses
import torch
from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
from nerf2mesh_tpu_torch.utils.trainer import Trainer
cfg = dataclasses.replace(Config(), **{dict(bound=1.0, scale=0.8,
    num_rays=128, num_points=2048, grid_size=16, num_levels=4,
    log2_hashmap_size=12, mark_untrained=True,
    workspace=str(tmp_path))!r}).finalize()
frames = render_synthetic_frames(H=16, W=16, n_train=2, n_val=1, n_test=0)
ds = dataset_from_frames(cfg, frames)
t = Trainer(cfg, device="cpu")
t.mark_untrained(ds)
m = t.train_steps(ds, 1)
assert torch.isfinite(m["loss"])
assert "PSNR" in t.evaluate(dataset_from_frames(cfg, frames, "val"))
mods = [k for k in sys.modules if k.split(".")[0] in ("nerf2mesh_tpu", "jaxlib")]
assert not mods, mods
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout + res.stderr
