"""Checkpoints: a JAX format-2 pickle checkpoint read by the port (without
JAX, optax or nerf2mesh_tpu importable), one further step on each side,
and the port's own save -> load round trip, on the CPU at a small size
(ref layout, 6 levels, 2^14 table, 32^3 grid, 256 rays, a 32^2 scene:
the configuration of tests/test_torch_slice.py).

The loaded state must equal the JAX state exactly.  The further step is
held to tests/test_torch_slice.py's tolerances: the loss at rtol 1e-4, the
MLP gradients (recovered from the Adam first moment, m' = 0.9 m + 0.1 g, on
identical m) at rtol 1e-3, atol 1e-6 * max|g|, and the table gradient at
1e-4 relative L2 and atol 1e-4 * max|g|.  The JAX step runs op by op
(``jax.disable_jit()``): jitted, it fuses the lattice position's multiply
and add (ROADMAP C), and after two trained steps that moved the table
gradient by 2.2e-4 relative L2; op by op it is 5.6e-5 (both measured on
the CPU).  The round trip is bit-exact, and so is training on from it.
"""

import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset as jgen
from nerf2mesh_tpu.utils import trainer as jtr
from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset as tload
from nerf2mesh_tpu_torch.utils import trainer as ttr
from nerf2mesh_tpu_torch.utils.convert import flatten_params

REPO = Path(__file__).resolve().parent.parent
SCENE = dict(H=32, W=32, n_train=4, n_val=1, n_test=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
            num_points=4096, grid_size=32, num_levels=6, log2_hashmap_size=14,
            grid_layout="ref", random_image_batch=True, background="random",
            mark_untrained=True, diffuse_step=1000, steps_per_dispatch=1,
            stochastic_fine=False)


def tiny(cls, root, ws, **kw):
    return dataclasses.replace(cls(path=root), **{**TINY, "workspace": ws,
                                                  **kw}).finalize()


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX trainer at the ref layout after 2 steps, and its checkpoint."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    root, ws = str(d / "scene"), str(d / "ws")
    jgen(root, **SCENE)
    jt = jtr.Trainer(tiny(JConfig, root, ws))
    jds = jload(jt.cfg, "train")
    jt.mark_untrained(jds)
    jt.train_steps(jds, 2)
    jt.save_checkpoint()
    return jt, jds, root, ws


def jax_state(jt):
    """The JAX state as {name: array}, in the port's names."""
    st = jt.state
    adam = st.opt_state.inner_states["base"].inner_state[0]
    out = {f"params.{k}": v for k, v in flatten_params(
        jax.tree_util.tree_map(np.asarray, st.params)).items()}
    out.update({f"ema.{k}": v for k, v in flatten_params(
        jax.tree_util.tree_map(np.asarray, st.ema_params)).items()})
    out.update({f"mu.{k}": v for k, v in flatten_params(
        jax.tree_util.tree_map(np.asarray, adam.mu)).items()})
    out.update({f"nu.{k}": v for k, v in flatten_params(
        jax.tree_util.tree_map(np.asarray, adam.nu)).items()})
    r = st.render
    out.update({"count": np.asarray(adam.count), "step": np.asarray(st.step),
                "ema_count": np.asarray(st.ema_count),
                "density_grid": np.asarray(r.density_grid),
                "occ_grid": np.asarray(r.occ_grid),
                "mean_density": np.asarray(r.mean_density),
                "iter_density": np.asarray(r.iter_density),
                "num_rays": np.asarray(jt.num_rays)})
    return out


def port_state(pt):
    """The same names from a port trainer."""
    out = {}
    for k, p in pt.params.named_parameters():
        st = pt.optimizer.state[p]
        out[f"params.{k}"] = p.detach().numpy()
        out[f"ema.{k}"] = pt.ema_params[k].numpy()
        out[f"mu.{k}"] = st["exp_avg"].numpy()
        out[f"nu.{k}"] = st["exp_avg_sq"].numpy()
        out["count"] = np.asarray(int(st["step"]))
    r = pt.render
    out.update({"step": np.asarray(pt.step),
                "ema_count": np.asarray(pt.ema_count),
                "density_grid": r.density_grid.numpy(),
                "occ_grid": r.occ_grid.numpy(),
                "mean_density": r.mean_density.numpy(),
                "iter_density": np.asarray(r.iter_density),
                "num_rays": np.asarray(pt.num_rays)})
    return out


def test_jax_checkpoint_loads_without_jax(jax_ckpt, tmp_path):
    jt, _, root, ws = jax_ckpt
    dump = tmp_path / "state.npz"
    code = f"""
import sys
for m in ("jax", "jaxlib", "optax", "nerf2mesh_tpu"):
    sys.modules[m] = None
import dataclasses
import numpy as np
from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.utils.trainer import Trainer
{inspect.getsource(port_state)}
cfg = dataclasses.replace(Config(path={root!r}), workspace={ws!r},
                          **{TINY!r}).finalize()
t = Trainer(cfg, device="cpu")
assert t.load_checkpoint()
assert abs(t.optimizer.param_groups[0]["lr"]
           - t.cfg.lr * (0.01 + 0.99 * 2 / 500)) < 1e-12
np.savez({str(dump)!r}, **port_state(t))
mods = [k for k in sys.modules if k.split(".")[0] in ("nerf2mesh_tpu",
        "jax", "jaxlib", "optax") and sys.modules[k] is not None]
assert not mods, mods
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout + res.stderr
    want = jax_state(jt)
    with np.load(dump) as got:
        assert set(got.files) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(want["step"]) == int(want["count"]) == 2


def test_step_after_jax_checkpoint_matches_jax(jax_ckpt, tmp_path):
    jt, jds, root, ws = jax_ckpt
    pt = ttr.Trainer(tiny(TConfig, root, ws), device="cpu")
    assert pt.load_checkpoint()
    before = port_state(pt)
    tds = tload(pt.cfg, "train")
    np.testing.assert_array_equal(tds.images, jds.images)

    # one JAX step from the checkpointed state, and its draws from its keys
    st, N = jt.state, jt.cfg.num_rays
    B, H, W, _ = jds.images.shape
    _, skey = jax.random.split(st.key)
    k_img, k_pix, k_bg, k_march, _ = jax.random.split(skey, 5)
    draws = {
        "img_idx": torch.tensor(np.asarray(jax.random.randint(k_img, (N,), 0, B))),
        "pix_idx": torch.tensor(np.asarray(jax.random.randint(k_pix, (N,), 0, H * W))),
        "bg": torch.tensor(np.asarray(jax.random.uniform(k_bg, (N, 3)))),
        "u": torch.tensor(np.asarray(jax.random.uniform(
            k_march, (N, jt.cfg.samples_per_ray)))),
    }
    fn = jt.step_fn_for(N, 1)
    images, poses, intr, _, _ = jt._prep_train_arrays(jds)
    with jax.disable_jit():
        state, jm = fn(jax.tree_util.tree_map(jnp.copy, st), images, poses,
                       intr, None, jt.dynamics(2), None)
    images_t, poses_t, intr_t = pt._prep_train_arrays(tds)
    tm = pt.train_step(images_t, poses_t, intr_t, N, pt.dynamics(2), draws)
    assert int(tm["num_points"]) == int(jm["num_points"]) > 0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)

    adam = state.opt_state.inner_states["base"].inner_state[0]
    mu_j = flatten_params(jax.tree_util.tree_map(np.asarray, adam.mu))
    after = port_state(pt)
    assert int(after["count"]) == int(np.asarray(adam.count)) == 3
    for k, want_mu in mu_j.items():
        m0 = before[f"mu.{k}"]
        want = (want_mu - 0.9 * m0) / 0.1           # the step's gradient
        got = (after[f"mu.{k}"] - 0.9 * m0) / 0.1
        scale = float(np.abs(want).max())
        if k.startswith("specular_net"):             # diffuse warmup
            assert scale == 0 and not got.any(), k
            continue
        atol = (1e-4 if k == "table" else 1e-6) * scale
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol, err_msg=k)
        assert rel <= 1e-4, k


def test_port_checkpoint_round_trip_is_exact(tmp_path):
    root, ws = str(tmp_path / "scene"), str(tmp_path / "ws")
    jgen(root, **SCENE)
    cfg = tiny(TConfig, root, ws, adaptive_num_rays=True, stochastic_fine=True)
    ds = tload(cfg, "train")
    a = ttr.Trainer(cfg, device="cpu")
    a.mark_untrained(ds)
    a.train_steps(ds, 3)
    path = a.save_checkpoint()
    assert os.path.basename(path) == "ngp_stage0_0000003.ckpt"
    b = ttr.Trainer(cfg, device="cpu")
    assert b.load_checkpoint()
    sa, sb = port_state(a), port_state(b)
    for k in sa:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    assert b.optimizer.param_groups[0]["lr"] == a.optimizer.param_groups[0]["lr"]
    # the same random stream and state: training on is bit-exact
    la = [float(a.train_steps(ds, 1)["loss"]) for _ in range(2)]
    lb = [float(b.train_steps(ds, 1)["loss"]) for _ in range(2)]
    assert la == lb
    for (k, pa), pb in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(pa, pb), k
