"""The separate density and colour tables of the port's field
(``NetworkSpec(separate_tables=True)``: ``sigma_table`` [total, 1] and
``color_table`` [total, 2]) against the JAX package, on the CPU at a small
size: the field with JAX parameters converted by utils/convert.py, one
training step through the Trainer, and format-2 checkpoints written by each
package and read by the other.

Neither Trainer takes the option from its Config, so both are reached the
same way: the trainer module's ``NetworkSpec`` is patched to
``functools.partial(NetworkSpec, separate_tables=True)`` before the Trainer
is built.

Tolerances: the field's outputs atol 1e-5, rtol 1e-5; gradients
tests/test_torch_slice.py's, rtol 1e-3 with atol 1e-4 * max|g| plus 1e-4
relative L2 (the jitted JAX field fuses the lattice multiply-add, which
moves a near-zero corner weight by an ulp); the step's loss rtol 1e-4 and
its MLP gradients atol 1e-6 * max|g| (tests/test_torch_slice.py's);
checkpoints exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.models import network as jnet
from nerf2mesh_tpu_torch.models import network as tnet
from nerf2mesh_tpu_torch.utils.convert import load_params, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the separate-tables field
# ---------------------------------------------------------------------------

def sep_specs(layout):
    kw = dict(bound=1.0, num_levels=6, log2_hashmap_size=14,
              grid_layout=layout, separate_tables=True,
              encode_gather_levels=(4, 5) if layout == "block512" else ())
    return jnet.NetworkSpec(**kw), tnet.NetworkSpec(**kw)


def sep_field(jspec, tspec, seed=0):
    """JAX params with +-1 tables (the init's +-1e-4 would leave the MLPs
    blind to the encode), converted into a port field."""
    params = jnet.init_network(jax.random.PRNGKey(seed), jspec)
    rng = np.random.default_rng(seed)
    for k in ("sigma_table", "color_table"):
        params[k] = jnp.asarray(rng.uniform(-1, 1, params[k].shape)
                                .astype(np.float32))
    field = tnet.NeRFField(tspec, torch.Generator().manual_seed(1))
    load_params(field, params_from_jax(params))
    return params, field


def field_inputs(n=600, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    x[:5] = 3.0                                  # pool sentinels (oob)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return x, d


def grads_close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                               err_msg=what)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), what


def test_separate_specs_and_init():
    jspec, tspec = sep_specs("block512")
    assert (dataclasses.asdict(tspec.color_grid_spec)
            == dataclasses.asdict(jspec.color_grid_spec))
    assert tspec.density_grid_spec.level_dim == 1
    assert tspec.color_grid_spec.level_dim == 2
    merged = dataclasses.replace(tspec, separate_tables=False)
    assert merged.color_grid_spec == merged.density_grid_spec
    params, field = sep_field(jspec, tspec)
    names = {n for n, _ in field.named_parameters()}
    assert names == set(params_from_jax(params))
    assert "table" not in names


@pytest.mark.parametrize("layout", ["block512", "ref"])
@pytest.mark.parametrize("fn", ["density", "geo_feat", "field_forward"])
def test_separate_field_and_grads_match_jax(layout, fn):
    """block512: both tables through the splat path (K2/K3 at C = 1 and 2,
    gather levels 4-5); ref at a 2^14 table: the sweep encode (K4/K4b)."""
    jspec, tspec = sep_specs(layout)
    params, field = sep_field(jspec, tspec)
    x, d = field_inputs()
    rng = np.random.default_rng(7)
    jx, jd = jnp.asarray(x), jnp.asarray(d)
    if fn == "density":
        jf = lambda p: jnet.density(p, jx, jspec, jnp.int32(5))
        tf = lambda: tnet.density(field, T(x), tspec, 5)
    elif fn == "geo_feat":
        jf = lambda p: jnet.geo_feat(p, jx, jspec, None, jnp.int32(5))
        tf = lambda: tnet.geo_feat(field, T(x), tspec, 5)
    else:
        def jf(p):
            s, c, sp, _ = jnet.field_forward(p, jx, jd, jspec, jnp.asarray(True),
                                            None, jnp.int32(6))
            return jnp.concatenate([s[:, None], c, sp], -1)

        def tf():
            s, c, sp, cnt = tnet.field_forward(field, T(x), T(d), tspec, True, 6)
            assert (cnt is None) == (layout == "ref")
            return torch.cat([s[:, None], c, sp], -1)
    want, vjp = jax.vjp(jf, params)
    g = rng.normal(size=want.shape).astype(np.float32)
    jg = params_from_jax(vjp(jnp.asarray(g))[0])
    got = tf()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    got.backward(T(g))
    for name, p in field.named_parameters():
        want_g = jg[name].numpy()
        got_g = np.zeros_like(want_g) if p.grad is None else p.grad.numpy()
        if not np.abs(want_g).max():
            assert not got_g.any(), name
            continue
        grads_close(got_g, want_g, name)
    touched = {n for n, p in field.named_parameters()
               if p.grad is not None and p.grad.abs().max() > 0}
    assert ("color_table" in touched) == (fn != "density")
    assert "sigma_table" in touched or fn == "geo_feat"


# ---------------------------------------------------------------------------
# the Trainer: one step, and checkpoints in both directions
# ---------------------------------------------------------------------------

from nerf2mesh_tpu.config import Config as JConfig  # noqa: E402
from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload  # noqa: E402
from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset as jgen  # noqa: E402
from nerf2mesh_tpu.utils import trainer as jtr  # noqa: E402
from nerf2mesh_tpu_torch.config import Config as TConfig  # noqa: E402
from nerf2mesh_tpu_torch.data.provider import (  # noqa: E402
    dataset_from_frames, load_nerf_dataset as tload)
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames  # noqa: E402
from nerf2mesh_tpu_torch.models.renderer import RenderState  # noqa: E402
from nerf2mesh_tpu_torch.utils import trainer as ttr  # noqa: E402
from nerf2mesh_tpu_torch.utils.convert import (  # noqa: E402
    flatten_params, write_jax_checkpoint)

SCENE = dict(H=32, W=32, n_train=6, n_val=0, n_test=0)


@pytest.fixture
def separate(monkeypatch):
    """Both trainer modules build their field with separate tables."""
    monkeypatch.setattr(jtr, "NetworkSpec", functools.partial(
        jnet.NetworkSpec, separate_tables=True))
    monkeypatch.setattr(ttr, "NetworkSpec", functools.partial(
        tnet.NetworkSpec, separate_tables=True))


def tiny(cls, root="", **kw):
    base = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
                num_points=4096, grid_size=32, num_levels=6,
                log2_hashmap_size=14, random_image_batch=True,
                background="random", mark_untrained=True,
                adaptive_num_rays=True, diffuse_step=1000,
                stochastic_fine=False)
    base.update(kw)
    return dataclasses.replace(cls(path=root), **base).finalize()


@pytest.mark.parametrize("layout", ["block512", "ref"])
def test_one_step_matches_jax(tmp_path, separate, layout):
    """tests/test_torch_slice.py's one-step comparison with separate tables,
    lambda_tv on (the TV term reads sigma_table, as JAX's does)."""
    kw = dict(grid_layout=layout, lambda_tv=1e-4)
    root = str(tmp_path / "scene")
    jgen(root, **SCENE)
    jcfg = tiny(JConfig, root, workspace=str(tmp_path / "ws"), **kw)
    jds = jload(jcfg, "train")
    jt = jtr.Trainer(jcfg)
    assert jt.net_spec.separate_tables and "sigma_table" in jt.state.params
    jt.mark_untrained(jds)
    jt.update_grid(0)

    tcfg = tiny(TConfig, **kw)
    tds = dataset_from_frames(tcfg, render_synthetic_frames(**SCENE))
    pt = ttr.Trainer(tcfg, device="cpu", workspace=str(tmp_path / "tws"))
    assert pt.net_spec.separate_tables
    load_params(pt.params, params_from_jax(jt.state.params))
    r = jt.state.render
    pt.render = RenderState(torch.tensor(np.asarray(r.density_grid)),
                            torch.tensor(np.asarray(r.occ_grid)),
                            torch.tensor(np.asarray(r.mean_density)),
                            int(r.iter_density))
    N, Kf = 256, jcfg.samples_per_ray
    B, H, W, _ = jds.images.shape
    key = jax.random.PRNGKey(11)
    images, poses = jnp.asarray(jds.images), jnp.asarray(jds.poses)
    intr = jnp.asarray(jds.intrinsics)

    def loss_fn(p):
        return jt._loss_and_metrics(p, r, key, images, poses, intr, None,
                                    jt.dynamics(0), N)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jt.state.params)
    k_img, k_pix, k_bg, k_march, _ = jax.random.split(key, 5)
    draws = {
        "img_idx": T(jax.random.randint(k_img, (N,), 0, B)),
        "pix_idx": T(jax.random.randint(k_pix, (N,), 0, H * W)),
        "bg": T(jax.random.uniform(k_bg, (N, 3))),
        "u": T(jax.random.uniform(k_march, (N, Kf))),
    }
    images_t, poses_t, intr_t = pt._prep_train_arrays(tds)
    loss, tm = pt._loss_and_metrics(pt.params, pt.render, images_t, poses_t,
                                    intr_t, pt.dynamics(0), N, draws)
    loss.backward()
    assert int(tm["num_points"]) == int(jm["num_points"]) > 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    jg = params_from_jax(jgrads)
    for name, p in pt.params.named_parameters():
        want = jg[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(want).max())
        if name.startswith("specular_net"):     # diffuse warmup: no gradient
            assert scale == 0 and not got.any(), name
            continue
        atol = (1e-4 if name.endswith("table") else 1e-6) * scale
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol,
                                   err_msg=name)
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), name
    # the step itself: Adam moves both tables
    before = {k: v.detach().clone() for k, v in pt.params.named_parameters()}
    pt.train_steps(tds, 1)
    for k in ("sigma_table", "color_table"):
        assert not torch.equal(before[k], dict(pt.params.named_parameters())[k])


CKPT = dict(grid_layout="ref", steps_per_dispatch=1)


def test_jax_checkpoint_loads_into_port(tmp_path, separate):
    root, ws = str(tmp_path / "scene"), str(tmp_path / "ws")
    jgen(root, **SCENE)
    jt = jtr.Trainer(tiny(JConfig, root, workspace=ws, **CKPT))
    jds = jload(jt.cfg, "train")
    jt.mark_untrained(jds)
    jt.train_steps(jds, 2)
    jt.save_checkpoint()
    pt = ttr.Trainer(tiny(TConfig, root, workspace=ws, **CKPT), device="cpu")
    assert pt.load_checkpoint()
    adam = jt.state.opt_state.inner_states["base"].inner_state[0]
    params = flatten_params(jax.tree_util.tree_map(np.asarray, jt.state.params))
    mu = flatten_params(jax.tree_util.tree_map(np.asarray, adam.mu))
    nu = flatten_params(jax.tree_util.tree_map(np.asarray, adam.nu))
    assert {"sigma_table", "color_table"} <= set(params)
    assert pt.step == 2
    for k, p in pt.params.named_parameters():
        st = pt.optimizer.state[p]
        np.testing.assert_array_equal(p.detach().numpy(), params[k], err_msg=k)
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[k], err_msg=k)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[k],
                                      err_msg=k)
        assert int(st["step"]) == int(adam.count)
    assert np.isfinite(float(pt.train_steps(tload(pt.cfg, "train"), 1)["loss"]))


def test_port_checkpoint_loads_into_jax(tmp_path, separate):
    root, ws = str(tmp_path / "scene"), str(tmp_path / "ws")
    jgen(root, **SCENE)
    cfg = tiny(TConfig, root, workspace=ws, **CKPT)
    pt = ttr.Trainer(cfg, device="cpu")
    ds = tload(cfg, "train")
    pt.mark_untrained(ds)
    pt.train_steps(ds, 2)
    path = str(tmp_path / "port.ckpt")
    write_jax_checkpoint(pt._payload(), path)
    jt = jtr.Trainer(tiny(JConfig, root, workspace=ws, **CKPT))
    assert jt.load_checkpoint(path)
    assert int(jt.state.step) == 2
    adam = jt.state.opt_state.inner_states["base"].inner_state[0]
    params = flatten_params(jax.tree_util.tree_map(np.asarray, jt.state.params))
    mu = flatten_params(jax.tree_util.tree_map(np.asarray, adam.mu))
    for k, p in pt.params.named_parameters():
        np.testing.assert_array_equal(params[k], p.detach().numpy(), err_msg=k)
        np.testing.assert_array_equal(
            mu[k], pt.optimizer.state[p]["exp_avg"].numpy(), err_msg=k)
    assert jax.tree_util.tree_structure(jt.state.opt_state) == \
        jax.tree_util.tree_structure(jt.optimizer.init(jt.state.params))
    jt.train_steps(jload(jt.cfg, "train"), 1)
    assert int(jt.state.step) == 3
