"""The port's SDF mode against the JAX package's, on the CPU at a small size
(6 levels, a 2^14-row table, 32^3 grids, 32^2 frames).

The field is a smooth ball: its raw SDF ~ |x| - 0.4 plus the table's
noise (``ball_params``), so that normals, NeuS alphas and meshes are those
of a surface.  Tolerances, each stated at its test:

* the SDF density head atol 1e-5;
* the FD normal at the training epsilons 0.1 and 1e-2 atol 1e-4: it
  divides density differences by 2 epsilon, and the jitted JAX density
  differs from the port's by XLA's fused multiply-adds (ROADMAP C);
* the FD normal at the eval's 1e-4 against JAX run op by op
  (``jax.disable_jit``): within 16 ulps of the largest density over
  2 epsilon (found 3.1);
* ``neus_alpha_from_sdf`` atol 1e-6;
* the pretraining loss on JAX's own points: its value rtol 1e-6, its table
  gradient by the slice's rule (atol 1e-4 * max|g| and 1e-4 relative L2);
* one SDF training step: the loss rtol 1e-5, the table gradient by the
  slice's rule, the variance gradient rtol 1e-4;
* the eval segment (normals at epsilon 1e-4): 95% of its image within
  atol 1e-4 and all within 1e-3, as JAX's own jit and op-by-op runs
  differ by up to 9e-4; the grid-slab conversion rtol 1e-5;
* the SDF stage-0 mesh at 32^3: the same faces and vertices within 2e-6
  before the decimation, the Chamfer distance <= 1e-3 after it;
* stage 1's offset gradient under enable_offset_nerf_grad, with hard
  coverage so that it is the field query's alone, within the
  rasterizer's 5e-4 relative L2 (the `ref` table against JAX's CPU route,
  whose encode has the full trilinear dx; block512 against JAX's splat
  route, whose encode stops the gradient to the positions, the route JAX
  takes on its chip);
* ``sdf_pretrain`` runs the steps JAX's does, the remainder of iters % 100
  dropped (a defect of the reference, ROADMAP C).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.meshing import export as jexp
from nerf2mesh_tpu.models import network as jnet
from nerf2mesh_tpu.models import rasterizer as jr
from nerf2mesh_tpu.models import renderer as jren
from nerf2mesh_tpu.models import stage1 as js1
from nerf2mesh_tpu.ops import splat_encode as jsplat
from nerf2mesh_tpu.utils import trainer as jtr
from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
from nerf2mesh_tpu_torch.meshing import export as texp
from nerf2mesh_tpu_torch.meshing.io import read_ply
from nerf2mesh_tpu_torch.models import network as tnet
from nerf2mesh_tpu_torch.models import rasterizer as tr
from nerf2mesh_tpu_torch.models import renderer as tren
from nerf2mesh_tpu_torch.models import stage1 as ts1
from nerf2mesh_tpu_torch.utils import trainer as ttr
from nerf2mesh_tpu_torch.utils.convert import (load_params, params_from_jax,
                                               render_state_from_jax)
from test_torch_stage1 import chamfer, crop_inputs, icosphere

LAYOUTS = ("block512", "ref")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def tiny(cls, **kw):
    base = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
                num_points=4096, grid_size=32, num_levels=6,
                log2_hashmap_size=14, random_image_batch=True,
                background="random", mark_untrained=True,
                adaptive_num_rays=True, diffuse_step=1000, iters=1000,
                sdf=True)
    base.update(kw)
    return dataclasses.replace(cls(path=""), **base).finalize()


def ball_params(params, seed=0, radius=0.4):
    """Weights whose raw SDF is a ball: 31 hidden units relu(n_k . x) over
    random unit directions (their sum ~ 31|x|/4), one unit relu(mean of the
    density features) ~ 1 (the table's density channel ~1 with a little
    noise), so that h ~ |x| - radius; random colour channels; variance as
    JAX initialises it."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, params)
    L = p["sigma_net"][0]["w"].shape[0] - 3
    n = rng.standard_normal((3, 31))
    w0 = np.zeros((3 + L, 32), np.float32)
    w0[:3, :31] = n / np.linalg.norm(n, axis=0)
    w0[3:, 31] = 1.0 / L
    w1 = np.full((32, 1), 4.0 / 31, np.float32)
    w1[31] = -radius
    table = rng.uniform(-0.3, 0.3, p["table"].shape).astype(np.float32)
    table[:, 0] = 1.0 + rng.uniform(-0.02, 0.02, len(table))
    out = dict(p, table=table, sigma_net=[{"w": w0}, {"w": w1}])
    return jax.tree_util.tree_map(jnp.asarray, out)


@functools.lru_cache(maxsize=None)
def field_pair(layout):
    """(JAX params, JAX spec, port field, port spec) of the ball field."""
    kw = dict(bound=1.0, num_levels=6, log2_hashmap_size=14,
              grid_layout=layout, sdf=True)
    jspec, tspec = jnet.NetworkSpec(**kw), tnet.NetworkSpec(**kw)
    params = ball_params(jnet.init_network(jax.random.PRNGKey(0), jspec))
    field = tnet.NeRFField(tspec, torch.Generator().manual_seed(1))
    load_params(field, params_from_jax(params))
    return params, jspec, field, tspec


def points(n, seed, lo=-0.9, hi=0.9):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sdf_density_head_matches_jax(layout):
    """The raw SDF (no trunc_exp), and the variance parameter: atol 1e-5."""
    params, jspec, field, tspec = field_pair(layout)
    assert field.variance.item() == pytest.approx(0.3) and \
        field.variance.shape == ()
    x = points(700, 1)
    x[:4] = [[0, 0, 0], [0.9, 0, 0], [1.0, 1.0, 1.0], [-1.0, 0.2, 1.0]]
    want = np.asarray(jnet.density(params, jnp.asarray(x), jspec))
    got = tnet.density(field, T(x), tspec).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert want.min() < 0 < want.max()              # a signed distance
    assert got[0] < 0 < got[1]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_finite_diff_normal_at_training_epsilons(layout, monkeypatch):
    """epsilon 0.1 and 1e-2 (the dynamics' range), against the jitted JAX
    normal: atol 1e-4.  The 6 taps go through one density call (one sort
    on the splat path), and points near the bound clip their taps."""
    params, jspec, field, tspec = field_pair(layout)
    x = points(500, 2, -1.0, 1.0)
    sorts = []
    real = tnet.morton_perm
    monkeypatch.setattr(tnet, "morton_perm",
                        lambda *a: sorts.append(1) or real(*a))
    got = {}
    for eps in (0.1, 1e-2):
        want = np.asarray(jnet.finite_diff_normal(params, jnp.asarray(x),
                                                  jspec, eps))
        got[eps] = tnet.finite_diff_normal(field, T(x), tspec,
                                           eps).detach().numpy()
        np.testing.assert_allclose(got[eps], want, atol=1e-4, rtol=0,
                                   err_msg=str(eps))
    assert len(sorts) == (2 if layout == "block512" else 0)
    # the ball's normals at the coarse epsilon point away from its centre
    r = np.linalg.norm(x, axis=-1)
    inner = (r > 0.2) & (r < 0.8) & (np.abs(x).max(-1) < 0.85)
    n = got[0.1][inner]
    cos = (n * x[inner]).sum(-1) / (np.linalg.norm(n, axis=-1) * r[inner])
    assert np.median(cos) > 0.8


@pytest.mark.parametrize("layout", LAYOUTS)
def test_finite_diff_normal_at_eval_epsilon(layout):
    """epsilon 1e-4 divides rounding by 2e-4: against JAX run op by op (no
    fused multiply-adds), within 16 ulps of the largest density over
    2 epsilon (found 3.1: the density's own error is a few ulps of its
    size)."""
    params, jspec, field, tspec = field_pair(layout)
    x = points(200, 3)
    with jax.disable_jit():
        want = np.asarray(jnet.finite_diff_normal(params, jnp.asarray(x),
                                                  jspec, 1e-4))
        dens = np.asarray(jnet.density(params, jnp.asarray(x), jspec))
    got = tnet.finite_diff_normal(field, T(x), tspec, 1e-4).detach().numpy()
    tol = 16 * np.finfo(np.float32).eps * np.abs(dens).max() / 2e-4
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert np.abs(want).max() > 0.5


def test_neus_alpha_from_sdf_matches_jax():
    """atol 1e-6, over the cos anneal ratio's range."""
    rng = np.random.default_rng(4)
    n = 4000
    sdf = rng.normal(0, 0.1, n).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dts = rng.uniform(0, 0.02, n).astype(np.float32)
    for inv_s, car in ((20.0, 0.0), (300.0, 0.37), (1e4, 1.0)):
        want = np.asarray(jren.neus_alpha_from_sdf(
            jnp.asarray(sdf), jnp.asarray(nrm), jnp.asarray(d),
            jnp.asarray(dts), jnp.float32(inv_s), jnp.float32(car)))
        got = tren.neus_alpha_from_sdf(T(sdf), T(nrm), T(d), T(dts),
                                       torch.tensor(inv_s), car).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert 0 < want.mean() < 1


def grads_close(got, want):
    """The slice's rule for a table gradient: atol 1e-4 * max|g| and 1e-4
    relative L2."""
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sdf_pretrain_loss_matches_jax(layout):
    """On JAX's own points (its key's uniform draw): the value rtol 1e-6,
    the table gradient by the slice's rule."""
    params, jspec, field, tspec = field_pair(layout)
    key = jax.random.PRNGKey(7)
    jl, jg = jax.value_and_grad(
        lambda p: jnet.sdf_pretrain_loss(p, key, jspec, batch_size=2048))(
        params)
    xyz = jax.random.uniform(key, (2048, 3), minval=-1.0, maxval=1.0)
    field.zero_grad(set_to_none=True)
    loss = tnet.sdf_pretrain_loss(field, T(xyz), tspec)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    grads_close(field.table.grad.numpy(), np.asarray(jg["table"]))
    assert field.variance.grad is None      # the loss does not read it


def scene_frames():
    return render_synthetic_frames(H=32, W=32, n_train=6, n_val=1, n_test=0)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """pairs(layout) -> trainer_pair's (JAX trainer, port trainer, train
    set), made once a layout."""
    made = {}

    def get(layout):
        if layout not in made:
            made[layout] = trainer_pair(
                layout, tmp_path_factory.mktemp(layout), scene_frames())
        return made[layout]
    return get


def trainer_pair(layout, tmp_path, frames, **kw):
    """A JAX and a port SDF trainer with the ball field's weights (live and
    EMA) and the JAX trainer's occupancy after its first grid update."""
    kw = dict(kw, grid_layout=layout)
    jt = jtr.Trainer(tiny(JConfig, workspace=str(tmp_path / "jws"), **kw))
    params = ball_params(jt.state.params)
    jt.state = jt.state._replace(params=params, ema_params=params)
    ds = dataset_from_frames(tiny(TConfig, **kw), frames, "train")
    jt.mark_untrained(ds)
    jt.update_grid(0)
    r = jt.state.render
    pt = ttr.Trainer(tiny(TConfig, **kw), device="cpu",
                     workspace=str(tmp_path / "tws"))
    load_params(pt.params, params_from_jax(params))
    load_params(pt.ema_field, params_from_jax(params))
    pt.render = render_state_from_jax(r.density_grid, r.occ_grid,
                                      r.mean_density, r.iter_density)
    assert pt.net_spec.encode_gather_levels == jt.net_spec.encode_gather_levels
    return jt, pt, ds


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_sdf_step_matches_jax(layout, pairs):
    """One stage-0 SDF step (NeuS alphas from the FD normal at the step's
    epsilon 0.1, the eikonal term, the exact encode although
    stochastic_fine is on) on the JAX trainer's draws: the loss rtol 1e-5,
    the table gradient by the slice's rule, the variance's rtol 1e-4, and
    the other gradients as the slice test holds them."""
    jt, pt, ds = pairs(layout)
    assert pt.cfg.stochastic_fine and pt.cfg.progressive_level
    N, Kf = 256, jt.cfg.samples_per_ray
    B, H, W, _ = ds.images.shape
    key = jax.random.PRNGKey(11)
    dyn = jt.dynamics(0)
    r = jt.state.render

    def loss_fn(p):
        return jt._loss_and_metrics(
            p, r, key, jnp.asarray(ds.images), jnp.asarray(ds.poses),
            jnp.asarray(ds.intrinsics), None, dyn, N)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jt.state.params)
    k_img, k_pix, k_bg, k_march, _ = jax.random.split(key, 5)
    draws = {
        "img_idx": T(jax.random.randint(k_img, (N,), 0, B)),
        "pix_idx": T(jax.random.randint(k_pix, (N,), 0, H * W)),
        "bg": T(jax.random.uniform(k_bg, (N, 3))),
        "u": T(jax.random.uniform(k_march, (N, Kf))),
    }
    images, poses, intr = pt._prep_train_arrays(ds)
    pt.params.zero_grad(set_to_none=True)
    loss, tm = pt._loss_and_metrics(pt.params, pt.render, images, poses,
                                    intr, pt.dynamics(0), N, draws)
    loss.backward()
    assert int(tm["num_points"]) == int(jm["num_points"]) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = params_from_jax(jgrads)
    for name, p in pt.params.named_parameters():
        want = jg[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        if name.startswith("specular_net"):     # diffuse warmup: no gradient
            assert not want.any() and not got.any(), name
        elif name == "table":
            grads_close(got, want)
        elif name == "variance":
            assert want != 0
            np.testing.assert_allclose(got, want, rtol=1e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-3,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sdf_eval_segment_matches_jax(layout, pairs):
    """render_eval_segment in SDF mode (FD normal at 1e-4, cos ratio 1;
    the port evaluates only the valid samples, JAX all of them).  At this
    epsilon the normal carries rounding times 1/(2e-4) into the alphas, and
    JAX's image differs from itself run op by op by up to 4.5e-4 (block512)
    and 9.0e-4 (ref) here, 2.4-3.4% of the values by more than 1e-4.  So:
    95% of the image and weights within atol 1e-4, all within 1e-3 (found
    3.7e-4 and 6.5e-4, 2.8% above 1e-4); the exit points atol 1e-5."""
    jt, pt, ds = pairs(layout)
    from nerf2mesh_tpu.data.rays import get_rays as jget_rays
    from nerf2mesh_tpu_torch.data.rays import get_rays as tget_rays
    rays = jget_rays(jnp.asarray(ds.poses[:1]), tuple(ds.intrinsics_for(0)),
                     32, 32)
    o, d = np.asarray(rays["rays_o"]), np.asarray(rays["rays_d"])
    rs = dataclasses.replace(jt.render_spec, num_fine=32)
    trs = dataclasses.replace(pt.render_spec, num_fine=32)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    nears, fars = jren.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(aabb), rs.min_near)
    dt = jnp.full(nears.shape, 2.0 / 64)
    occ = jt.state.render.occ_grid
    want = jren.render_eval_segment(jt.state.params, occ, jnp.asarray(o),
                                    jnp.asarray(d), nears, fars, dt, rs,
                                    jt.net_spec)
    got = tren.render_eval_segment(pt.params, pt.render.occ_grid, T(o), T(d),
                                   T(nears), T(fars), T(dt), trs, pt.net_spec)
    tws = tget_rays(T(ds.poses[:1]), tuple(ds.intrinsics_for(0)), 32, 32)
    np.testing.assert_allclose(tws["rays_d"].numpy(), d, atol=1e-6)
    for k in ("image", "weights_sum"):
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert err.max() <= 1e-3 and (err <= 1e-4).mean() >= 0.95, (
            k, err.max(), (err > 1e-4).mean())
    np.testing.assert_allclose(got["t_exit"].numpy(),
                               np.asarray(want["t_exit"]), atol=1e-5)
    assert float(want["weights_sum"].max()) > 0.5


def test_sdf_density_slab_matches_jax():
    """The grid update's SDF -> density conversion sigmoid(-s inv_s) inv_s
    on one jittered slab: rtol 1e-5."""
    params, jspec, field, tspec = field_pair("block512")
    kw = dict(bound=1.0, grid_size=32, num_coarse=128, num_fine=32,
              max_steps=1024, dt_gamma=0.0, sdf=True)
    jrs, trs = jren.RenderSpec(**kw), tren.RenderSpec(**kw)
    grid0 = np.zeros((1, 32, 32, 32), np.float32)
    grid0[0, :, :, :4] = -1.0                        # untrained cells
    jstate = jren.RenderState(jnp.asarray(grid0),
                              jnp.ones(grid0.shape, jnp.uint8),
                              jnp.float32(0), jnp.int32(0))
    tstate = tren.RenderState(T(grid0), torch.ones(grid0.shape,
                                                   dtype=torch.uint8),
                              torch.zeros(()))
    key = jax.random.PRNGKey(3)
    slab = 3
    out = jren._update_density_slab(params, jstate, key, jrs, jspec, None,
                                    jnp.int32(slab))
    half = 1.0 / 32
    n = (32 // tren.GRID_UPDATE_SLABS) * 32 * 32
    noise = np.asarray(jax.random.uniform(jax.random.split(key, 1)[0], (n, 3),
                                          minval=-half, maxval=half))
    got = tren._update_density_slab(field, tstate, [T(noise)], trs, tspec,
                                    None, slab)
    want = np.asarray(out.density_grid)
    np.testing.assert_allclose(got.density_grid.numpy(), want, rtol=1e-5,
                               atol=1e-6)
    assert want.max() > 10 and want[0, 12:16].min() < 1e-3   # in and out
    np.testing.assert_array_equal(got.occ_grid.numpy(),
                                  np.asarray(out.occ_grid))


def test_sdf_stage0_mesh_matches_jax(pairs, tmp_path):
    """The SDF branch of the export (the zero level of -sdf, no density-grid
    mask) on the ball field at 32^3: before the decimation the same faces
    and vertices within 2e-6; after it (to 2000 faces) the Chamfer distance
    <= 1e-3 (the decimation is chaotic in its input's ulps)."""
    jt, pt, _ = pairs("block512")
    for dec, name in ((0, "full"), (2000, "dec")):
        jexp.export_stage0_mesh(jt, str(tmp_path / f"j_{name}"),
                                resolution=32, decimate_target=dec)
        texp.export_stage0_mesh(pt, str(tmp_path / f"t_{name}"),
                                resolution=32, decimate_target=dec)
        jv, jf = read_ply(str(tmp_path / f"j_{name}" / "mesh_0.ply"))
        tv, tf = read_ply(str(tmp_path / f"t_{name}" / "mesh_0.ply"))
        if dec == 0:
            np.testing.assert_array_equal(tf, jf)
            np.testing.assert_allclose(tv, jv, atol=2e-6, rtol=0)
            # the (lumpy) ball of radius ~0.4
            r = np.linalg.norm(jv, axis=-1)
            assert len(jf) > 1000 and 0.3 < np.median(r) < 0.5
        else:
            assert len(jf) <= 2010 and len(tf) <= 2010
            assert chamfer(tv, tf, jv, jf) <= 1e-3


@pytest.mark.parametrize("layout", LAYOUTS)
def test_stage1_offset_grad_through_the_field(layout, pairs, monkeypatch):
    """enable_offset_nerf_grad on a crop render (ssaa 1, shell 1) of an
    icosphere near the ball's surface with small random offsets.  Hard
    coverage carries no gradient, so the offsets' gradient is the field
    query's alone, through the interpolated surface points: it and the
    table's within the rasterizer's 5e-4 relative L2 of JAX's (found 6e-5
    at ref, 5e-7 at block512).  ref: JAX's CPU route, whose encode has the
    trilinear dx; block512: JAX's splat route with its Pallas kernels
    interpreted, whose encode stops the gradient to the positions (its
    chip route), so the offsets' gradient comes through the MLPs' raw x
    alone, ~300x smaller.  Without the flag the offsets get none.  Most of
    that gradient, in JAX's as in the port's, is the barycentrics' own
    (their dependence on the vertex positions): with them detached the
    port's is more than 0.5 relative L2 from JAX's (found 1.23, 1.27)."""
    jt, pt, _ = pairs(layout)
    v, f = icosphere(2, r=0.42)
    rng = np.random.default_rng(1)
    offs = (0.005 * rng.standard_normal(v.shape)).astype(np.float32)
    val = dataset_from_frames(tiny(TConfig), scene_frames(), "val")
    crop, origin = 16, (8, 8)
    dirs, bg, mvp = crop_inputs(val, crop, 1, origin, 2)
    spec = dict(crop=crop, max_tris=512, frag=8)
    kw = dict(shading="full", ssaa=1, alpha_mode="hard", shell_k=1)
    w_img = rng.standard_normal((crop, crop, 3)).astype(np.float32)

    def jloss(params, o):
        out = js1.render_stage1_crop(
            params, o, jnp.asarray(v), jnp.asarray(f), jnp.asarray(mvp),
            jnp.asarray(origin), jnp.asarray(dirs), jnp.asarray(bg),
            jt.net_spec, jr.RasterSpec(**spec), val.H, val.W,
            enable_offset_nerf_grad=True, **kw)
        return jnp.sum(out["image"] * w_img)

    if layout == "block512":
        real = jsplat.pl.pallas_call      # the encode passes interpret=False
        monkeypatch.setattr(jnet, "_use_splat", lambda gspec: True)
        monkeypatch.setattr(jsplat.pl, "pallas_call", lambda *a, **k: real(
            *a, **dict(k, interpret=True)))
    jg_p, jg_o = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jt.state.params,
                                                          jnp.asarray(offs))
    monkeypatch.undo()

    def port_grads(nerf_grad):
        o_t = T(offs).requires_grad_(True)
        pt.params.zero_grad(set_to_none=True)
        out = ts1.render_stage1_crop(
            pt.params, o_t, T(v), T(f), T(mvp), origin, T(dirs), T(bg),
            pt.net_spec, tr.RasterSpec(**spec), val.H, val.W,
            enable_offset_nerf_grad=nerf_grad, **kw)
        (out["image"] * T(w_img)).sum().backward()
        assert (out["trig_id"] >= 0).float().mean() > 0.5
        return o_t.grad, pt.params.table.grad

    g_o, g_t = port_grads(True)
    for got, want in ((g_o, jg_o), (g_t, jg_p["table"])):
        want = np.asarray(want)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert np.linalg.norm(want) > 0 and rel <= 5e-4, rel
    assert port_grads(False)[0] is None
    # what agrees includes the barycentrics' own gradient (their
    # dependence on the vertex positions, 1/screen area): without it the
    # port's offsets' gradient is far from JAX's
    monkeypatch.setattr(ts1, "interpolate", lambda a, rast, t: tr.interpolate(
        a, dict(rast, bary=rast["bary"].detach()), t))
    g_d = port_grads(True)[0].numpy()
    want = np.asarray(jg_o)
    assert np.linalg.norm(g_d - want) / np.linalg.norm(want) > 0.5


def jax_pretrain_points(iters, batch_size, bound=1.0):
    """The point batches JAX's sdf_pretrain draws, step by step: PRNGKey(42)
    split once a chunk of min(100, iters) steps, that key split into one
    key a step, each the uniform draw of sdf_pretrain_loss."""
    chunk = min(100, iters)
    key = jax.random.PRNGKey(42)
    for _ in range(max(1, iters // chunk)):
        key, k = jax.random.split(key)
        for kk in jax.random.split(k, chunk):
            yield T(jax.random.uniform(kk, (batch_size, 3), minval=-bound,
                                       maxval=bound))


def test_sdf_pretrain_runs_the_steps_jax_runs(tmp_path):
    """iters=150 on JAX's own points from the same initial weights: the
    port takes 100 batches, as JAX's scan chunks do (the 50-step remainder
    is dropped: a defect of the reference that the port matches, ROADMAP
    C), and ends within atol 1e-5 of JAX's weights (found 1.9e-6: Adam's
    100 steps of 1e-3, fp32 sums in another order); the EMA weights become
    the live ones.  Shorter runs take JAX's count too; iters=0, on
    which JAX fails inside its scan, raises."""
    jt = jtr.Trainer(tiny(JConfig, workspace=str(tmp_path / "j")))
    pt = ttr.Trainer(tiny(TConfig), device="cpu",
                     workspace=str(tmp_path / "t"))
    load_params(pt.params, params_from_jax(jt.state.params))
    jt.sdf_pretrain(iters=150, batch_size=512)
    taken = []

    def feed(batches):
        for b in batches:
            taken.append(1)
            yield b

    pt.sdf_pretrain(iters=150, points=feed(jax_pretrain_points(150, 512)))
    assert len(taken) == 100              # the reference's defect, matched
    want = params_from_jax(jt.state.params)
    for name, p in pt.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
        np.testing.assert_array_equal(pt.ema_params[name].numpy(),
                                      p.detach().numpy())
    x = T([[0.0, 0.0, 0.0], [0.9, 0.0, 0.0]])
    with torch.no_grad():
        s = tnet.density(pt.params, x, pt.net_spec).numpy()
    assert s[0] < s[1]
    rng = np.random.default_rng(0)
    for iters, steps in ((50, 50), (120, 100)):
        taken.clear()
        pt.sdf_pretrain(iters=iters, points=feed(
            T(rng.uniform(-1, 1, (8, 3)).astype(np.float32))
            for _ in range(steps + 1)))
        assert len(taken) == steps, (iters, len(taken))
    with pytest.raises(ValueError, match="iters"):
        pt.sdf_pretrain(iters=0)


def test_sdf_checkpoints_carry_variance_both_ways(tmp_path):
    """The 0-d variance and its Adam moments (JAX's "slow" label, the port's
    0.1x group) in a JAX checkpoint read by the port, and in a port
    checkpoint written for JAX and read by it."""
    import optax.tree_utils as otu
    from nerf2mesh_tpu_torch.utils.convert import write_jax_checkpoint
    jt = jtr.Trainer(tiny(JConfig, workspace=str(tmp_path / "j")))
    params = dict(ball_params(jt.state.params), variance=jnp.float32(0.37))
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    _, ost = jt.optimizer.update(grads, jt.state.opt_state, params)
    jt.state = jt.state._replace(
        params=params, ema_params=params, opt_state=otu.tree_set(
            ost, count=jnp.asarray(3, jnp.int32)),
        step=jnp.asarray(3, jnp.int32))
    jt.save_checkpoint()
    pt = ttr.Trainer(tiny(TConfig), device="cpu",
                     workspace=str(tmp_path / "j"))
    assert pt.load_checkpoint() and pt.step == 3
    assert pt.params.variance.item() == np.float32(0.37)
    assert pt.ema_params["variance"].item() == np.float32(0.37)
    slow = pt.optimizer.param_groups[1]
    assert slow["params"] == [pt.params.variance]
    base_lr = pt.optimizer.param_groups[0]["lr"]
    assert slow["lr"] == pytest.approx(0.1 * base_lr)
    jmu = jt.state.opt_state.inner_states["slow"].inner_state[0].mu
    st = pt.optimizer.state[pt.params.variance]
    assert st["exp_avg"].item() == float(jmu["variance"]) != 0
    assert int(st["step"]) == 3

    with torch.no_grad():
        pt.params.variance.fill_(0.41)
    st["exp_avg"].fill_(0.25)
    path = str(tmp_path / "port.ckpt")
    write_jax_checkpoint(pt._payload(), path)
    jt2 = jtr.Trainer(tiny(JConfig, workspace=str(tmp_path / "j2")))
    assert jt2.load_checkpoint(path)
    assert float(jt2.state.params["variance"]) == np.float32(0.41)
    adam = jt2.state.opt_state.inner_states["slow"].inner_state[0]
    assert float(adam.mu["variance"]) == 0.25 and int(adam.count) == 3
    assert jax.tree_util.tree_structure(jt2.state.opt_state) == \
        jax.tree_util.tree_structure(jt2.optimizer.init(jt2.state.params))
