"""The port's unbounded-scene path (bound > 1 cascades, scene contraction,
per-view near/far) against the JAX package's, on the CPU at a small size:
a 32^2 COLMAP scene (data/synthetic.generate_colmap_dataset, the same
frames in both packages), 6 levels of a 2^14-row block512 table, a 16^3 or
32^3 grid, with the same weights on both sides (``params_from_jax``).

Tolerances:
  * ``occupancy_index``: the flat cell indices equal, index for index, at
    bound 4 (3 cascades), bound 16 (5) and contracted (2), points in every
    cascade and dts that force the dt-driven mip level; JAX's index is read
    from the gather inside its ``occupancy_lookup``;
  * the grid update on a jittered slab of every cascade (JAX's jitter fed
    in, JAX run op by op: its jit fuses the lattice multiply-add, which at
    bound 4's finest 8192 cells moves densities by up to 1e-4): density
    grid atol 1e-5; ``mark_untrained_grid`` with 80 views'
    near/far (two 64-view blocks): equal;
  * one stage-0 step at bound 4 with enable_cam_near_far, per-view
    intrinsics and the points' box, on JAX's draws: loss rtol 1e-4 as in
    tests/test_torch_slice.py.  That test's bounds on the table's gradient,
    1e-4 max|g| an entry and 1e-4 relative L2, come from ulp-level sample
    position differences times the finest level's 2048 cells at bound 1;
    at bound 4 the finest level has 8192 cells, so the same rule gives 4e-4,
    and every gradient here is held to it (rtol 1e-3 with atol 4e-4 max|g|,
    and 4e-4 relative L2): the MLPs' gradients flow through the same
    features.  Found: up to 3.5e-4 max|g| (color_net.1) and 2.5e-4 relative
    L2 (the table) against the jitted JAX step; JAX run op by op, which
    takes 46 s here, still differs by 1.7e-4 max|g| and 1.0e-4 relative L2;
  * the eval segment at bound 4 and contracted: as tests/test_torch_sdf.py
    (95% of the image and weights within 1e-4, all within 1e-3; exits atol
    1e-5);
  * the outer-cascade meshes: the same faces and vertices within 2e-6 before
    the decimation, within a Chamfer distance of 1e-3 of the cascade's bound
    after it; a cascade with nothing left writes no file, and the stage-1
    load then fails in both packages (a defect of the reference, ROADMAP C);
  * a contracted stage-1 crop as tests/test_torch_stage1.py (image atol
    1e-4 against JAX op by op), and the contracted export's UV source and
    bake points within 1e-6.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.data.colmap import load_colmap_dataset as jload
from nerf2mesh_tpu.data.synthetic import generate_colmap_dataset
from nerf2mesh_tpu.meshing import export as jexp
from nerf2mesh_tpu.models import rasterizer as jr
from nerf2mesh_tpu.models import renderer as jren
from nerf2mesh_tpu.models import stage1 as js1
from nerf2mesh_tpu.ops import sampling as jsamp
from nerf2mesh_tpu.utils import trainer as jtr
from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset as tload
from nerf2mesh_tpu_torch.meshing import export as texp
from nerf2mesh_tpu_torch.meshing.io import read_ply, write_ply
from nerf2mesh_tpu_torch.meshing.meshops import midpoint_subdivide
from nerf2mesh_tpu_torch.models import rasterizer as tr
from nerf2mesh_tpu_torch.models import renderer as tren
from nerf2mesh_tpu_torch.models import stage1 as ts1
from nerf2mesh_tpu_torch.ops import sampling as tsamp
from nerf2mesh_tpu_torch.utils import trainer as ttr
from nerf2mesh_tpu_torch.utils.convert import (load_params, params_from_jax,
                                               render_state_from_jax)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cscene"))
    generate_colmap_dataset(root, H=32, W=32, n_images=10, n_points=300)
    return root


def tiny(cls, root, **kw):
    base = dict(bound=4.0, dt_gamma=0.0, num_rays=256, num_points=4096,
                grid_size=32, num_levels=6, log2_hashmap_size=14,
                random_image_batch=True, background="random",
                mark_untrained=True, adaptive_num_rays=True,
                diffuse_step=1000, stochastic_fine=False, iters=1000,
                data_format="colmap", enable_cam_near_far=True)
    base.update(kw)
    return dataclasses.replace(cls(path=root), **base).finalize()


def trainers(scene, tmp_path, **kw):
    """A JAX and a port trainer on the scene with the same random-table
    weights and the occupancy state of JAX's first full grid update."""
    jcfg = tiny(JConfig, scene, workspace=str(tmp_path / "j"), **kw)
    tcfg = tiny(TConfig, scene, **kw)
    jds, tds = jload(jcfg, "train"), tload(tcfg, "train")
    jt = jtr.Trainer(jcfg)
    rng = np.random.default_rng(0)
    params = dict(jt.state.params)
    params["table"] = jnp.asarray(rng.uniform(
        -1, 1, params["table"].shape).astype(np.float32))
    jt.state = jt.state._replace(params=params, ema_params=params)
    jt.update_aabb(jds.pts_aabb)
    if jcfg.mark_untrained:
        jt.mark_untrained(jds)
    jt.update_grid(0)
    r = jt.state.render
    pt = ttr.Trainer(tcfg, device="cpu", workspace=str(tmp_path / "t"))
    load_params(pt.params, params_from_jax(params))
    load_params(pt.ema_field, params_from_jax(params))
    pt.update_aabb(tds.pts_aabb)
    pt.render = render_state_from_jax(r.density_grid, r.occ_grid,
                                      r.mean_density, r.iter_density)
    return jt, pt, jds, tds


def test_contraction_matches_jax():
    """contract / uncontract (torch) within 1e-6 of JAX's, the numpy pair
    (a copy) equal, and uncontract inverting contract."""
    from nerf2mesh_tpu.ops import contraction as jc
    from nerf2mesh_tpu_torch.ops import contraction as tc
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(4000, 3)) * np.exp(rng.uniform(-3, 3, (4000, 1)))
         ).astype(np.float32)
    cx = np.asarray(jc.contract(jnp.asarray(x)))
    np.testing.assert_allclose(tc.contract(T(x)).numpy(), cx, rtol=1e-6)
    np.testing.assert_allclose(tc.contract_np(x), jc.contract_np(x), rtol=0)
    assert np.abs(cx).max() < 2.0
    want = np.asarray(jc.uncontract(jnp.asarray(cx)))
    np.testing.assert_allclose(tc.uncontract(T(cx)).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(tc.uncontract_np(cx), jc.uncontract_np(cx),
                               rtol=0)
    np.testing.assert_allclose(tc.uncontract_np(cx), x, rtol=1e-3)


class _TakeSpy:
    """jax.numpy with ``take`` recording its indices: the flat cell index
    JAX's occupancy_lookup gathers on the CPU."""

    def __getattr__(self, k):
        return getattr(jnp, k)

    def take(self, a, idx, axis=None):
        self.idx = np.asarray(idx)
        return jnp.take(a, idx, axis=axis)


@pytest.mark.parametrize("bound,contracted,cascades", [
    (4.0, False, 3), (16.0, False, 5), (16.0, True, 2)])
def test_occupancy_index_equals_jax(monkeypatch, bound, contracted, cascades):
    H = 16
    rng = np.random.default_rng(3)
    gb = 2.0 if contracted else bound
    # magnitudes across every cascade, and dts from tiny to past the
    # coarsest cell, so the dt's mip level wins for part of them
    mag = np.exp(rng.uniform(np.log(0.05), np.log(bound), 6000))
    d = rng.normal(size=(6000, 3))
    xyz = (d / np.abs(d).max(-1, keepdims=True) * mag[:, None]).astype(
        np.float32)
    dts = np.exp(rng.uniform(np.log(1e-3), np.log(4 * gb / H), 6000)).astype(
        np.float32)
    spy = _TakeSpy()
    monkeypatch.setattr(jsamp, "jnp", spy)
    jsamp.occupancy_lookup(jnp.zeros((cascades, H, H, H), jnp.uint8),
                           jnp.asarray(xyz), jnp.asarray(dts), bound,
                           contracted, cascades, H)
    got, cxyz = tsamp.occupancy_index(T(xyz), T(dts), bound, contracted,
                                      cascades, H)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  spy.idx.astype(np.int64))
    level = spy.idx // H ** 3
    mip_pos = np.ceil(np.clip(np.log2(np.abs(xyz).max(-1)), 0, None))
    assert set(level.tolist()) == set(range(cascades))
    # the dt's mip level decides the cascade of some points of each level
    for c in range(1, cascades):
        assert ((level == c) & (mip_pos < c)).any(), c
    if contracted:
        assert (np.abs(cxyz.numpy()).max(-1) <= 2.0).all()


@pytest.mark.parametrize("contract", [False, True])
def test_cascaded_grid_update_matches_jax(scene, tmp_path, contract):
    """One jittered slab of every cascade (JAX's jitter, drawn from its
    key, fed to the port), then the untrained marks from 80 views with
    their own near/far."""
    kw = dict(bound=16.0, contract=True) if contract else {}
    jt, pt, jds, tds = trainers(scene, tmp_path, **kw)
    rs, trs = jt.render_spec, pt.render_spec
    assert trs.cascades == rs.cascades == (2 if contract else 3)
    st = jt.state.render
    key = jax.random.PRNGKey(5)
    slab = 3
    # op by op: XLA's jit fuses the lattice multiply-add (ROADMAP C), which
    # at the finest level's 8192 cells moves a corner weight by ~1e-4
    with jax.disable_jit():
        out = jren._update_density_slab(jt.state.params, st, key, rs,
                                        jt.net_spec, None, jnp.int32(slab))
    H = rs.grid_size
    n = (H // tren.GRID_UPDATE_SLABS) * H * H
    keys = jax.random.split(key, rs.cascades)
    noise = []
    for c in range(rs.cascades):
        half = min(2 ** c, rs.grid_bound) / H
        noise.append(T(jax.random.uniform(keys[c], (n, 3), minval=-half,
                                          maxval=half)))
    got = tren._update_density_slab(pt.params, pt.render, noise, trs,
                                    pt.net_spec, None, slab)
    want = np.asarray(out.density_grid)
    np.testing.assert_allclose(got.density_grid.numpy(), want, atol=1e-5,
                               rtol=0)
    assert (np.abs(got.density_grid.numpy() - np.asarray(st.density_grid))
            .max(axis=(1, 2, 3)) > 0).all()        # every cascade refreshed
    # untrained marks: 80 views (two blocks of 64) with their own near
    rng = np.random.default_rng(4)
    idx = rng.integers(0, tds.num_frames, 80)
    poses = tds.poses[idx]
    cnf = np.stack([rng.uniform(0.2, 3.0, 80), np.full(80, 1000.0)],
                   -1).astype(np.float32)
    zero = np.zeros_like(want)
    a = jren.mark_untrained_grid(st._replace(density_grid=jnp.asarray(zero)),
                                 poses, tds.intrinsics_for(0), rs,
                                 aabb=jt._aabb, cam_near_far=cnf)
    b = tren.mark_untrained_grid(dataclasses.replace(
        pt.render, density_grid=T(zero)), poses, tds.intrinsics_for(0), trs,
        aabb=pt._aabb, cam_near_far=cnf)
    np.testing.assert_array_equal(b.density_grid.numpy(),
                                  np.asarray(a.density_grid))
    marked = (b.density_grid.numpy() < 0).mean(axis=(1, 2, 3))
    assert (marked > 0).all() and (marked < 1).all()


def test_untrained_marks_take_view_0_intrinsics(scene, tmp_path):
    """A capture whose views differ in focal length: both packages'
    ``Trainer.mark_untrained`` test every view with view 0's intrinsics
    (JAX trainer.py:694, port utils/trainer.py:615-616), a known defect of
    the reference (ROADMAP C): the grid is the one view 0's frustum gives
    every view, not the one each view's own frustum gives.  The port's grid
    equals JAX's."""
    jt, pt, jds, tds = trainers(scene, tmp_path)
    rng = np.random.default_rng(9)
    f = rng.uniform(0.5, 2.0, (tds.num_frames, 1))
    intr = (np.tile(tds.intrinsics_for(0), (tds.num_frames, 1))
            * np.concatenate([f, f, np.ones_like(f), np.ones_like(f)], 1)
            ).astype(np.float32)
    zero = np.zeros(tuple(pt.render.density_grid.shape), np.float32)
    jt.state = jt.state._replace(render=jt.state.render._replace(
        density_grid=jnp.asarray(zero)))
    pt.render = dataclasses.replace(pt.render, density_grid=T(zero))
    jt.mark_untrained(dataclasses.replace(jds, intrinsics=intr))
    pt.mark_untrained(dataclasses.replace(tds, intrinsics=intr))
    got = pt.render.density_grid.numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jt.state.render.density_grid))
    view0 = tren.mark_untrained_grid(
        pt.render, tds.poses, intr[0], pt.render_spec, aabb=pt._aabb,
        cam_near_far=tds.cam_near_far)
    np.testing.assert_array_equal(got, view0.density_grid.numpy())
    # each view with its own intrinsics: a cell stays unmarked when some
    # view's own frustum sees it
    own = np.logical_and.reduce([tren.mark_untrained_grid(
        dataclasses.replace(pt.render, density_grid=T(zero)),
        tds.poses[i:i + 1], intr[i], pt.render_spec, aabb=pt._aabb,
        cam_near_far=tds.cam_near_far[i:i + 1]).density_grid.numpy() < 0
        for i in range(tds.num_frames)])
    assert (own != (got < 0)).any()


# the finest level's resolution (2048 * bound) at bound 4 over bound 1's
FINEST_RATIO = 4


def test_stage0_step_matches_jax(scene, tmp_path):
    """One stage-0 step at bound 4 (3 cascades) with each ray's view
    near/far and intrinsics, on JAX's draws."""
    jt, pt, jds, tds = trainers(scene, tmp_path)
    assert pt.render_spec.cascades == 3 and tds.intrinsics.ndim == 2
    N, Kf = 256, jt.cfg.samples_per_ray
    B, H, W, _ = jds.images.shape
    key = jax.random.PRNGKey(11)
    r = jt.state.render
    dyn = jt.dynamics(0)

    def loss_fn(p):
        return jt._loss_and_metrics(
            p, r, key, jnp.asarray(jds.images), jnp.asarray(jds.poses),
            jnp.asarray(jds.intrinsics), jnp.asarray(jds.cam_near_far), dyn,
            N)

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
    assert torch.is_tensor(intr_t) and pt._train_cnf is not None
    loss, tm = pt._loss_and_metrics(pt.params, pt.render, images_t, poses_t,
                                    intr_t, pt.dynamics(0), N, draws,
                                    pt._train_cnf)
    loss.backward()
    assert int(tm["num_points"]) == int(jm["num_points"]) > 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    jg = params_from_jax(jgrads)
    for name, p in pt.params.named_parameters():
        want = jg[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(want).max())
        if name.startswith("specular_net"):
            assert scale == 0 and not got.any(), name
            continue
        # tests/test_torch_slice.py's bounds on the table's gradient, per
        # unit of the finest level's resolution at bound 1 (see the
        # docstring)
        tol = 1e-4 * FINEST_RATIO
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=tol * scale,
                                   err_msg=name)
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), name
    # the views' near/far clamp the rays: without them the step differs
    loss2, tm2 = pt._loss_and_metrics(pt.params, pt.render, images_t,
                                      poses_t, intr_t, pt.dynamics(0), N,
                                      draws)
    assert abs(float(loss2.detach()) - float(loss.detach())) > 1e-4


@pytest.mark.parametrize("contract", [False, True])
def test_eval_segment_matches_jax(scene, tmp_path, contract):
    kw = dict(bound=16.0, contract=True) if contract else {}
    jt, pt, jds, tds = trainers(scene, tmp_path, **kw)
    from nerf2mesh_tpu.data.rays import get_rays as jget_rays
    rays = jget_rays(jnp.asarray(jds.poses[:1]), tuple(jds.intrinsics_for(0)),
                     32, 32)
    o, d = np.asarray(rays["rays_o"]), np.asarray(rays["rays_d"])
    rs = dataclasses.replace(jt.render_spec, num_fine=32)
    trs = dataclasses.replace(pt.render_spec, num_fine=32)
    nears, fars = jren.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(jt._aabb), rs.min_near)
    dt = jnp.full(nears.shape, 0.05)
    want = jren.render_eval_segment(jt.state.params, jt.state.render.occ_grid,
                                    jnp.asarray(o), jnp.asarray(d), nears,
                                    fars, dt, rs, jt.net_spec)
    got = tren.render_eval_segment(pt.params, pt.render.occ_grid, T(o), T(d),
                                   T(nears), T(fars), T(dt), trs, pt.net_spec)
    for k in ("image", "weights_sum"):
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert err.max() <= 1e-3 and (err <= 1e-4).mean() >= 0.95, (
            k, err.max(), (err > 1e-4).mean())
    np.testing.assert_allclose(got["t_exit"].numpy(),
                               np.asarray(want["t_exit"]), atol=1e-5)
    assert float(want["weights_sum"].max()) > 0.5
    # the rays' samples reach past the unit box
    assert float(jnp.abs(nears + 0.5 * (fars - nears)).max()) > 1.0


def shell_grid(render, spec, H):
    """A density grid whose every cascade holds a smooth shell at 0.75 of
    its bound (a sphere in world space), the inner one at 0.5."""
    ax = 2.0 * np.arange(H, dtype=np.float32) / (H - 1) - 1.0
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    grid = []
    for c in range(spec.cascades):
        b = min(2 ** c, spec.grid_bound)
        r = np.linalg.norm(g * (b - b / H), axis=-1)
        rad = 0.5 if c == 0 else 0.75 * b
        grid.append(40.0 * np.exp(-((r - rad) / (0.1 * b)) ** 2))
    grid = np.stack(grid).astype(np.float32)
    return grid


def test_outer_cascade_meshes_match_jax(scene, tmp_path):
    """export_stage0_mesh at bound 4 on the same density grid: the outer
    cascades' meshes without decimation (the same faces, vertices within
    2e-6) and decimated to 1000 faces (Chamfer)."""
    jt, pt, _, _ = trainers(scene, tmp_path, mark_untrained=False,
                            clean_min_f=0)
    grid = shell_grid(pt.render, pt.render_spec, 32)
    md = np.float32(grid.clip(0).mean())
    occ = (grid > md).astype(np.uint8)
    jt.state = jt.state._replace(render=jren.RenderState(
        jnp.asarray(grid), jnp.asarray(occ), jnp.float32(md), jnp.int32(1)))
    pt.render = render_state_from_jax(grid, occ, md, 1)
    for dec in (0, 2000):
        jd, td = tmp_path / f"j{dec}", tmp_path / f"t{dec}"
        jexp.export_stage0_mesh(jt, str(jd), resolution=32,
                                decimate_target=dec)
        secs = texp.export_stage0_mesh(pt, str(td), resolution=32,
                                       decimate_target=dec)
        assert "outer" in secs
        assert sorted(os.listdir(jd)) == sorted(os.listdir(td)) == [
            "mesh_0.ply", "mesh_1.ply", "mesh_2.ply"]
        for cas in (1, 2):
            jv, jf = read_ply(str(jd / f"mesh_{cas}.ply"))
            tv, tf = read_ply(str(td / f"mesh_{cas}.ply"))
            b = 2.0 ** cas
            assert len(jf) > 100 and 0.45 * b < np.abs(tv).max() <= b
            if dec == 0:
                np.testing.assert_array_equal(tf, jf)
                np.testing.assert_allclose(tv, jv, atol=2e-6, rtol=0)
            else:
                from test_torch_stage1 import chamfer
                assert len(tf) <= 1010 and len(jf) <= 1010
                assert chamfer(tv, tf, jv, jf) <= 1e-3 * b


def test_missing_cascade_mesh_fails_both(tmp_path):
    """JAX's export writes no mesh for an empty cascade and its stage-1
    load then opens that file anyway; the port matches (ROADMAP C, known
    defects of the reference)."""
    ws = tmp_path / "ws"
    (ws / "mesh_stage0").mkdir(parents=True)
    v, f = icosphere()
    write_ply(str(ws / "mesh_stage0" / "mesh_0.ply"), v, f)
    write_ply(str(ws / "mesh_stage0" / "mesh_1.ply"), 3 * v, f)
    for load in (js1.load_stage1_mesh, ts1.load_stage1_mesh):
        assert load(str(ws), 2).num_faces == 2 * len(f)
        with pytest.raises(FileNotFoundError, match="mesh_2.ply"):
            load(str(ws), 3)


def icosphere(level=2, r=0.45):
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
                  [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    for _ in range(level):
        v, f = midpoint_subdivide(v, f, np.ones(len(f), bool))
    return (r * v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
        np.float32), f.astype(np.int32)


@pytest.fixture(scope="module")
def contracted_stage1(scene, tmp_path_factory):
    """Stage-1 trainers of both packages at bound 16 with contraction over
    an inner sphere (r 0.45) and an outer one (r 3) with offsets."""
    ws = tmp_path_factory.mktemp("c1ws")
    (ws / "mesh_stage0").mkdir(parents=True)
    v, f = icosphere(2)
    write_ply(str(ws / "mesh_stage0" / "mesh_0.ply"), v, f)
    write_ply(str(ws / "mesh_stage0" / "mesh_1.ply"), v * (3.0 / 0.45), f)
    kw = dict(bound=16.0, contract=True, stage=1, ssaa=1,
              s1_snap_surface=False, workspace=str(ws), mark_untrained=False)
    jcfg, tcfg = tiny(JConfig, scene, **kw), tiny(TConfig, scene, **kw)
    jds, tds = jload(jcfg, "train"), tload(tcfg, "train")
    jt = jtr.Trainer(jcfg)
    jt.setup_stage1(jds)
    rng = np.random.default_rng(2)
    params = dict(jt.state.params)
    params["table"] = jnp.asarray(rng.uniform(
        -0.5, 0.5, params["table"].shape).astype(np.float32))
    params["vertices_offsets"] = jnp.asarray(
        0.01 * rng.standard_normal(params["vertices_offsets"].shape),
        jnp.float32)
    jt.state = jt.state._replace(params=params)
    pt = ttr.Trainer(tcfg, device="cpu")
    pt.setup_stage1(tds)
    load_params(pt.params, params_from_jax(
        {k: v for k, v in params.items() if k != "vertices_offsets"}))
    with torch.no_grad():
        pt.vertices_offsets.copy_(T(params["vertices_offsets"]))
    assert pt.stage1_mesh.num_faces == jt.stage1_mesh.num_faces
    return jt, pt, tds


def test_contracted_stage1_crop_matches_jax(contracted_stage1):
    jt, pt, ds = contracted_stage1
    crop = 32
    fx, fy, cx, cy = (float(v) for v in ds.intrinsics_for(0))
    jj, ii = np.meshgrid(np.arange(crop) + 0.5, np.arange(crop) + 0.5,
                         indexing="ij")
    dcam = np.stack([(ii - cx) / fx, -(jj - cy) / fy, -np.ones_like(ii)], -1)
    dirs = (dcam.reshape(-1, 3) @ ds.poses[0][:3, :3].T).reshape(
        crop, crop, 3).astype(np.float32)
    bg = np.random.default_rng(3).uniform(0, 1, (crop, crop, 3)).astype(
        np.float32)
    mvp = ds.mvps[0].astype(np.float32)
    spec = dict(crop=crop, max_tris=2048, frag=8)
    mesh = jt.stage1_mesh
    kw = dict(shading="full", contracted=True, alpha_mode="area")
    offs = np.asarray(jt.state.params["vertices_offsets"])[:mesh.num_vertices]
    with jax.disable_jit():
        want = js1.render_stage1_crop(
            jt.state.params, jnp.asarray(offs), jnp.asarray(mesh.vertices),
            jnp.asarray(mesh.triangles), jnp.asarray(mvp), jnp.asarray((0, 0)),
            jnp.asarray(dirs), jnp.asarray(bg), jt.net_spec,
            jr.RasterSpec(**spec), ds.H, ds.W, **kw)
    with torch.no_grad():
        got = ts1.render_stage1_crop(
            pt.params, T(offs), T(mesh.vertices), T(mesh.triangles), T(mvp),
            (0, 0), T(dirs), T(bg), pt.net_spec, tr.RasterSpec(**spec),
            ds.H, ds.W, **kw)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               atol=1e-4)
    np.testing.assert_array_equal(got["trig_id"].numpy(),
                                  np.asarray(want["trig_id"]))
    # both cascades are in view
    tid = got["trig_id"].numpy()
    f1 = int(mesh.f_cumsum[1])
    assert (tid >= f1).any() and ((tid >= 0) & (tid < f1)).any()


def test_contracted_export_matches_jax(contracted_stage1, tmp_path,
                                       monkeypatch):
    """The UV unwrap's input (the contracted vertices) and the bake's field
    points (contracted) of each cascade within 1e-6; one OBJ set per
    cascade, and mlp.json's bound 2 and two cascades."""
    import json

    import nerf2mesh_tpu.meshing.uvatlas as juv
    import nerf2mesh_tpu.ops.contraction as jcon
    import nerf2mesh_tpu_torch.meshing.uvatlas as tuv
    import nerf2mesh_tpu_torch.ops.contraction as tcon
    jt, pt, _ = contracted_stage1
    seen = {"j_uv": [], "t_uv": [], "j_pts": [], "t_pts": []}

    def spy_uv(side, fn):
        def wrap(v, f, *a, **k):
            seen[side].append(np.array(v))
            return fn(v, f, *a, **k)
        return wrap

    def spy_jcontract(x):
        out = jcon.__dict__["_orig_contract_np"](x)
        if x.shape == (256 * 256, 3):          # a bake tile, not a mesh
            seen["j_pts"].append(np.array(out))
        return out

    def spy_tcontract(x):
        out = tcon.__dict__["_orig_contract"](x)
        seen["t_pts"].append(out.numpy().copy())
        return out

    monkeypatch.setattr(juv, "unwrap_uv", spy_uv("j_uv", juv.unwrap_uv))
    monkeypatch.setattr(tuv, "unwrap_uv", spy_uv("t_uv", tuv.unwrap_uv))
    monkeypatch.setitem(jcon.__dict__, "_orig_contract_np", jcon.contract_np)
    monkeypatch.setitem(tcon.__dict__, "_orig_contract", tcon.contract)
    monkeypatch.setattr(jcon, "contract_np", spy_jcontract)
    monkeypatch.setattr(tcon, "contract", spy_tcontract)
    jt.workspace, pt.workspace = str(tmp_path / "j"), str(tmp_path / "t")
    jt.export_stage1(resolution=256)
    pt.export_stage1(resolution=256)
    assert len(seen["j_uv"]) == len(seen["t_uv"]) == 2
    for a, b in zip(seen["j_uv"], seen["t_uv"]):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
        assert np.abs(a).max() <= 2.0
    assert np.abs(seen["j_uv"][1]).max() > 1.0
    # JAX contracts each covered tile's points ([tile^2, 3], 0 where no
    # face covers a pixel); the port contracts the covered pixels only
    jp = [p[np.any(p != 0, axis=-1)] for p in seen["j_pts"]]
    jp = [p for p in jp if len(p)]
    assert len(jp) == len(seen["t_pts"]) > 0
    for a, b in zip(jp, seen["t_pts"]):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    out = tmp_path / "t" / "mesh_stage1"
    names = sorted(os.listdir(out))
    assert [n for n in names if n.endswith(".obj")] == ["mesh_0.obj",
                                                        "mesh_1.obj"]
    mlp = json.loads((out / "mlp.json").read_text())
    assert mlp["bound"] == 2.0 and mlp["cascade"] == 2
    for cas in (0, 1):
        assert (out / f"mesh_{cas}.obj").read_text() == (
            tmp_path / "j" / "mesh_stage1" / f"mesh_{cas}.obj").read_text()
