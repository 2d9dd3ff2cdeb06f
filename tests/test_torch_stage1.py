"""The port's stage 1 and mesh export against the JAX package's, on the CPU
at a small size (6 levels, 2^14-row block512 table, 32^2 frames, a
162-vertex icosphere), with the same parameters on both sides
(``params_from_jax``) and inputs made from a seed.

The JAX rasterizer's jitted and op-by-op results differ by float32
cancellation (tests/test_torch_rasterizer.py), so the JAX side of the crop
render runs op by op (``jax.disable_jit``); the port's forward then matches
it bit for bit up to the field.  Tolerances: the crop render's image within
atol 1e-4; the table's gradient within 1e-4 relative L2 (found 1.7e-7 and
8.7e-6); the offsets' within 5e-4 (found 1.55e-4 at shell 1, 8.0e-5 at
shell 4): their only path is the exact-area integral, whose backward
rounds its divisions in another order than JAX's transposes (JAX
multiplies by y^-2 where autograd divides by y*y) and whose cancellation
amplifies that; JAX's own jitted gradient differs from its op-by-op one by
12% here (shell 1 and shell 4, ssaa 1 and 2); the mesh losses and their
gradients 1e-5 relative; the snap atol 1e-5; the refine equal; one Adam
update after the optimizer reset at step > 0 within atol 1e-7 of optax's
with its count kept; the stage-0 export at resolution 48 of a smooth ball
field: vertex and face counts within 0.5% and the symmetric mean
nearest-vertex distance <= 1e-3 before the decimation, the Chamfer distance
(area samples to the other surface) <= 1e-3 after it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.tree_utils as otu
import pytest
import torch
from scipy.spatial import cKDTree

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.meshing import export as jexp
from nerf2mesh_tpu.models import rasterizer as jr
from nerf2mesh_tpu.models import stage1 as js1
from nerf2mesh_tpu.utils import trainer as jtr
from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
from nerf2mesh_tpu_torch.meshing import export as texp
from nerf2mesh_tpu_torch.meshing.meshops import midpoint_subdivide
from nerf2mesh_tpu_torch.models import rasterizer as tr
from nerf2mesh_tpu_torch.models import stage1 as ts1
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


def tiny(cls, **kw):
    base = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
                num_points=4096, grid_size=32, num_levels=6,
                log2_hashmap_size=14, mark_untrained=True, iters=1000)
    base.update(kw)
    return dataclasses.replace(cls(path=""), **base).finalize()


def icosphere(level=2, r=0.45):
    t = (1.0 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float32)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    for _ in range(level):
        v, f = midpoint_subdivide(v, f, np.ones(len(f), bool))
    return (r * v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
        np.float32), f.astype(np.int32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX trainer and a port trainer with the same live weights (a
    random table) and occupancy state, and the val view."""
    frames = render_synthetic_frames(H=32, W=32, n_train=4, n_val=1, n_test=0)
    jt = jtr.Trainer(tiny(JConfig, workspace=str(
        tmp_path_factory.mktemp("jws"))))
    rng = np.random.default_rng(0)
    params = dict(jt.state.params)
    params["table"] = jnp.asarray(rng.uniform(
        -1, 1, params["table"].shape).astype(np.float32))
    jt.state = jt.state._replace(params=params, ema_params=params)
    jt.mark_untrained(dataset_from_frames(tiny(TConfig), frames, "train"))
    jt.update_grid(0)
    r = jt.state.render
    pt = ttr.Trainer(tiny(TConfig), device="cpu",
                     workspace=str(tmp_path_factory.mktemp("tws")))
    load_params(pt.params, params_from_jax(params))
    load_params(pt.ema_field, params_from_jax(params))
    pt.render = render_state_from_jax(r.density_grid, r.occ_grid,
                                      r.mean_density, r.iter_density)
    val = dataset_from_frames(tiny(TConfig), frames, "val")
    return jt, pt, val


def sphere_params(params, seed=0):
    """Weights whose density is a smooth ball: 31 hidden units relu(n_k . x)
    over random unit directions (their sum ~ 31|x|/4), one unit relu(mean of
    the density features) ~ 1 (the table's density channel ~1, with a
    little noise), so that h ~ 8 - 16|x|; random colour channels."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, params)
    L = p["sigma_net"][0]["w"].shape[0] - 3
    n = rng.standard_normal((3, 31))
    w0 = np.zeros((3 + L, 32), np.float32)
    w0[:3, :31] = n / np.linalg.norm(n, axis=0)
    w0[3:, 31] = 1.0 / L
    w1 = np.full((32, 1), -16.0 * 4 / 31, np.float32)
    w1[31] = 8.0
    table = rng.uniform(-0.3, 0.3, p["table"].shape).astype(np.float32)
    table[:, 0] = 1.0 + rng.uniform(-0.02, 0.02, len(table))
    out = dict(p, table=table, sigma_net=[{"w": w0}, {"w": w1}])
    return jax.tree_util.tree_map(jnp.asarray, out)


@pytest.fixture(scope="module")
def ball(tmp_path_factory):
    """A JAX trainer and a port trainer on the smooth ball field, with the
    occupancy state after one full update, and the val view."""
    frames = render_synthetic_frames(H=32, W=32, n_train=4, n_val=1, n_test=0)
    jt = jtr.Trainer(tiny(JConfig, workspace=str(
        tmp_path_factory.mktemp("jball"))))
    params = sphere_params(jt.state.params)
    jt.state = jt.state._replace(params=params, ema_params=params)
    jt.update_grid(0)
    r = jt.state.render
    pt = ttr.Trainer(tiny(TConfig), device="cpu",
                     workspace=str(tmp_path_factory.mktemp("tball")))
    load_params(pt.params, params_from_jax(params))
    pt.render = render_state_from_jax(r.density_grid, r.occ_grid,
                                      r.mean_density, r.iter_density)
    return jt, pt, dataset_from_frames(tiny(TConfig), frames, "val")


def crop_inputs(val, crop, ss, origin, seed):
    """Per-pixel view dirs at the supersampled centers, a random
    background, the mvp."""
    Cs = crop * ss
    fx, fy, cx, cy = (float(v) for v in val.intrinsics_for(0))
    sub = (np.arange(Cs) + 0.5) / ss
    jj, ii = np.meshgrid(origin[0] + sub, origin[1] + sub, indexing="ij")
    dcam = np.stack([(ii - cx) / fx, -(jj - cy) / fy, -np.ones_like(ii)], -1)
    dirs = (dcam.reshape(-1, 3) @ val.poses[0][:3, :3].T).reshape(
        Cs, Cs, 3).astype(np.float32)
    bg = np.random.default_rng(seed).uniform(0, 1, (Cs, Cs, 3)).astype(
        np.float32)
    return dirs, bg, val.mvps[0].astype(np.float32)


@pytest.mark.parametrize("shell,ssaa,crop,origin",
                         [(1, 1, 32, (0, 0)), (4, 2, 16, (8, 6))])
def test_render_stage1_crop_matches_jax(pair, shell, ssaa, crop, origin):
    jt, pt, val = pair
    v, f = icosphere()
    rng = np.random.default_rng(1)
    offs = (0.005 * rng.standard_normal(v.shape)).astype(np.float32)
    dirs, bg, mvp = crop_inputs(val, crop, ssaa, origin, 2)
    spec = dict(crop=crop, max_tris=512, frag=8)
    kw = dict(shading="full", ssaa=ssaa, alpha_mode="area", shell_k=shell,
              shell_h=0.04)
    w_img = rng.standard_normal((crop, crop, 3)).astype(np.float32)
    w_ws = rng.standard_normal((crop, crop)).astype(np.float32)

    def jloss(params, o):
        out = js1.render_stage1_crop(
            params, o, jnp.asarray(v), jnp.asarray(f), jnp.asarray(mvp),
            jnp.asarray(origin), jnp.asarray(dirs), jnp.asarray(bg),
            jt.net_spec, jr.RasterSpec(**spec), val.H, val.W, **kw)
        return (jnp.sum(out["image"] * w_img)
                + jnp.sum(out["weights_sum"] * w_ws)), out

    with jax.disable_jit():
        (_, jout), (jg_p, jg_o) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jt.state.params,
                                                jnp.asarray(offs))
    o_t = T(offs).requires_grad_(True)
    pt.params.zero_grad(set_to_none=True)
    out = ts1.render_stage1_crop(
        pt.params, o_t, T(v), T(f), T(mvp), origin, T(dirs), T(bg),
        pt.net_spec, tr.RasterSpec(**spec), val.H, val.W, **kw)
    ((out["image"] * T(w_img)).sum()
     + (out["weights_sum"] * T(w_ws)).sum()).backward()

    np.testing.assert_array_equal(out["trig_id"].numpy(),
                                  np.asarray(jout["trig_id"]))
    assert (np.asarray(jout["trig_id"]) >= 0).mean() > 0.2
    np.testing.assert_allclose(out["image"].detach().numpy(),
                               np.asarray(jout["image"]), atol=1e-4)
    np.testing.assert_allclose(out["weights_sum"].detach().numpy(),
                               np.asarray(jout["weights_sum"]), atol=1e-4)
    for name, got, want, tol in (
            ("offsets", o_t.grad.numpy(), np.asarray(jg_o), 5e-4),
            ("table", pt.params.table.grad.numpy(), np.asarray(jg_p["table"]),
             1e-4)):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert np.linalg.norm(want) > 0 and rel <= tol, (name, rel)


def padded_mesh(seed=3):
    v, f = icosphere(1)
    m = ts1.Stage1Mesh(vertices=v, triangles=f, v_cumsum=np.array([0, len(v)]),
                       f_cumsum=np.array([0, len(f)]))
    return m, ts1.pad_stage1_buffers(m, min_b=64)


def test_mesh_buffers_and_losses_match_jax():
    m, pad = padded_mesh()
    jm = js1.Stage1Mesh(vertices=m.vertices, triangles=m.triangles,
                        v_cumsum=m.v_cumsum, f_cumsum=m.f_cumsum)
    jpad = js1.pad_stage1_buffers(jm, min_b=64)
    for k in pad:
        np.testing.assert_array_equal(pad[k], jpad[k], err_msg=k)
    rng = np.random.default_rng(4)
    offs = (0.02 * rng.standard_normal(pad["vertices"].shape)).astype(
        np.float32)
    vr, fr, er, pr, vi = (int(c) for c in pad["counts"])

    def jlosses(o):
        verts = jnp.asarray(pad["vertices"]) + o
        c = jnp.asarray(pad["counts"])
        return jnp.stack([
            js1.laplacian_loss(verts, jnp.asarray(pad["edges"]),
                               jnp.asarray(pad["vert_degree"]), c[0], c[2]),
            js1.normal_consistency_loss(verts, jnp.asarray(pad["triangles"]),
                                        jnp.asarray(pad["face_pairs"]), c[3]),
            js1.edge_length_loss(verts, jnp.asarray(pad["edges"]), c[2]),
            js1.offsets_loss(o, c[4], 1.0, c[0])])

    def tlosses(o):
        verts = T(pad["vertices"]) + o
        return torch.stack([
            ts1.laplacian_loss(verts, T(pad["edges"]), T(pad["vert_degree"]),
                               vr, er),
            ts1.normal_consistency_loss(verts, T(pad["triangles"]),
                                        T(pad["face_pairs"]), pr),
            ts1.edge_length_loss(verts, T(pad["edges"]), er),
            ts1.offsets_loss(o, vi, 1.0, vr)])

    want = np.asarray(jlosses(jnp.asarray(offs)))
    o_t = T(offs).requires_grad_(True)
    got = tlosses(o_t)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    w = np.array([0.3, -1.2, 2.0, 0.7], np.float32)
    jg = np.asarray(jax.grad(lambda o: jnp.sum(jlosses(o) * w))(
        jnp.asarray(offs)))
    (got * T(w)).sum().backward()
    assert np.linalg.norm(o_t.grad.numpy() - jg) <= 1e-5 * np.linalg.norm(jg)


def test_snap_to_apparent_surface_matches_jax(ball):
    jt, pt, _ = ball
    v, f = icosphere(1, r=0.42)
    want = js1.snap_to_apparent_surface(jt.state.params, v, f, jt.net_spec,
                                        band=0.15, n_samples=16, chunk=64,
                                        passes=2)
    got = ts1.snap_to_apparent_surface(pt.params, v, f, pt.net_spec,
                                       band=0.15, n_samples=16, chunk=64,
                                       passes=2)
    assert np.abs(want - v).max() > 1e-3       # the probe moved vertices
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_refine_and_decimate_matches_jax(tmp_path):
    v, f = icosphere(3, r=0.5)
    m = ts1.Stage1Mesh(vertices=v, triangles=f, v_cumsum=np.array([0, len(v)]),
                       f_cumsum=np.array([0, len(f)]))
    rng = np.random.default_rng(5)
    offs = (0.003 * rng.standard_normal(v.shape)).astype(np.float32)
    errors = rng.uniform(0, 1, len(f)).astype(np.float32)
    counts = rng.integers(0, 4, len(f)).astype(np.float32)
    kw = dict(refine_size=0.02, refine_remesh_size=0.05)
    jm = js1.refine_and_decimate(
        js1.Stage1Mesh(vertices=v, triangles=f, v_cumsum=m.v_cumsum,
                       f_cumsum=m.f_cumsum), offs, errors, counts,
        tiny(JConfig, **kw), str(tmp_path / "j"), max_faces=2000)
    tm = ts1.refine_and_decimate(m, offs, errors, counts, tiny(TConfig, **kw),
                                 str(tmp_path / "t"), max_faces=2000)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    assert tm.num_faces != len(f)
    assert ((tmp_path / "t" / "mesh_stage0" / "mesh_0_updated.ply").read_bytes()
            == (tmp_path / "j" / "mesh_stage0" / "mesh_0_updated.ply")
            .read_bytes())


@pytest.mark.parametrize("count", [0, 37, 600])
def test_adam_update_after_reset_matches_optax(count):
    """One update of make_stage1_optimizer at `count` (fresh moments, the
    count kept: the reset after a refine) equals optax's multi_transform
    with tree_set(count=...), for the field (warmup/decay schedule) and the
    offsets (the vertex schedule over a 700-step horizon)."""
    jcfg, tcfg = tiny(JConfig), tiny(TConfig)
    rng = np.random.default_rng(count)
    params = {"table": 0.1 * rng.standard_normal((64, 3)).astype(np.float32),
              "sigma_net": [{"w": 0.1 * rng.standard_normal((9, 4)).astype(
                  np.float32)}],
              "vertices_offsets": 0.01 * rng.standard_normal((20, 3)).astype(
                  np.float32)}
    grads = {k: (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
             if k != "sigma_net" else [{"w": rng.standard_normal(
                 (9, 4)).astype(np.float32)}]
             for k, v in params.items()}
    opt = jtr.make_optimizer(jcfg, vert_horizon=700)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = opt.init(jp)
    if count:
        st = otu.tree_set(st, count=jnp.asarray(count, jnp.int32))
    up, _ = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), st, jp)
    want = optax.apply_updates(jp, up)

    field = [torch.nn.Parameter(T(params["table"])),
             torch.nn.Parameter(T(params["sigma_net"][0]["w"]))]
    offs = torch.nn.Parameter(T(params["vertices_offsets"]))
    topt, _ = ttr.make_stage1_optimizer(tcfg, field, offs, step=count,
                                        vert_horizon=700)
    for p, g in zip(field + [offs], (grads["table"], grads["sigma_net"][0]["w"],
                                     grads["vertices_offsets"])):
        p.grad = T(g)
    topt.step()
    for got, key in ((field[0], "table"), (offs, "vertices_offsets")):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want[key]), rtol=0, atol=1e-7)
    np.testing.assert_allclose(field[1].detach().numpy(),
                               np.asarray(want["sigma_net"][0]["w"]), atol=1e-7)


def test_vertex_lr_schedule_matches_jax():
    """The vertex lr at count c is the size of one Adam step from zeroed
    moments (|update| = lr when |g| >> eps, up to the fp32 rounding of the
    bias corrections): optax's against vert_schedule."""
    jcfg, tcfg = tiny(JConfig), tiny(TConfig)
    sched = ttr.vert_schedule(tcfg, 300)
    opt = jtr.make_optimizer(jcfg, vert_horizon=300)
    p = {"vertices_offsets": jnp.zeros((1, 3))}
    for c in (0, 1, 150, 299, 300, 5000):
        st = otu.tree_set(opt.init(p), count=jnp.asarray(c, jnp.int32))
        up, _ = opt.update({"vertices_offsets": jnp.ones((1, 3))}, st, p)
        # zero moments and one unit gradient at count c: Adam's bias
        # corrections at step c + 1 scale the step
        mhat = 0.1 / (1 - 0.9 ** (c + 1))
        vhat = 0.001 / (1 - 0.999 ** (c + 1))
        np.testing.assert_allclose(-float(up["vertices_offsets"][0, 0]),
                                   sched(c) * mhat / np.sqrt(vhat),
                                   rtol=2e-5)


def test_trainer_reset_restarts_moments_and_keeps_the_count(pair, tmp_path):
    """Trainer._reset_stage1_params after training steps: fresh offsets of
    the padded size, zero moments, every count at the global step, the
    schedules positioned there, the EMA re-copied from the live weights."""
    _, _, val = pair
    from nerf2mesh_tpu_torch.meshing.io import write_ply
    ws = tmp_path / "ws"
    (ws / "mesh_stage0").mkdir(parents=True)
    v, f = icosphere(2)
    write_ply(str(ws / "mesh_stage0" / "mesh_0.ply"), v, f)
    cfg = tiny(TConfig, stage=1, iters=8, s1_snap_surface=False,
               workspace=str(ws))
    t = ttr.Trainer(cfg, device="cpu")
    t.setup_stage1(val)
    t.train_stage1(val, max_steps=3)
    assert t.step == 3
    t.stage1_mesh = ts1.Stage1Mesh(
        vertices=v[:100], triangles=f[(f < 100).all(1)],
        v_cumsum=np.array([0, 100]),
        f_cumsum=np.array([0, int((f < 100).all(1).sum())]))
    t._reset_stage1_params()
    assert t.vertices_offsets.shape == (1024, 3)
    groups = t.optimizer.param_groups
    assert groups[1]["params"][0] is t.vertices_offsets
    for g in groups:
        for p in g["params"]:
            st = t.optimizer.state[p]
            assert int(st["step"]) == 3
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    assert t.lr_scheduler.last_epoch == 3
    assert groups[1]["lr"] == pytest.approx(ttr.vert_schedule(cfg, 3)(3))
    for k, p in t.params.named_parameters():
        assert torch.equal(t.ema_params[k], p.detach())


def surf_dist(a, b):
    """Symmetric mean nearest-vertex distance between two vertex sets."""
    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def point_triangle_dist(p, a, b, c):
    """Distance from points p [N, 3] to triangles (a, b, c) [N, 3] each
    (closest point on a triangle, Ericson's region tests)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    bp, cp = p - b, p - c
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    den = np.where(np.abs(va + vb + vc) > 1e-30, va + vb + vc, 1e-30)
    q = a + ab * (vb / den)[:, None] + ac * (vc / den)[:, None]   # inside
    t_ab = np.clip(d1 / np.where(d1 - d3 != 0, d1 - d3, 1), 0, 1)
    t_ac = np.clip(d2 / np.where(d2 - d6 != 0, d2 - d6, 1), 0, 1)
    t_bc = np.clip((d4 - d3) / np.where((d4 - d3) + (d5 - d6) != 0,
                                        (d4 - d3) + (d5 - d6), 1), 0, 1)
    cands = [q, a + ab * t_ab[:, None], a + ac * t_ac[:, None],
             b + (c - b) * t_bc[:, None]]
    inside = (va >= 0) & (vb >= 0) & (vc >= 0)
    dist = [np.linalg.norm(p - x, axis=-1) for x in cands]
    edge = np.minimum(np.minimum(dist[1], dist[2]), dist[3])
    return np.where(inside, dist[0], edge)


def chamfer(va, fa, vb, fb, n=20000, k=16, seed=0):
    """Symmetric mean distance from n area-weighted surface samples of each
    mesh to the other's surface (exact point-to-triangle distance over the
    k triangles with the nearest centroids)."""
    rng = np.random.default_rng(seed)

    def samples(v, f):
        t = v[f]
        area = 0.5 * np.linalg.norm(np.cross(t[:, 1] - t[:, 0],
                                             t[:, 2] - t[:, 0]), axis=-1)
        i = rng.choice(len(f), n, p=area / area.sum())
        r1, r2 = rng.uniform(size=(2, n, 1))
        s1 = np.sqrt(r1)
        return (1 - s1) * t[i, 0] + s1 * (1 - r2) * t[i, 1] + s1 * r2 * t[i, 2]

    def one_way(p, v, f):
        t = v[f]
        _, idx = cKDTree(t.mean(1)).query(p, k=k)
        d = [point_triangle_dist(p, t[idx[:, j], 0], t[idx[:, j], 1],
                                 t[idx[:, j], 2]) for j in range(k)]
        return np.min(d, axis=0).mean()

    va, vb = va.astype(np.float64), vb.astype(np.float64)
    return 0.5 * (one_way(samples(va, fa), vb, fb)
                  + one_way(samples(vb, fb), va, fa))


def test_export_stage0_mesh_matches_jax(ball, tmp_path):
    jt, pt, _ = ball
    from nerf2mesh_tpu_torch.meshing.io import read_ply
    res = 48
    for dec, name in ((0, "full"), (4000, "dec")):
        jexp.export_stage0_mesh(jt, str(tmp_path / f"j_{name}"),
                                resolution=res, decimate_target=dec)
        texp.export_stage0_mesh(pt, str(tmp_path / f"t_{name}"),
                                resolution=res, decimate_target=dec)
        jv, jf = read_ply(str(tmp_path / f"j_{name}" / "mesh_0.ply"))
        tv, tf = read_ply(str(tmp_path / f"t_{name}" / "mesh_0.ply"))
        assert len(jf) > 0
        if dec == 0:
            assert surf_dist(tv, jv) <= 1e-3
            assert abs(len(tv) - len(jv)) <= 0.005 * len(jv)
            assert abs(len(tf) - len(jf)) <= 0.005 * len(jf)
        else:
            # the quadric decimation's greedy order is chaotic in the ulps of
            # its input, so the two meshes differ in their vertices; their
            # surfaces agree
            d = chamfer(tv, tf, jv, jf)
            assert d <= 1e-3, d
            assert len(jf) <= 4010 and len(tf) <= 4010


def test_mark_unseen_triangles_matches_jax(pair):
    _, _, val = pair
    v, f = icosphere(3, r=0.45)
    mvps = np.concatenate([val.mvps, val.mvps @ np.diag(
        [1, -1, 1, 1]).astype(np.float32)])
    want = jexp.mark_unseen_triangles(v, f, mvps, val.H, val.W)
    got = texp.mark_unseen_triangles(v, f, mvps, val.H, val.W)
    assert 0 < want.mean() < 1
    assert (got == want).mean() >= 0.99


def test_field_colour_heads_match_jax(pair):
    """geo_feat, rgb (full / diffuse / specular) and rgb_train (both
    switches), which stage 1 and its bake shade with, on the same weights
    and points: atol 1e-5."""
    from nerf2mesh_tpu.models import network as jnet
    from nerf2mesh_tpu_torch.models import network as tnet
    jt, pt, _ = pair
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.9, 0.9, (2000, 3)).astype(np.float32)
    d = rng.standard_normal((2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jp, jspec = jt.state.params, jt.net_spec
    with torch.no_grad():
        np.testing.assert_allclose(
            tnet.geo_feat(pt.params, T(x), pt.net_spec).numpy(),
            np.asarray(jnet.geo_feat(jp, jnp.asarray(x), jspec)), atol=1e-5)
        for shading in ("full", "diffuse", "specular"):
            tc, ts = tnet.rgb(pt.params, T(x), T(d), pt.net_spec, shading)
            jc, js = jnet.rgb(jp, jnp.asarray(x), jnp.asarray(d), jspec,
                              None, shading)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
            assert (ts is None) == (js is None)
        for full in (False, True):
            tc, ts = tnet.rgb_train(pt.params, T(x), T(d), pt.net_spec, full)
            jc, js = jnet.rgb_train(jp, jnp.asarray(x), jnp.asarray(d), jspec,
                                    jnp.asarray(full))
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
