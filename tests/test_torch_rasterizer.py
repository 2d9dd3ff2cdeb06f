"""The port's rasterizer (nerf2mesh_tpu_torch/models/rasterizer.py) against
the JAX package's, on the CPU: the same clip-space vertices, triangles and
crop through ``rasterize_crop`` on both sides.

The cases are the meshes and cameras of tests/test_rasterizer.py,
tests/test_antialias.py and tests/test_area_coverage.py, plus perspective
views of a small icosphere (its vertices drawn from a seed).

The JAX function runs twice: jitted, as the JAX package runs it, and op by
op under ``jax.disable_jit()``, where every operation rounds as IEEE fp32
does on its own.  The two disagree with each other: the exact-area integral
subtracts squares of pixel offsets (catastrophic cancellation on steep
edges), and XLA's fused loops round it differently, by up to 6e-3 in the
area and 7e-4 in the extrapolated barycentrics of near-edge fragments on
these cases.  The port evaluates the same operations in the same order, so
it is held to the op-by-op run.  Tolerances:

* tri_id equal on at least 99.9% of the pixels;
* where tri_id agrees: bary, depth and area within atol 1e-5 of the
  op-by-op run; on the cases of JIT_CASES also tri_id against the jitted
  run, and bary, depth and area no farther from it than the op-by-op run
  is (+ 1e-5);
* rasterize_trig_id's ids equal on 99.9% of the pixels;
  subdivide_for_raster equal.
The gradients, interpolate, antialias and the jitted-JAX spread are in
tests/test_torch_rasterizer_grad.py (another file, so that the op-by-op
JAX compiles of the two run side by side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.models import rasterizer as jr
from nerf2mesh_tpu_torch.data.rays import make_mvps, make_projection, orbit_pose
from nerf2mesh_tpu_torch.meshing.meshops import midpoint_subdivide
from nerf2mesh_tpu_torch.models import rasterizer as tr


def ortho(verts_ndc):
    v = np.asarray(verts_ndc, np.float32)
    return np.concatenate([v, np.ones((len(v), 1), np.float32)], -1)


def screen16(pts_px, z=0.5):
    p = np.asarray(pts_px, np.float32)
    return ortho(np.stack([2 * p[:, 0] / 16 - 1, 2 * p[:, 1] / 16 - 1,
                           np.full(len(p), z, np.float32)], -1))


def px32(pts_px, z=0.5):
    p = np.asarray(pts_px, np.float32)
    return ortho(np.stack([2 * p[:, 0] / 32 - 1, 2 * p[:, 1] / 32 - 1,
                           np.full(len(p), z, np.float32)], -1))


def icosphere(level: int):
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
    return v / np.linalg.norm(v, axis=-1, keepdims=True), f


def sphere_clip(seed, level=2, H=32, W=32, radius=2.2):
    """A jittered icosphere seen by a perspective orbit camera."""
    rng = np.random.default_rng(seed)
    v, f = icosphere(level)
    v = 0.6 * v * (1 + 0.08 * rng.standard_normal((len(v), 1))).astype(
        np.float32)
    pose = orbit_pose(rng.uniform(0.6, 2.4), rng.uniform(0, 6.28), radius)
    mvp = make_mvps(make_projection(H, W, 0.9 * H, 0.05), pose[None])[0]
    vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], -1)
    return (vh @ mvp.T).astype(np.float32), f.astype(np.int32), v, mvp


def _overflow_case():
    rng = np.random.default_rng(0)
    c = rng.uniform(-0.8, 0.8, (40, 2))
    v = np.concatenate([c, c + [0.05, 0], c + [0, 0.05]], 0)
    n = np.arange(40)
    return (ortho(np.concatenate([v, np.full((120, 1), 0.5)], -1)),
            np.stack([n, n + 40, n + 80], -1))


def _subpixel_grid():
    n = 32
    xs = np.linspace(-0.5, 0.5, n + 1, dtype=np.float32)
    vv = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    idx = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:]
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([b, d, c], -1).reshape(-1, 3)])
    return ortho(np.concatenate([vv, np.full((len(vv), 1), 0.5)], -1)), tris


def _disc():
    n = 48
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([16 + 11.3 * np.cos(ang), 16 + 11.3 * np.sin(ang)], -1)
    verts = np.concatenate([[[16.0, 16.0]], pts])
    return px32(verts), [[0, 1 + i, 1 + (i + 1) % n] for i in range(n)]


def _cases():
    """name -> (clip [V, 4], tris [F, 3], origin, H, W, RasterSpec kwargs)."""
    s64 = dict(crop=64, max_tris=16, frag=64)
    s16 = dict(crop=16, max_tris=8, frag=16)
    s32 = dict(crop=32, max_tris=64, frag=32)
    persp = np.array([[-0.8, -0.8, 0.2, 1.0], [0.8, -0.8, 0.2, 1.0],
                      [-0.8, 0.8, 0.9, 4.0]], np.float32)
    persp[:, :3] *= persp[:, 3:4]
    nx = ny = 8.5 / 64 * 2 - 1
    e = 0.3 / 32
    ovf_v, ovf_f = _overflow_case()
    grid_v, grid_f = _subpixel_grid()
    disc_v, disc_f = _disc()
    quad = px32([[4.3, 5.1], [27.6, 4.7], [28.2, 26.9], [3.9, 27.4]])
    tri = np.array([[6.0, 6.0], [26.0, 8.0], [14.0, 25.0]])
    cases = {
        # tests/test_rasterizer.py
        "single": (ortho([[-1, -1, .5], [1, -1, .5], [-1, 1, .5]]),
                   [[0, 1, 2]], (0, 0), 64, 64, s64),
        "depth_order": (ortho([[-1, -1, .8], [1, -1, .8], [0, 1, .8],
                               [-1, -1, .2], [1, -1, .2], [0, 1, .2]]),
                        [[0, 1, 2], [3, 4, 5]], (0, 0), 64, 64, s64),
        "linear_field": (ortho([[-1, -1, .5], [3, -1, .5], [-1, 3, .5]]),
                         [[0, 1, 2]], (0, 0), 64, 64, s64),
        "perspective": (persp, [[0, 1, 2]], (0, 0), 64, 64, s64),
        "subpixel_grid": (grid_v, grid_f, (0, 0), 32, 32,
                          dict(crop=32, max_tris=2048, frag=8)),
        "overflow": (ovf_v, ovf_f, (0, 0), 64, 64,
                     dict(crop=64, max_tris=16, frag=8)),
        "inside_beats_edge": (
            ortho([[nx - .5, ny - .5, .8], [nx + .5, ny - .5, .8],
                   [nx, ny + .5, .8], [nx + e, ny - .5, .2],
                   [nx + .5, ny - .5, .2], [nx + e, ny + .5, .2]]),
            [[0, 1, 2], [3, 4, 5]], (0, 0), 64, 64, s64),
        "sliver": (ortho([[-.9, -.9, .2], [.9, .9, .2], [0, .0015, .2],
                          [-1, -1, .8], [1, -1, .8], [-1, 1, .8]]),
                   [[0, 1, 2], [3, 4, 5]], (0, 0), 64, 64, s64),
        # tests/test_antialias.py
        "aa_edge_7.3": (screen16([[7.3, -10], [7.3, 26], [-40, 8]]),
                        [[0, 1, 2]], (0, 0), 16, 16, s16),
        "aa_edge_6.8": (screen16([[6.8, -10], [6.8, 26], [-40, 8]]),
                        [[0, 1, 2]], (0, 0), 16, 16, s16),
        "aa_vertical": (screen16([[-10, 7.3], [26, 7.3], [8, -40]]),
                        [[0, 1, 2]], (0, 0), 16, 16, s16),
        "aa_occlusion": (np.concatenate([
            screen16([[7.4, -10], [7.4, 26], [-40, 8]], z=0.2),
            screen16([[-40, -40], [40, -40], [0, 40]], z=0.8)]),
            [[0, 1, 2], [3, 4, 5]], (0, 0), 16, 16, s16),
        # tests/test_area_coverage.py
        "area_quad": (quad, [[0, 1, 2], [0, 2, 3]], (0, 0), 32, 32, s32),
        "area_backface": (px32(np.concatenate([tri, tri])),
                          [[0, 1, 2], [3, 5, 4]], (0, 0), 32, 32, s32),
        "area_disc": (disc_v, disc_f, (0, 0), 32, 32, s32),
    }
    rng = np.random.default_rng(0)
    for i in range(3):
        t = rng.uniform(2.0, 30.0, size=(3, 2))
        cases[f"area_random_{i}"] = (px32(t), [[0, 1, 2]], (0, 0), 32, 32,
                                     s32)
    # perspective views of a jittered icosphere, one with a crop offset
    for seed in range(2):
        clip, f, _, _ = sphere_clip(seed)
        cases[f"sphere_{seed}"] = (clip, f, (0, 0), 32, 32,
                                   dict(crop=32, max_tris=512, frag=8))
    clip, f, _, _ = sphere_clip(5, H=48, W=48)
    cases["sphere_offset_crop"] = (clip, f, (9, 13), 48, 48,
                                   dict(crop=24, max_tris=512, frag=8))
    cases = {k: (np.asarray(v[0], np.float32), np.asarray(v[1], np.int32),
                 *v[2:]) for k, v in cases.items()}
    return _pad_groups(cases)


def _pad_groups(cases):
    """Pad the cases that share a RasterSpec to one vertex and face count,
    with faces far outside every crop (never compacted, so the outputs are
    those of the case alone): the op-by-op JAX run compiles each primitive
    once per shape, and shared shapes keep this file's time down."""
    groups = {}
    for name, (clip, tris, _, _, _, spec) in cases.items():
        g = groups.setdefault(tuple(sorted(spec.items())), [0, 0])
        g[0], g[1] = max(g[0], len(clip)), max(g[1], len(tris))
    out = {}
    for name, (clip, tris, origin, H, W, spec) in cases.items():
        V, F = groups[tuple(sorted(spec.items()))]
        far = np.tile(np.float32([100.0, 100.0, 0.5, 1.0]),
                      (V - len(clip) + 3, 1))
        v = np.concatenate([clip, far])
        f = np.concatenate([tris, np.tile(np.int32([len(clip), len(clip) + 1,
                                                    len(clip) + 2]),
                                          (F - len(tris), 1))])
        out[name] = (v, f, origin, H, W, spec)
    return out


CASES = _cases()


def jax_rast(clip, tris, origin, H, W, spec_kw, f_valid=None, jit=False):
    """The JAX rasterize_crop, op by op unless jit."""
    def run():
        return jr.rasterize_crop(
            jnp.asarray(clip), jnp.asarray(tris), jnp.asarray(origin), H, W,
            jr.RasterSpec(**spec_kw),
            f_valid=None if f_valid is None else jnp.asarray(f_valid))
    if jit:
        out = run()
    else:
        with jax.disable_jit():
            out = run()
    return {k: np.asarray(v) for k, v in out.items()}


def run_both(clip, tris, origin, H, W, spec_kw, f_valid=None):
    """(JAX op by op, port) outputs as numpy."""
    to = tr.rasterize_crop(torch.from_numpy(clip), torch.from_numpy(tris),
                           origin, H, W, tr.RasterSpec(**spec_kw),
                           f_valid=f_valid)
    return (jax_rast(clip, tris, origin, H, W, spec_kw, f_valid),
            {k: v.detach().numpy() for k, v in to.items()})


@pytest.mark.parametrize("name", sorted(CASES))
def test_rasterize_crop_matches_jax(name):
    clip, tris, origin, H, W, spec = CASES[name]
    jo, to = run_both(clip, tris, origin, H, W, spec)
    agree = jo["tri_id"] == to["tri_id"]
    assert agree.mean() >= 0.999, (name, agree.mean())
    for k in ("bary", "depth", "area"):
        np.testing.assert_allclose(to[k][agree], jo[k][agree], atol=1e-5,
                                   err_msg=f"{name}: {k}")
    for k in ("overflow", "n_live", "n_overlap"):
        assert int(to[k]) == int(jo[k]), (name, k, to[k], jo[k])
    if agree.all():
        for k in ("covered", "strict", "win_slot"):
            np.testing.assert_array_equal(to[k], jo[k], err_msg=f"{name}: {k}")
        for k in ("alpha", "union", "tri_sx", "tri_sy"):
            np.testing.assert_allclose(to[k], jo[k], atol=1e-5,
                                       err_msg=f"{name}: {k}")


def test_f_valid_masks_padding_like_jax():
    clip, tris, origin, H, W, spec = CASES["sphere_0"]
    pad = np.concatenate([tris, np.full((64, 3), len(clip) - 1, np.int32)])
    jo, to = run_both(clip, pad, origin, H, W, spec, f_valid=len(tris) - 40)
    np.testing.assert_array_equal(to["tri_id"], jo["tri_id"])
    assert int(to["n_overlap"]) == int(jo["n_overlap"])


def test_transform_clip_is_fp32_and_rounds_as_jax():
    rng = np.random.default_rng(4)
    v = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    mvp = rng.standard_normal((4, 4)).astype(np.float32)
    want = np.concatenate([v, np.ones((300, 1))], -1) @ mvp.T.astype(
        np.float64)
    got = tr.transform_clip(torch.from_numpy(v), torch.from_numpy(mvp))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jr.transform_clip(jnp.asarray(v),
                                                  jnp.asarray(mvp))))


def test_rasterize_trig_id_matches_jax():
    _, f, v, mvp = sphere_clip(2, level=2, H=40, W=40)
    jt = jr.rasterize_trig_id(jnp.asarray(v), jnp.asarray(f),
                              jnp.asarray(mvp), 40, 40, crop=16,
                              face_chunk=128)
    tt = tr.rasterize_trig_id(torch.from_numpy(v), torch.from_numpy(f),
                              torch.from_numpy(mvp), 40, 40, crop=16,
                              face_chunk=128)
    assert (jt >= 0).any()
    assert (tt == jt).mean() >= 0.999


def test_subdivide_for_raster_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    f = rng.integers(0, 60, (90, 3)).astype(np.int32)
    f = f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])]
    for kw in (dict(max_edge=0.4), dict(max_edge=0.01, max_faces=600)):
        jv, jf = jr.subdivide_for_raster(v, f, **kw)
        tv, tf = tr.subdivide_for_raster(v, f, **kw)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)


def test_spec_fields_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(tr.RasterSpec)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jr.RasterSpec)])
