"""The port's rasterizer against the JAX package's, continued from
tests/test_torch_rasterizer.py (its cases, and its reasons for running
JAX op by op under ``jax.disable_jit()``):

* the gradient w.r.t. verts_clip of a random weighting of the outputs, in
  the "area" (area, bary, depth), "soft" (alpha, bary, depth) and "aa"
  (the antialiased strict coverage) modes, within 1e-4 relative L2 of
  jax.grad's, on inputs where every tri_id agrees;
* interpolate and antialias within atol 1e-5;
* on some cases, the port against the jitted JAX run: tri_id on 99.9% of
  the pixels, and bary, depth and area no farther from it than the
  op-by-op run is (+ 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.models import rasterizer as jr
from nerf2mesh_tpu_torch.models import rasterizer as tr
from test_torch_rasterizer import CASES, jax_rast, run_both


# two shape groups (the perspective sphere, the occlusion boundary): each
# new shape costs the op-by-op JAX run a compile of every primitive
GRAD_CASES = [("sphere_0", "area"), ("sphere_0", "soft"),
              ("sphere_0", "aa"), ("sphere_1", "aa"), ("aa_occlusion", "aa")]


def _weights(shape_img, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_img).astype(np.float32),
            rng.standard_normal(shape_img + (3,)).astype(np.float32),
            rng.standard_normal(shape_img).astype(np.float32),
            rng.uniform(0, 1, shape_img + (C,)).astype(np.float32))


@pytest.mark.parametrize("name,mode", GRAD_CASES)
def test_verts_clip_gradient_matches_jax(name, mode):
    clip, tris, origin, H, W, spec = CASES[name]
    jo, to = run_both(clip, tris, origin, H, W, spec)
    assert (jo["tri_id"] == to["tri_id"]).all(), name
    C = spec["crop"]
    w_cov, w_bary, w_depth, color = _weights((C, C), 3, 7)

    def jloss(c):
        r = jr.rasterize_crop(c, jnp.asarray(tris), jnp.asarray(origin), H, W,
                              jr.RasterSpec(**spec))
        if mode == "aa":
            a = r["strict"].astype(jnp.float32)[..., None]
            rgba = jnp.concatenate([a * jnp.asarray(color), a], -1)
            out = jr.antialias(rgba, r, jnp.asarray(origin))
            return jnp.sum(out[..., :3] * jnp.asarray(w_bary)) + jnp.sum(
                out[..., 3] * jnp.asarray(w_cov))
        cov = r["area"] if mode == "area" else r["alpha"]
        return (jnp.sum(cov * jnp.asarray(w_cov))
                + jnp.sum(r["bary"] * jnp.asarray(w_bary))
                + jnp.sum(r["depth"] * jnp.asarray(w_depth)))

    def tloss(c):
        r = tr.rasterize_crop(c, torch.from_numpy(tris), origin, H, W,
                              tr.RasterSpec(**spec))
        if mode == "aa":
            a = r["strict"].float()[..., None]
            rgba = torch.cat([a * torch.from_numpy(color), a], -1)
            out = tr.antialias(rgba, r, origin)
            return (out[..., :3] * torch.from_numpy(w_bary)).sum() + (
                out[..., 3] * torch.from_numpy(w_cov)).sum()
        cov = r["area"] if mode == "area" else r["alpha"]
        return ((cov * torch.from_numpy(w_cov)).sum()
                + (r["bary"] * torch.from_numpy(w_bary)).sum()
                + (r["depth"] * torch.from_numpy(w_depth)).sum())

    with jax.disable_jit():
        gj = np.asarray(jax.grad(jloss)(jnp.asarray(clip)))
    ct = torch.from_numpy(clip.copy()).requires_grad_(True)
    tloss(ct).backward()
    gt = ct.grad.numpy()
    assert np.isfinite(gt).all()
    norm = np.linalg.norm(gj)
    assert norm > 0, (name, mode)
    rel = np.linalg.norm(gt - gj) / norm
    assert rel <= 1e-4, (name, mode, rel)


@pytest.mark.parametrize("name", ["sphere_1", "aa_occlusion"])
def test_interpolate_and_antialias_match_jax(name):
    clip, tris, origin, H, W, spec = CASES[name]
    rng = np.random.default_rng(3)
    attrs = rng.standard_normal((len(clip), 5)).astype(np.float32)
    C = spec["crop"]
    rgba = rng.uniform(0, 1, (C, C, 5)).astype(np.float32)
    with jax.disable_jit():
        jrast = jr.rasterize_crop(jnp.asarray(clip), jnp.asarray(tris),
                                  jnp.asarray(origin), H, W,
                                  jr.RasterSpec(**spec))
        ji = np.asarray(jr.interpolate(jnp.asarray(attrs), jrast,
                                       jnp.asarray(tris)))
        ja = np.asarray(jr.antialias(jnp.asarray(rgba), jrast,
                                     jnp.asarray(origin)))
    trast = tr.rasterize_crop(torch.from_numpy(clip), torch.from_numpy(tris),
                              origin, H, W, tr.RasterSpec(**spec))
    np.testing.assert_array_equal(trast["tri_id"].numpy(),
                                  np.asarray(jrast["tri_id"]))
    ti = tr.interpolate(torch.from_numpy(attrs), trast,
                        torch.from_numpy(tris)).numpy()
    np.testing.assert_allclose(ti, ji, atol=1e-5)
    ta = tr.antialias(torch.from_numpy(rgba), trast, origin).numpy()
    np.testing.assert_allclose(ta, ja, atol=1e-5)


JIT_CASES = ["sphere_0", "aa_occlusion"]


@pytest.mark.parametrize("name", JIT_CASES)
def test_within_the_spread_of_jitted_jax(name):
    clip, tris, origin, H, W, spec = CASES[name]
    jo, to = run_both(clip, tris, origin, H, W, spec)
    jit = jax_rast(clip, tris, origin, H, W, spec, jit=True)
    agree = (jit["tri_id"] == to["tri_id"]) & (jo["tri_id"] == to["tri_id"])
    assert agree.mean() >= 0.999, (name, agree.mean())
    for k in ("bary", "depth", "area"):
        spread = np.abs(jo[k][agree] - jit[k][agree])
        assert (np.abs(to[k][agree] - jit[k][agree]) <= spread + 1e-5).all(), \
            (name, k)
