"""The port's eval render against the JAX package, on the CPU at a small
size (6 levels, 2^14 tables, 32^3 grid, 32x32 frames).

Both sides render from identical parameters (``params_from_jax``; the hash
table uniform in +-1, so the field is far from empty) and an identical
occupancy state (``render_state_from_jax``, the JAX grid after one full
update from that field).  The JAX package on the CPU encodes through its
jitted ``hashgrid_encode``, where XLA fuses x * scale + shift into one
multiply-add; the port rounds the product and the sum apart (ROADMAP C), so
lattice fractions differ by an ulp, and a flipped early exit or occupancy
test at a pixel can follow.  Tolerances:

* sampler: valid masks equal; t_exit and sample positions atol 1e-5 * bound;
* image and weights_sum: |d| <= 1e-4 on all but 0.1% of the pixels, max |d|
  <= 5e-2; depth: the same rule times the largest far distance.
  Found: one segment, every pixel within 6e-7 (depth too); whole frames
  (frame queue, render_image fused and host loop), one pixel of the 1024
  outside 1e-4, at max |d| 2.1e-4 (image), 1.9e-4 (weights_sum) and 5.6e-4
  (depth, far 3.97).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.models import renderer as jren
from nerf2mesh_tpu.ops import sampling as jsamp
from nerf2mesh_tpu.utils import metrics as jmet
from nerf2mesh_tpu.utils import trainer as jtr
from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
from nerf2mesh_tpu_torch.data.rays import get_rays
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
from nerf2mesh_tpu_torch.models import renderer as tren
from nerf2mesh_tpu_torch.ops import sampling as tsamp
from nerf2mesh_tpu_torch.utils import metrics as tmet
from nerf2mesh_tpu_torch.utils import trainer as ttr
from nerf2mesh_tpu_torch.utils.convert import (load_params, params_from_jax,
                                               render_state_from_jax)

SCENE = dict(H=32, W=32, n_train=4, n_val=1, n_test=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side, and torch's default of a thread per core
    in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def tiny(cls, **kw):
    base = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
                num_points=4096, grid_size=32, num_levels=6,
                log2_hashmap_size=14, mark_untrained=True)
    base.update(kw)
    return dataclasses.replace(cls(path=""), **base).finalize()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX trainer and a port trainer with the same EMA weights (the
    eval renders from those) and the same occupancy state."""
    frames = render_synthetic_frames(**SCENE)
    jcfg = tiny(JConfig, workspace=str(tmp_path_factory.mktemp("ws")))
    jt = jtr.Trainer(jcfg)
    rng = np.random.default_rng(0)
    params = dict(jt.state.params)
    params["table"] = jnp.asarray(rng.uniform(
        -1, 1, params["table"].shape).astype(np.float32))
    jt.state = jt.state._replace(params=params, ema_params=params)
    val = dataset_from_frames(tiny(TConfig), frames, "val")
    jt.mark_untrained(dataset_from_frames(tiny(TConfig), frames, "train"))
    jt.update_grid(0)
    r = jt.state.render
    occ = np.asarray(r.occ_grid)
    assert 0.02 < occ.mean() < 0.98               # a grid with structure

    pt = ttr.Trainer(tiny(TConfig), device="cpu",
                     workspace=str(tmp_path_factory.mktemp("port_ws")))
    load_params(pt.params, params_from_jax(params))
    load_params(pt.ema_field, params_from_jax(params))
    pt.render = render_state_from_jax(r.density_grid, r.occ_grid,
                                      r.mean_density, r.iter_density)
    assert pt.net_spec.encode_gather_levels == jt.net_spec.encode_gather_levels
    return jt, pt, val


def frame_rays(val):
    fx, fy, cx, cy = (float(v) for v in val.intrinsics_for(0))
    rays = get_rays(T(val.poses[:1]), (fx, fy, cx, cy), val.H, val.W)
    return rays["rays_o"].contiguous().numpy(), rays["rays_d"].numpy()


def assert_frame_close(got, want, scale=1.0):
    """|d| <= 1e-4 * scale on all but 0.1% of the pixels, max <= 5e-2 *
    scale; returns (share of pixels outside 1e-4 * scale, max |d|)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    d = d.reshape(d.shape[0] * d.shape[1], -1).max(-1) if d.ndim == 3 \
        else d.reshape(-1)
    share = float((d > 1e-4 * scale).mean())
    assert share <= 1e-3 and d.max() <= 5e-2 * scale, (share, d.max())
    return share, float(d.max())


def test_render_state_from_jax(pair):
    jt, pt, _ = pair
    r = jt.state.render
    assert pt.render.occ_grid.dtype == torch.uint8
    np.testing.assert_array_equal(pt.render.occ_grid.numpy(),
                                  np.asarray(r.occ_grid))
    np.testing.assert_array_equal(pt.render.density_grid.numpy(),
                                  np.asarray(r.density_grid))
    assert float(pt.render.mean_density) == float(r.mean_density)
    assert pt.render.iter_density == int(r.iter_density) > 0


def test_occupied_length_and_segment_sampling(pair):
    """occupied_length and segment-mode sample_rays (sample_dt, t_exit,
    exhausted rays) against JAX on the same rays, grid and spacing."""
    jt, pt, val = pair
    o, d = frame_rays(val)
    occ = np.asarray(jt.state.render.occ_grid)
    spec = pt.render_spec
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jn, jf = jsamp.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(aabb), spec.min_near)
    kw = dict(num_coarse=spec.num_coarse, grid_size=spec.grid_size,
              cascades=1, bound=1.0, contracted=False, dt_gamma=0.0,
              max_steps=spec.max_steps)
    jol = np.asarray(jsamp.occupied_length(jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(occ), jn, jf, **kw))
    nears, fars = T(np.asarray(jn)), T(np.asarray(jf))
    tol = tsamp.occupied_length(T(o), T(d), T(occ), nears, fars, **kw)
    np.testing.assert_allclose(tol.numpy(), jol, atol=1e-5)
    assert (jol > 0).mean() > 0.2
    # a second segment starts where the first one stopped
    sd = np.maximum(jol / 128, 2 * np.sqrt(3) / spec.max_steps).astype(np.float32)
    tn, jnn = nears, jn
    for _ in range(2):
        jm = jsamp.sample_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ),
                               jnn, jf, num_fine=32, sample_dt=jnp.asarray(sd),
                               **kw)
        tm = tsamp.sample_rays(T(o), T(d), T(occ), tn, fars, num_fine=32,
                               sample_dt=T(sd), **kw)
        np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
        for k in ("ts", "dts", "xyzs", "t_exit"):
            np.testing.assert_allclose(getattr(tm, k).numpy(),
                                       np.asarray(getattr(jm, k)), atol=1e-5,
                                       err_msg=k)
        tn, jnn = tm.t_exit, jm.t_exit
    # some rays exhausted their occupied space (t_exit = far + 1)
    assert bool((tn == fars + 1.0).any()) and bool((tn < fars).any())


def test_render_eval_segment_matches_jax(pair):
    jt, pt, val = pair
    o, d = frame_rays(val)
    occ = jt.state.render.occ_grid
    seg_spec = dataclasses.replace(pt.render_spec, num_fine=32)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    nears, fars, olen, sd = tren.eval_spacing(T(o), T(d), pt.render.occ_grid,
                                              T(aabb), pt.render_spec, 128)
    want = jren.render_eval_segment(
        jt.state.params, occ, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(nears.numpy()), jnp.asarray(fars.numpy()),
        jnp.asarray(sd.numpy()), jren.RenderSpec(**dataclasses.asdict(seg_spec)),
        jt.net_spec)
    got = tren.render_eval_segment(pt.params, pt.render.occ_grid, T(o), T(d),
                                   nears, fars, sd, seg_spec, pt.net_spec)
    H, W = val.H, val.W
    far = float(fars.max())
    assert float(np.asarray(want["weights_sum"]).max()) > 0.2
    assert_frame_close(got["image"].reshape(H, W, 3),
                       np.asarray(want["image"]).reshape(H, W, 3))
    assert_frame_close(got["weights_sum"].reshape(H, W),
                       np.asarray(want["weights_sum"]).reshape(H, W))
    assert_frame_close(got["depth"].reshape(H, W),
                       np.asarray(want["depth"]).reshape(H, W), far)
    np.testing.assert_allclose(got["t_exit"].numpy(),
                               np.asarray(want["t_exit"]), atol=1e-5)


def test_render_frame_queue_matches_jax(pair):
    """The alive-ray queue at 512 rays a round (two rounds' worth of rays
    alive at first, dead rays padding the later rounds)."""
    jt, pt, val = pair
    o, d = frame_rays(val)
    seg_spec = dataclasses.replace(pt.render_spec, num_fine=32)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    frame = jax.jit(lambda p, occ, ro, rd: jren.render_frame_queue(
        p, occ, ro, rd, jnp.asarray(aabb),
        jren.RenderSpec(**dataclasses.asdict(seg_spec)), jt.net_spec,
        chunk=512, eval_fine=128))
    want = frame(jt.state.params, jt.state.render.occ_grid, jnp.asarray(o),
                 jnp.asarray(d))
    got = tren.render_frame_queue(pt.params, pt.render.occ_grid, T(o), T(d),
                                  T(aabb), seg_spec, pt.net_spec, chunk=512,
                                  eval_fine=128)
    H, W = val.H, val.W
    assert got["iters"] == int(want["iters"]) > 2
    assert_frame_close(got["image"].reshape(H, W, 3),
                       np.asarray(want["image"]).reshape(H, W, 3))
    assert_frame_close(got["weights_sum"].reshape(H, W),
                       np.asarray(want["weights_sum"]).reshape(H, W))
    far = float(np.linalg.norm(val.poses[0, :3, 3])) + np.sqrt(3)
    assert_frame_close(got["depth"].reshape(H, W),
                       np.asarray(want["depth"]).reshape(H, W), far)


@pytest.mark.parametrize("fused", [True, False])
def test_render_image_matches_jax(pair, fused):
    jt, pt, val = pair
    args = (val.poses[0], val.intrinsics_for(0), val.H, val.W)
    want = jt.render_image(*args, fused=fused)
    got = pt.render_image(*args, fused=fused)
    far = float(np.linalg.norm(val.poses[0, :3, 3])) + np.sqrt(3)
    assert_frame_close(got["image"], want["image"])
    assert_frame_close(got["weights_sum"], want["weights_sum"])
    assert_frame_close(got["depth"], want["depth"], far)
    assert got["rounds"] > 1
    # the two port paths march the same rays the same way
    other = pt.render_image(*args, fused=not fused)
    np.testing.assert_allclose(other["image"], got["image"], atol=1e-6)


def test_evaluate_psnr_matches_jax(pair):
    jt, pt, val = pair
    want = jt.evaluate(val, name="val", track_best=False)
    got = pt.evaluate(val, name="val")
    assert set(got) == set(want) == {"PSNR"}
    np.testing.assert_allclose(got["PSNR"], want["PSNR"], atol=1e-3)
    assert pt.stats["best"] == got["PSNR"]


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for jm, tm in ((jmet.PSNRMeter(), tmet.PSNRMeter()),
                   (jmet.SSIMMeter(), tmet.SSIMMeter())):
        for _ in range(2):
            jm.update(a, b)
            tm.update(a, b)
        np.testing.assert_allclose(tm.measure(), jm.measure(), rtol=1e-6)
        assert tm.name == jm.name
    # no lpips package on either side: both report the weight-free proxy
    jm, tm = jmet.LPIPSMeter(), tmet.LPIPSMeter()
    for _ in range(2):
        jm.update(a, b)
        tm.update(a, b)
    assert tm.name == jm.name == "LPIPS (proxy)"
    np.testing.assert_allclose(tm.measure(), jm.measure(), atol=1e-5)
    assert tm.measure() > 0
