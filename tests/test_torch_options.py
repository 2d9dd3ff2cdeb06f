"""The port's trainer options against nerf2mesh_tpu on the CPU at a small
size (6 levels, 2^14 tables, 32^3 grid, 256 rays, a 32^2 scene): the bf16
MLPs of --fp16 (-O), depth supervision (sparse and dense), patches, the
linear colour space, the trainable density grid and per-image codes.

Tolerances:
* fp16 field: sigma, colour and specular within 4x the spread between
  JAX's jitted field and the same field run op by op (jax.disable_jit) on
  the same inputs (both round the same operands to bf16, so the spread is
  the fp32 accumulation order of the products, which is also what
  separates the port from JAX).  The table and MLP gradients of a weighted
  sum of them: within that 4x spread plus one bf16 step of the largest
  entry (2^-7 max|g|), and 1e-3 in relative L2.  The casts' backward
  rounds the cotangents to bf16 in both packages, and another fp32 sum
  order can round a cotangent to the neighbouring bf16 value: JAX's own
  two runs do so for the ref table (found up to 6e-4 relative L2 from the
  port, 2.4e-5 for the table; block512 within the spread).
* One training step per option: loss rtol 1e-4; the table's gradient
  within 1e-3 * max|g| and 2e-4 in relative L2, the MLPs' (and the codes')
  within 2e-4 * max|g| and 1e-4.  That is the slice test's relative L2
  (tests/test_torch_slice.py, where the docstring explains the ulp-level
  sample positions behind it) doubled for the table: under patches the 256
  rays are 16 4x4 blocks of one view, so the differences gather in fewer
  entries (found 1.46e-4 relative L2 and 5.1e-4 max|g| there, at most
  6.7e-5 and 1.7e-4 elsewhere); elementwise bounds are taken against
  max|g|, since an entry whose corner weights nearly cancel differs in
  relative terms.  Under fp16 the field test's bf16 rule: 2^-7 max|g| and
  1e-3 relative L2.
* The trainable grid's slab update: atol 1e-5 (the slab update tests'
  bound); the stage-1 crop with a per-image code: the crop test's bounds
  (tests/test_torch_stage1.py: image 1e-4, table gradient 1e-4 relative L2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset as jgen
from nerf2mesh_tpu.models import mlp as jmlp
from nerf2mesh_tpu.models import network as jnet
from nerf2mesh_tpu.models import rasterizer as jr
from nerf2mesh_tpu.models import renderer as jren
from nerf2mesh_tpu.models import stage1 as js1
from nerf2mesh_tpu.utils import trainer as jtr
from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
from nerf2mesh_tpu_torch.meshing.meshops import midpoint_subdivide
from nerf2mesh_tpu_torch.models import mlp as tmlp
from nerf2mesh_tpu_torch.models import network as tnet
from nerf2mesh_tpu_torch.models import rasterizer as tr
from nerf2mesh_tpu_torch.models import renderer as tren
from nerf2mesh_tpu_torch.models import stage1 as ts1
from nerf2mesh_tpu_torch.utils import trainer as ttr
from nerf2mesh_tpu_torch.utils.convert import (load_params, params_from_jax,
                                               params_to_numpy,
                                               render_state_from_jax)

SCENE = dict(H=32, W=32, n_train=6, n_val=0, n_test=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def tiny(cls, root="", **kw):
    base = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
                num_points=4096, grid_size=32, num_levels=6,
                log2_hashmap_size=14, random_image_batch=True,
                background="random", mark_untrained=True,
                adaptive_num_rays=True, diffuse_step=1000,
                stochastic_fine=False, iters=2000)
    base.update(kw)
    return dataclasses.replace(cls(path=root), **base).finalize()


# ------------------------------------------------------------------ C1: fp16

def test_mlp_bf16_matches_apply_mlp_and_returns_fp32():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 19)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    net = tmlp.MLP(19, 4, 32, 3, gen)
    params = [{"w": jnp.asarray(layer.w.detach().numpy())} for layer in net]
    want = np.asarray(jmlp.apply_mlp(params, jnp.asarray(x),
                                     compute_dtype=jnp.bfloat16))
    got = net(T(x), torch.bfloat16).detach()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the last layer is not rounded: almost no output is bf16-representable
    assert (got.to(torch.bfloat16).float() == got).float().mean() < 0.05
    # the hidden activations are: an fp32 net differs by the bf16 rounding
    full = net(T(x)).detach()
    assert (got - full).abs().max() > 1e-4


def _field_loss_jax(jspec, x, d, w):
    def f(params):
        sig, col, spec, _ = jnet.field_forward(params, x, d, jspec,
                                               jnp.asarray(True))
        return (jnp.sum(sig * w[:, 0]) + jnp.sum(col * w[:, 1:4])
                + jnp.sum(spec * w[:, 4:7])), (sig, col, spec)
    return jax.value_and_grad(f, has_aux=True)


@pytest.mark.parametrize("layout", ["block512", "ref"])
def test_fp16_field_and_gradients_match_jax(layout):
    kw = dict(bound=1.0, num_levels=6, log2_hashmap_size=14,
              grid_layout=layout, fp16=True)
    jspec, tspec = jnet.NetworkSpec(**kw), tnet.NetworkSpec(**kw)
    params = jnet.init_network(jax.random.PRNGKey(0), jspec)
    rng = np.random.default_rng(1)
    params = dict(params, table=jnp.asarray(rng.uniform(
        -1, 1, params["table"].shape).astype(np.float32)))
    x = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    d = rng.normal(size=(600, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = rng.normal(size=(600, 7)).astype(np.float32)
    fn = _field_loss_jax(jspec, jnp.asarray(x), jnp.asarray(d),
                         jnp.asarray(w))
    (_, jit_out), jit_g = jax.jit(fn)(params)
    with jax.disable_jit():
        (_, op_out), op_g = fn(params)
    field = tnet.NeRFField(tspec, torch.Generator().manual_seed(0))
    load_params(field, params_from_jax(params))
    sig, col, spec, _ = tnet.field_forward(field, T(x), T(d), tspec, True)
    ((sig * T(w[:, 0])).sum() + (col * T(w[:, 1:4])).sum()
     + (spec * T(w[:, 4:7])).sum()).backward()
    for name, got, a, b in zip(("sigma", "color", "specular"),
                               (sig, col, spec), jit_out, op_out):
        spread = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        err = float(np.abs(got.detach().numpy() - np.asarray(a)).max())
        assert err <= 4 * spread + 1e-7, (name, err, spread)
    gj, go = params_from_jax(jit_g), params_from_jax(op_g)
    for name, p in field.named_parameters():
        a, b = gj[name].numpy(), go[name].numpy()
        spread = float(np.abs(a - b).max())
        err = float(np.abs(p.grad.numpy() - a).max())
        scale = float(np.abs(a).max())
        assert err <= 4 * spread + 2 ** -7 * scale, (name, err, spread)
        assert np.linalg.norm(p.grad.numpy() - a) <= 1e-3 * np.linalg.norm(
            a), name


# --------------------------------------------------- one step per option

def _trainers(tmp_path, **kw):
    root = str(tmp_path / "scene")
    jgen(root, **SCENE)
    jcfg = tiny(JConfig, root, workspace=str(tmp_path / "ws"), **kw)
    jds = jload(jcfg, "train")
    jt = jtr.Trainer(jcfg)
    params = jt.state.params
    jt.mark_untrained(jds)
    jt.update_grid(0)
    r = jt.state.render
    tcfg = tiny(TConfig, **kw)
    tds = dataset_from_frames(tcfg, render_synthetic_frames(**SCENE))
    np.testing.assert_array_equal(tds.images, jds.images)
    pt = ttr.Trainer(tcfg, device="cpu", workspace=str(tmp_path / "tws"))
    load_params(pt.params, params_from_jax(params))
    pt.render = render_state_from_jax(r.density_grid, r.occ_grid,
                                      r.mean_density, r.iter_density)
    return jt, pt, jds, tds


def _key_with_use_sd(want: bool) -> jax.Array:
    """A step key whose sparse-depth draw (JAX's k_sd) is `want`."""
    for seed in range(1000):
        key = jax.random.PRNGKey(seed)
        k_sd = jax.random.split(key, 5)[4]
        if bool(jax.random.uniform(k_sd, ()) > 0.9) == want:
            return key
    raise AssertionError("no key")


def _depth_data(jds, kind, rng):
    """Depth supervision arrays for the scene's views: dense [B, H, W] maps,
    or sparse records of 40-60 pixels a view padded to [B, R]."""
    B, H, W, _ = jds.images.shape
    if kind == "dense":
        dense = rng.uniform(0.5, 3.0, (B, H, W)).astype(np.float32)
        dense[rng.random((B, H, W)) < 0.1] = 0.0      # unsupervised pixels
        return {"dense": dense}
    recs = []
    for _ in range(B):
        m = int(rng.integers(40, 61))
        xy = np.stack([rng.integers(0, H, m), rng.integers(0, W, m)],
                      -1).astype(np.int32)
        recs.append((xy, rng.uniform(0.5, 3.0, m).astype(np.float32),
                     rng.uniform(0.1, 2.0, m).astype(np.float32)))
    R = max(len(r_[0]) for r_ in recs)
    sc = np.zeros((B, R), np.int32)
    sd, sw, sv = (np.zeros((B, R), np.float32) for _ in range(3))
    for i, (xy, d, w) in enumerate(recs):
        sc[i, :len(xy)] = xy[:, 0] * W + xy[:, 1]
        sd[i, :len(xy)], sw[i, :len(xy)], sv[i, :len(xy)] = d, w, 1.0
    return {"sparse": (sc, sd, sw, sv)}, recs


CASES = {
    "sparse_depth_on": dict(enable_sparse_depth=True),
    "sparse_depth_off": dict(enable_sparse_depth=True),
    "dense_depth": dict(enable_dense_depth=True),
    "patch": dict(patch_size=4),
    "linear": dict(color_space="linear"),
    "ind_codes": dict(ind_dim=4, ind_num=8),
    "fp16": dict(fp16=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_option_step_matches_jax(tmp_path, case):
    """One training step's loss and gradients under each option, on JAX's
    draws; the depth cases at step 1000 (the depth term's ramp is full)."""
    jt, pt, jds, tds = _trainers(tmp_path, **CASES[case])
    N, Kf = 256, jt.cfg.samples_per_ray
    B, H, W, _ = jds.images.shape
    step = 1000 if "depth" in case else 0
    key = (_key_with_use_sd(case == "sparse_depth_on")
           if case.startswith("sparse") else jax.random.PRNGKey(11))
    rng = np.random.default_rng(5)
    jdepth = tdepth = None
    if "depth" in case:
        if case == "dense_depth":
            jdepth = _depth_data(jds, "dense", rng)
            pt_ds = dataclasses.replace(tds, dense_depth=jdepth["dense"])
        else:
            jdepth, recs = _depth_data(jds, "sparse", rng)
            pt_ds = dataclasses.replace(tds, sparse_depth=recs)
        jdepth = {k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                      else jnp.asarray(v)) for k, v in jdepth.items()}
    else:
        pt_ds = tds
    r = jt.state.render
    dyn = jt.dynamics(step)

    def loss_fn(p):
        return jt._loss_and_metrics(
            p, r, key, jnp.asarray(jds.images), jnp.asarray(jds.poses),
            jnp.asarray(jds.intrinsics), None, dyn, N, depth_data=jdepth)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jt.state.params)
    # JAX's draws from its own keys (trainer.py _loss_and_metrics)
    k_img, k_pix, k_bg, k_march, k_sd = jax.random.split(key, 5)
    img_idx = np.asarray(jax.random.randint(k_img, (N,), 0, B))
    if not jt.cfg.random_image_batch or jt.cfg.patch_size > 1:
        img_idx = np.broadcast_to(img_idx[:1], (N,))
    if jt.cfg.patch_size > 1:
        ps = jt.cfg.patch_size
        ky, kx = jax.random.split(k_pix)
        y0 = np.asarray(jax.random.randint(ky, (N // ps ** 2,), 0, H - ps))
        x0 = np.asarray(jax.random.randint(kx, (N // ps ** 2,), 0, W - ps))
        oy, ox = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
        pix = ((y0 * W + x0)[:, None] + (oy * W + ox).reshape(1, -1)
               ).reshape(-1)
    else:
        pix = np.asarray(jax.random.randint(k_pix, (N,), 0, H * W))
    draws = {"img_idx": T(img_idx), "pix_idx": T(pix),
             "bg": T(jax.random.uniform(k_bg, (N, 3))),
             "u": T(jax.random.uniform(k_march, (N, Kf)))}
    if case.startswith("sparse"):
        draws["use_sd"] = T(jax.random.uniform(k_sd, ()) > 0.9)
        assert bool(draws["use_sd"]) == (case == "sparse_depth_on")
    images_t, poses_t, intr_t = pt._prep_train_arrays(pt_ds)
    loss, tm = pt._loss_and_metrics(pt.params, pt.render, images_t, poses_t,
                                    intr_t, pt.dynamics(step), N, draws,
                                    depth=pt._train_depth)
    loss.backward()
    if case in ("sparse_depth_on", "dense_depth"):
        assert float(tm["depth_loss"]) > 0
    elif case == "sparse_depth_off":
        assert float(tm["depth_loss"]) == 0
    assert int(tm["num_points"]) == int(jm["num_points"]) > 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    jg = params_from_jax(jgrads)
    names = [n for n, _ in pt.params.named_parameters()]
    assert sorted(names) == sorted(jg)
    for name, p in pt.params.named_parameters():
        want = jg[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(want).max())
        if scale == 0:                          # diffuse warmup: no gradient
            assert not got.any(), name
            continue
        if case == "fp16":
            atol, l2 = 2 ** -7, 1e-3
        else:
            atol, l2 = (1e-3, 2e-4) if name == "table" else (2e-4, 1e-4)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale,
                                   err_msg=name)
        assert np.linalg.norm(got - want) <= l2 * np.linalg.norm(want), name


def test_port_draws_patches_and_the_sparse_depth_draw():
    cfg = tiny(TConfig, patch_size=4, enable_sparse_depth=True)
    pt = ttr.Trainer(cfg, device="cpu")
    d = pt.draw(256, 6, 32, 32)
    assert (d["img_idx"] == d["img_idx"][0]).all()
    pix = d["pix_idx"].reshape(16, 16)
    rows, cols = pix // 32, pix % 32
    # each group of 16 is a 4x4 block at its top-left corner
    assert ((rows - rows[:, :1]).reshape(16, 4, 4) ==
            torch.arange(4)[None, :, None]).all()
    assert ((cols - cols[:, :1]).reshape(16, 4, 4) ==
            torch.arange(4)[None, None, :]).all()
    assert d["use_sd"].dtype == torch.bool and d["use_sd"].ndim == 0
    assert "use_sd" not in ttr.Trainer(tiny(TConfig), device="cpu").draw(
        256, 6, 32, 32)
    with pytest.raises(ValueError, match="patches"):
        pt.draw(250, 6, 32, 32)


def test_trainable_density_grid_update_matches_jax():
    """One slab of the trainable grid's descent step (two cascades at bound
    2, lambda_density 1e-2) on JAX's jitter."""
    kw = dict(bound=2.0, num_levels=6, log2_hashmap_size=14,
              grid_layout="block512")
    jspec, tspec = jnet.NetworkSpec(**kw), tnet.NetworkSpec(**kw)
    params = jnet.init_network(jax.random.PRNGKey(3), jspec)
    rng = np.random.default_rng(2)
    params = dict(params, table=jnp.asarray(rng.uniform(
        -1, 1, params["table"].shape).astype(np.float32)))
    field = tnet.NeRFField(tspec, torch.Generator().manual_seed(0))
    load_params(field, params_from_jax(params))
    rkw = dict(bound=2.0, grid_size=16, num_coarse=64, num_fine=16)
    jrs, trs = jren.RenderSpec(**rkw), tren.RenderSpec(**rkw)
    grid = rng.uniform(0, 20, (2, 16, 16, 16)).astype(np.float32)
    grid[rng.random(grid.shape) < 0.1] = -1.0          # untrained cells
    jstate = jren.RenderState(jnp.asarray(grid), jnp.asarray(
        (grid > 5).astype(np.uint8)), jnp.asarray(5.0), 3)
    tstate = render_state_from_jax(grid, (grid > 5).astype(np.uint8),
                                   np.float32(5.0), 3)
    key = jax.random.PRNGKey(7)
    slab = 2
    with jax.disable_jit():
        out = jren._update_density_slab(
            params, jstate, key, jrs, jspec, None, jnp.int32(slab),
            trainable=True, lambda_density=1e-2)
    H = 16
    n = (H // tren.GRID_UPDATE_SLABS) * H * H
    keys = jax.random.split(key, 2)
    noise = [T(jax.random.uniform(keys[c], (n, 3), minval=-min(2 ** c, 2) / H,
                                  maxval=min(2 ** c, 2) / H))
             for c in range(2)]
    got = tren._update_density_slab(field, tstate, noise, trs, tspec, None,
                                    slab, trainable=True, lambda_density=1e-2)
    want = np.asarray(out.density_grid)
    np.testing.assert_allclose(got.density_grid.numpy(), want, atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got.occ_grid.numpy(),
                                  np.asarray(out.occ_grid))
    # it moved the slab, not by the EMA-max
    ema = tren._update_density_slab(field, tstate, noise, trs, tspec, None,
                                    slab)
    assert np.abs(got.density_grid.numpy() - grid).max() > 0
    assert np.abs(got.density_grid.numpy()
                  - ema.density_grid.numpy()).max() > 1e-3


# ------------------------------------------------------------ per-image codes

def test_individual_codes_carry_across_bit_exactly(tmp_path):
    kw = dict(ind_dim=4, ind_num=8)
    jt = jtr.Trainer(tiny(JConfig, workspace=str(tmp_path / "j"), **kw))
    pt = ttr.Trainer(tiny(TConfig, **kw), device="cpu",
                     workspace=str(tmp_path / "t"))
    params = jt.state.params
    assert params["individual_codes"].shape == (8, 4)
    load_params(pt.params, params_from_jax(params))
    back = params_to_numpy(dict(pt.params.named_parameters()))
    np.testing.assert_array_equal(back["individual_codes"],
                                  np.asarray(params["individual_codes"]))
    np.testing.assert_array_equal(back["color_net"][0]["w"],
                                  np.asarray(params["color_net"][0]["w"]))
    # the codes train at 0.1x the lr, with the SDF variance
    base, slow = ttr.split_slow(pt.params)
    assert [p.shape for p in slow] == [torch.Size([8, 4])]
    # and survive the port's checkpoint
    pt.save_checkpoint()
    fresh = ttr.Trainer(tiny(TConfig, **kw), device="cpu",
                        workspace=str(tmp_path / "t"))
    assert fresh.load_checkpoint()
    np.testing.assert_array_equal(
        fresh.params.individual_codes.detach().numpy(),
        np.asarray(params["individual_codes"]))


def _icosphere(level=2, r=0.45):
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


def test_stage1_crop_with_individual_code_matches_jax(tmp_path):
    """A stage-1 crop render with view 2's code (JAX: params[codes][idx]
    [None]) and its gradients, op by op as tests/test_torch_stage1.py."""
    kw = dict(ind_dim=4, ind_num=8)
    frames = render_synthetic_frames(H=32, W=32, n_train=4, n_val=1, n_test=0)
    jt = jtr.Trainer(tiny(JConfig, workspace=str(tmp_path / "j"), **kw))
    rng = np.random.default_rng(0)
    params = dict(jt.state.params)
    params["table"] = jnp.asarray(rng.uniform(
        -1, 1, params["table"].shape).astype(np.float32))
    jt.state = jt.state._replace(params=params, ema_params=params)
    pt = ttr.Trainer(tiny(TConfig, **kw), device="cpu",
                     workspace=str(tmp_path / "t"))
    load_params(pt.params, params_from_jax(params))
    val = dataset_from_frames(tiny(TConfig), frames, "val")
    v, f = _icosphere()
    crop = 32
    fx, fy, cx, cy = (float(a) for a in val.intrinsics_for(0))
    jj, ii = np.meshgrid(np.arange(crop) + 0.5, np.arange(crop) + 0.5,
                         indexing="ij")
    dcam = np.stack([(ii - cx) / fx, -(jj - cy) / fy, -np.ones_like(ii)], -1)
    dirs = (dcam.reshape(-1, 3) @ val.poses[0][:3, :3].T).reshape(
        crop, crop, 3).astype(np.float32)
    bg = rng.uniform(0, 1, (crop, crop, 3)).astype(np.float32)
    mvp = val.mvps[0].astype(np.float32)
    offs = np.zeros_like(v)
    w_img = rng.standard_normal((crop, crop, 3)).astype(np.float32)
    spec = dict(crop=crop, max_tris=512, frag=8)

    def jloss(p):
        out = js1.render_stage1_crop(
            p, jnp.asarray(offs), jnp.asarray(v), jnp.asarray(f),
            jnp.asarray(mvp), jnp.asarray((0, 0)), jnp.asarray(dirs),
            jnp.asarray(bg), jt.net_spec, jr.RasterSpec(**spec), val.H,
            val.W, shading="full", alpha_mode="area",
            ind_code=p["individual_codes"][2][None])
        return jnp.sum(out["image"] * w_img), out

    with jax.disable_jit():
        (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    out = ts1.render_stage1_crop(
        pt.params, T(offs), T(v), T(f), T(mvp), (0, 0), T(dirs), T(bg),
        pt.net_spec, tr.RasterSpec(**spec), val.H, val.W, shading="full",
        alpha_mode="area", ind_code=pt.params.individual_codes[2][None])
    (out["image"] * T(w_img)).sum().backward()
    np.testing.assert_allclose(out["image"].detach().numpy(),
                               np.asarray(jout["image"]), atol=1e-4)
    for name in ("table", "individual_codes"):
        got = getattr(pt.params, name).grad.numpy()
        want = np.asarray(jg[name])
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert np.linalg.norm(want) > 0 and rel <= 1e-4, (name, rel)
    # only view 2's code takes a gradient
    g = pt.params.individual_codes.grad.numpy()
    assert np.abs(g[2]).max() > 0 and not np.delete(g, 2, 0).any()


def test_eval_and_export_queries_take_code_zero():
    """With ind_dim > 0 a colour query without a code uses code 0, the
    reference's code for unseen views (JAX's eval passes none, and its
    colour MLP then refuses the input)."""
    spec = tnet.NetworkSpec(bound=1.0, num_levels=6, log2_hashmap_size=14,
                            grid_layout="ref", ind_dim=4, ind_num=8)
    field = tnet.NeRFField(spec, torch.Generator().manual_seed(0))
    x = torch.rand((50, 3)) * 2 - 1
    a = tnet.geo_feat(field, x, spec)
    b = tnet.geo_feat(field, x, spec, c=field.individual_codes[:1])
    c = tnet.geo_feat(field, x, spec, c=field.individual_codes[3:4])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 0
