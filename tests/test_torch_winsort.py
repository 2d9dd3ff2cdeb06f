"""The port's window-sorted (winsort) encode against the JAX package, on the
CPU at a small size (6 levels, 2^14 tables, resolution 256).

The same numpy inputs go through JAX's ``splat_encode_raw(...,
winsort_levels=wl, interpret=True)``, whose Pallas kernels ``_ws_fwd_kernel``
and ``_ws_bwd_kernel`` then run in interpret mode (as tests/test_splat.py
calls them), and through the port, whose wrappers take the plain versions of
K5/K6 on CPU tensors.  Tolerances:

* the window sort (perm, slots, slot membership): exactly equal;
* the kernel part alone (the port's plain K5 against JAX's ``_inwin_ws``):
  atol 1e-6 wherever both round the lattice position alike, 5e-5 where
  XLA's fused multiply-add in the interpret-mode kernel moves it by an ulp;
* the full features against ``hashgrid_encode`` and JAX's winsort encode:
  atol 2e-6, rtol 1e-5;
* the table gradient against JAX's: atol 1e-4, rtol 1e-4.

JAX's residual budget and its ``lax.cond`` full-gather fallback have no
counterpart in the port; the parity test takes JAX through both branches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.ops import hashgrid as jhg
from nerf2mesh_tpu.ops import splat_encode as jse
from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
from nerf2mesh_tpu_torch.ops import hashgrid as thg
from nerf2mesh_tpu_torch.ops import splat_encode as tse
from nerf2mesh_tpu_torch.utils.trainer import Trainer

KW = dict(num_levels=6, level_dim=3, log2_hashmap_size=14,
          desired_resolution=256, layout="block512")
JS, TS = jhg.HashGridSpec(**KW), thg.HashGridSpec(**KW)
WL = (3, 4, 5)                 # hashed levels of the small spec


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


def inputs(n=512, seed=0):
    """Uniform random points (no spatial locality, the fine-level regime),
    with out-of-bounds points that sort into the last tile, and a uniform
    +-1 table."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[[7, 100, 301]] = [1.3, 0.5, 0.5]
    x[[8, 450]] = [0.5, -0.2, 0.5]
    table = rng.uniform(-1, 1, (JS.table_size, 3)).astype(np.float32)
    g = rng.normal(size=(n, JS.output_dim)).astype(np.float32)
    return x, table, g


def jax_winsort_meta(x, l):
    """JAX's window sort of one level (splat_encode.py:798-812)."""
    xc = jnp.clip(jnp.asarray(x), 0.0, 1.0)
    oob = jnp.any((x < 0.0) | (x > 1.0), axis=-1)
    wp = jse._point_windows(xc, jnp.asarray(oob), JS, l)
    perm = jnp.argsort(jnp.where(wp < 0, jnp.int32(0x7FFFFFFF), wp))
    tw = jnp.take(wp, perm).reshape(-1, jse.TILE)
    s0, s1 = jnp.maximum(tw[:, 0], 0), jnp.maximum(tw[:, -1], 0)
    in_slot = np.zeros(x.shape[0], bool)
    in_slot[np.asarray(perm)] = np.asarray(
        (tw == s0[:, None]) | (tw == s1[:, None])).reshape(-1)
    return (np.asarray(perm), np.asarray(tw).reshape(-1),
            np.asarray(jnp.stack([s0, s1], 1)), in_slot)


def jax_inwin_ws(table, x, levels):
    """JAX's winsort kernel part alone (``_inwin_ws``, Pallas interpret), in
    the caller's point order: [N, Lw, 3] (splat_encode.py:795-834)."""
    N = x.shape[0]
    xc = np.clip(x, 0.0, 1.0)
    x_ws, rows, perms = [], [], []
    for l in levels:
        perm, tw, slots, _ = jax_winsort_meta(x, l)
        xt = np.concatenate([xc[perm].reshape(-1, jse.TILE, 3).transpose(0, 2, 1),
                             tw.reshape(-1, 1, jse.TILE).astype(np.float32)], 1)
        x_ws.append(np.pad(xt, ((0, 0), (0, 4), (0, 0))).reshape(-1, jse.TILE))
        rows.append(slots)
        perms.append(perm)
    k_ws = np.asarray(jse._inwin_ws(
        jse.to_splat(jnp.asarray(table), JS), jnp.asarray(np.stack(x_ws)),
        jnp.asarray(np.stack(rows)), JS, tuple(levels), True))
    out = np.zeros((N, len(levels), 3), np.float32)
    for i, perm in enumerate(perms):
        kf = k_ws[i].reshape(-1, 8, jse.TILE)[:, :3].transpose(0, 2, 1)
        out[perm, i] = kf.reshape(N, 3)
    return out


def port_meta(x, levels):
    xc = T(np.clip(x, 0.0, 1.0))
    oob = T(np.any((x < 0.0) | (x > 1.0), axis=-1))
    metas = [tse.winsort_meta(xc, oob, TS, l) for l in levels]
    return (xc, torch.stack([m[0] for m in metas]).to(torch.int32),
            torch.stack([m[1] for m in metas]),
            torch.stack([m[2] for m in metas]), metas)


def test_winsort_meta_equal():
    x, _, _ = inputs()
    _, perm, wins, slots, metas = port_meta(x, WL)
    for k, l in enumerate(WL):
        jperm, jtw, jslots, jin = jax_winsort_meta(x, l)
        np.testing.assert_array_equal(perm[k].numpy(), jperm)
        np.testing.assert_array_equal(wins[k].numpy(), jtw)
        np.testing.assert_array_equal(slots[k].numpy(), jslots)
        np.testing.assert_array_equal(metas[k][3].numpy(), jin)
    # the last tile holds the oob points (window -1) behind its live ones
    assert (wins[:, -5:] == -1).all() and (wins[:, -6] >= 0).all()


def fma_rounds_alike(x, levels):
    """[N, Lw] bool: x * scale + 0.5 rounds to the same float32 whether the
    product is rounded first (the port, the CUDA kernels) or fused into one
    multiply-add (XLA's CPU compile of the interpret-mode Pallas kernel)."""
    xc = np.clip(x, 0.0, 1.0)
    out = []
    for l in levels:
        s = np.float32(TS.level_scale32(l))
        sep = (xc * s).astype(np.float32) + np.float32(0.5)
        fused = (xc.astype(np.float64) * np.float64(s) + 0.5).astype(np.float32)
        out.append((sep == fused).all(-1))
    return np.stack(out, 1)


def test_winsort_kernel_part_matches_jax_inwin_ws():
    """The port's plain K5 output == JAX's _inwin_ws (Pallas interpret),
    atol 1e-6 wherever both sides round the lattice position alike (97-99%
    of the points by level).  XLA compiles the interpret-mode kernel with
    x * scale + shift fused into one multiply-add; where that moves the
    position by an ulp (<= 1.5e-5 below 256), a weight moves as much, and
    those points are held to 5e-5 (found: 1.14e-6)."""
    x, table, _ = inputs()
    xc, perm, wins, slots, _ = port_meta(x, WL)
    got = tse.winsort_fwd(T(table), xc, perm, wins, slots, TS, WL)  # CPU: plain
    want = jax_inwin_ws(table, x, WL)
    alike = fma_rounds_alike(x, WL)
    assert alike.mean() > 0.95
    err = np.abs(got.numpy() - want).max(-1)                         # [N, Lw]
    assert err[alike].max() <= 1e-6, err[alike].max()
    assert err.max() <= 5e-5, err.max()
    assert np.abs(want).max() > 0.1
    assert not got[[7, 8, 100, 301, 450]].any()          # oob: no slot


@pytest.mark.parametrize("winsort_budget", [None, 128])
def test_winsort_encode_and_grad_match_jax(winsort_budget):
    """Port (plain K5/K6 + masked residual) == JAX winsort encode (interpret;
    with budget 128 its residual overflows into the lax.cond full gather)
    == hashgrid_encode, with table gradients equal."""
    x, table, g = inputs()

    def f(tab):
        feat, cnt = jse.splat_encode_raw(
            tab, jnp.asarray(x), JS, resid_budget=1 << 15, gather_levels=WL,
            winsort_levels=WL, winsort_budget=winsort_budget, interpret=True)
        return jnp.sum(feat * jnp.asarray(g)), (feat, cnt)

    (_, (jf, jc)), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(table))
    with jax.disable_jit():
        ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table),
                                             jnp.asarray(x), JS))
    tt = T(table).requires_grad_()
    tf, tc = tse.splat_encode_raw(tt, T(x), TS, gather_levels=WL,
                                  winsort_levels=WL)
    (tf * T(g)).sum().backward()
    tf = tf.detach().numpy()
    np.testing.assert_allclose(tf, ref, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(tf, np.asarray(jf), atol=2e-6, rtol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), atol=1e-4,
                               rtol=1e-4)


def test_winsort_plain_bwd_is_autograd_of_plain_fwd():
    x, table, _ = inputs(seed=3)
    xc, perm, wins, slots, _ = port_meta(x, WL)
    gr = torch.randn((x.shape[0], len(WL), 3),
                     generator=torch.Generator().manual_seed(4))
    tt = T(table).requires_grad_()
    (tse.winsort_fwd_plain(tt, xc, perm, wins, slots, TS, WL) * gr).sum().backward()
    got = tse.winsort_bwd(gr, xc, perm, wins, slots, TS, WL, TS.table_size)
    np.testing.assert_allclose(got.numpy(), tt.grad.numpy(), atol=1e-6)
    # through the autograd Function, as splat_encode_raw calls it
    t2 = T(table).requires_grad_()
    (tse._InWinWS.apply(t2, xc, perm, wins, slots, TS, WL) * gr).sum().backward()
    np.testing.assert_allclose(t2.grad.numpy(), tt.grad.numpy(), atol=1e-6)


def test_winsort_wrappers_reject_bad_inputs():
    x, table, _ = inputs()
    xc, perm, wins, slots, _ = port_meta(x, WL)
    with pytest.raises(ValueError):
        tse.winsort_fwd(T(table), xc, perm.long(), wins, slots, TS, WL)
    with pytest.raises(ValueError):
        tse.winsort_fwd(T(table), xc[:500], perm, wins, slots, TS, WL)
    with pytest.raises(ValueError):
        tse.winsort_bwd(torch.zeros((512, 2, 3)), xc, perm, wins, slots, TS,
                        WL, TS.table_size)
    with pytest.raises(ValueError):             # fewer rows than the spec
        tse.winsort_fwd(T(table)[:-512], xc, perm, wins, slots, TS, WL)
    with pytest.raises(ValueError):
        tse.winsort_bwd(torch.zeros((512, 3, 3)), xc, perm, wins, slots, TS,
                        WL, TS.table_size - 512)
    with pytest.raises(RuntimeError):
        tse.winsort_fwd(T(table).to("meta"), xc.to("meta"), perm.to("meta"),
                        wins.to("meta"), slots.to("meta"), TS, WL)


@pytest.mark.parametrize("stochastic_fine", [False, True])
def test_trainer_winsort_trains_and_evaluates(stochastic_fine, tmp_path):
    """winsort_fine no longer raises; with the exact encode the training
    step runs K5/K6 (plain here), and train(ds, val_ds) evaluates."""
    cfg = dataclasses.replace(
        Config(path=""), bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
        num_points=4096, grid_size=32, num_levels=6, log2_hashmap_size=14,
        random_image_batch=True, background="random", mark_untrained=True,
        adaptive_num_rays=True, diffuse_step=1000, lr=0.2, n_eval=1,
        winsort_fine=True, stochastic_fine=stochastic_fine, n_ckpt=1,
        workspace=str(tmp_path)).finalize()
    frames = render_synthetic_frames(H=24, W=24, n_train=4, n_val=1, n_test=0)
    ds = dataset_from_frames(cfg, frames, "train")
    val = dataset_from_frames(cfg, frames, "val")
    t = Trainer(cfg, device="cpu")
    assert t.net_spec.encode_winsort_levels == t.net_spec.encode_gather_levels
    assert t.net_spec.encode_winsort_levels == WL
    calls = []                     # grad mode of each K5/K6 call
    real = tse._InWinWS.apply

    def counting(*a):
        calls.append(torch.is_grad_enabled())
        return real(*a)

    tse._InWinWS.apply = counting
    try:
        last = t.train(ds, val, max_steps=12)
    finally:
        tse._InWinWS.apply = real
    assert np.isfinite(float(last["loss"]))
    assert len(t.stats["results"]) == 1
    psnr = t.stats["results"][0]["PSNR"]
    assert np.isfinite(psnr) and psnr > 5.0 and t.stats["best"] == psnr
    # the grid update (8 slabs at step 0) and the eval (no grad) always take
    # the winsort kernels; the 12 training steps only with the exact encode
    assert calls.count(False) >= 8 + 1
    assert calls.count(True) == (0 if stochastic_fine else 12)
