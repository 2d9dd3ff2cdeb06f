"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and its
port.  Integer outputs must be exactly equal; float outputs are fp32 on
both sides and differ only in summation order, so their tolerances are:
encode features atol 2e-6 / rtol 1e-5, sampler ts/dts atol 1e-5, table
gradients atol 1e-5 / rtol 1e-4.  Where the JAX function reaches a Pallas
kernel it runs in interpret mode, as tests/test_splat.py and
tests/test_occ_sweep.py run it.

``hashgrid_encode`` is jitted in the JAX package, and under jit XLA's CPU
backend contracts ``x * scale + shift`` into one fused multiply-add, while
JAX op by op (and the port, and the JAX splat path) rounds the product and
the sum separately; the lattice fractions then differ by an ulp of the
position (up to 1.5e-5 at resolution 256).  The tests call it under
``jax.disable_jit()`` so that both sides round alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.ops import hashgrid as jhg
from nerf2mesh_tpu.ops import occ_sweep as jocc
from nerf2mesh_tpu.ops import sampling as jsamp
from nerf2mesh_tpu.ops import splat_encode as jse
from nerf2mesh_tpu.ops.activation import trunc_exp as jtrunc_exp
from nerf2mesh_tpu.ops.composite import composite_rays as jcomposite
from nerf2mesh_tpu_torch.ops import hashgrid as thg
from nerf2mesh_tpu_torch.ops import occ_sweep as tocc
from nerf2mesh_tpu_torch.ops import sampling as tsamp
from nerf2mesh_tpu_torch.ops import splat_encode as tse
from nerf2mesh_tpu_torch.ops.activation import trunc_exp as ttrunc_exp
from nerf2mesh_tpu_torch.ops.composite import composite_rays as tcomposite

ENC_TOL = dict(atol=2e-6, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def specs(log2=14, layout="block512", levels=6, C=3):
    kw = dict(num_levels=levels, level_dim=C, log2_hashmap_size=log2,
              desired_resolution=256, layout=layout)
    return jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)


def T(a):
    return torch.from_numpy(np.array(a))


def uniform_table(spec, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (spec.table_size, spec.level_dim)).astype(np.float32)


def mixed_points(n, seed=1, n_oob=0):
    """Half clustered (tile-local after the morton sort), half uniform."""
    rng = np.random.default_rng(seed)
    h = n // 2
    c = rng.uniform(0.2, 0.8, (8, 3))
    local = c[rng.integers(0, 8, h)] + rng.uniform(0, 0.03, (h, 3))
    pts = np.concatenate([local, rng.uniform(0, 1, (n - h, 3))])
    pts = np.clip(pts, 0, 1).astype(np.float32)
    if n_oob:
        idx = rng.choice(n, n_oob, replace=False)
        pts[idx[: n_oob // 2], 0] = 1.3
        pts[idx[n_oob // 2:], 2] = -0.2
    return pts


def sorted_points(n, seed=1):
    """Morton-sorted mixed points, n a multiple of 128 (JAX's sort)."""
    pts = mixed_points(n, seed)
    perm, _ = jse.morton_perm(jnp.asarray(pts))
    return pts[np.asarray(perm)]


# ---------------------------------------------------------------- hashgrid

@pytest.mark.parametrize("layout,log2", [("block512", 13), ("block512", 14),
                                         ("ref", 12)])
def test_corner_indices_equal(layout, log2):
    js, ts = specs(log2, layout)
    rng = np.random.default_rng(0)
    res = js.resolutions
    pg = np.stack([rng.integers(0, res[l] + 2, (300, 8, 3))
                   for l in range(js.num_levels)], axis=1)        # [N,L,8,3]
    want = np.asarray(jhg._corner_indices(jnp.asarray(pg, jnp.uint32), js))
    got = thg._corner_indices(T(pg.astype(np.int64)), ts).numpy()
    np.testing.assert_array_equal(got, want)


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 10000, dtype=np.uint64)
    for p in thg._PRIMES:
        want = (a * np.uint64(p)) & np.uint64(0xFFFFFFFF)
        got = thg.mul32(T(a.astype(np.int64)), p).numpy()
        np.testing.assert_array_equal(got.astype(np.uint64), want)


@pytest.mark.parametrize("layout", ["block512", "ref"])
def test_hashgrid_encode_parity(layout):
    js, ts = specs(13, layout)
    table = uniform_table(js)
    x = mixed_points(1000, n_oob=20)
    with jax.disable_jit():
        want = np.asarray(jhg.hashgrid_encode(jnp.asarray(table),
                                              jnp.asarray(x), js))
        want4 = np.asarray(jhg.hashgrid_encode(jnp.asarray(table),
                                               jnp.asarray(x), js,
                                               jnp.int32(4)))
    got = thg.hashgrid_encode(T(table), T(x), ts).numpy()
    np.testing.assert_allclose(got, want, **ENC_TOL)
    got4 = thg.hashgrid_encode(T(table), T(x), ts, 4).numpy()
    np.testing.assert_allclose(got4, want4, **ENC_TOL)


def test_block512_below_2_9_rows_is_refused(tmp_path):
    """A hashed block512 level holds whole 512-row windows: a spec of fewer
    rows a level is refused where it is built, through the Trainer too
    (JAX's encode turns the parameters to NaN there)."""
    import dataclasses
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    with pytest.raises(ValueError, match=r"2\^9 rows .*log2_hashmap_size >= 9"):
        thg.HashGridSpec(num_levels=4, level_dim=3, log2_hashmap_size=8,
                         layout="block512")
    cfg = dataclasses.replace(Config(), bound=1.0, grid_size=16, num_levels=4,
                              log2_hashmap_size=8, grid_layout="block512",
                              workspace=str(tmp_path / "ws")).finalize()
    with pytest.raises(ValueError, match=r"log2_hashmap_size >= 9"):
        Trainer(cfg, device="cpu")
    # the other layouts keep their small tables
    thg.HashGridSpec(num_levels=4, level_dim=3, log2_hashmap_size=8)
    thg.HashGridSpec(num_levels=4, level_dim=3, log2_hashmap_size=8,
                     layout="block512", gridtype="tiled")


def test_block512_at_2_9_rows_encodes():
    """2^9 rows a level, one window a hashed level: the spec builds and the
    encode agrees with JAX's."""
    js, ts = specs(9, "block512")
    assert ts.use_hash.any() and (ts.level_sizes[ts.use_hash] == 512).all()
    table = uniform_table(js)
    x = mixed_points(500, n_oob=10)
    with jax.disable_jit():
        want = np.asarray(jhg.hashgrid_encode(jnp.asarray(table),
                                              jnp.asarray(x), js))
    got = thg.hashgrid_encode(T(table), T(x), ts).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **ENC_TOL)


def test_tv_loss_parity():
    js, ts = specs(13)
    table = uniform_table(js)
    x = mixed_points(512, n_oob=10)
    pw = np.random.default_rng(3).uniform(0, 10, 512).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda t: jhg.hashgrid_tv_loss(
        t, jnp.asarray(x), js, jnp.asarray(pw)))(jnp.asarray(table))
    tt = T(table).requires_grad_()
    tl = thg.hashgrid_tv_loss(tt, T(x), ts, T(pw))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), **GRAD_TOL)


def test_trunc_exp_parity():
    x = np.linspace(-20, 20, 41).astype(np.float32)
    jv, jg = jax.vjp(jtrunc_exp, jnp.asarray(x))
    xt = T(x).requires_grad_()
    tv = ttrunc_exp(xt)
    tv.backward(torch.ones_like(tv))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg(jnp.ones(41))[0]),
                               rtol=1e-6)


# ---------------------------------------------------------------- occupancy

def test_pack_bits_and_lookup_equal():
    rng = np.random.default_rng(0)
    occ = (rng.random((1, 32, 32, 32)) < 0.3).astype(np.uint8)
    jw = np.asarray(jocc.pack_bits(jnp.asarray(occ))).reshape(-1)
    tw = tocc.pack_bits(T(occ))
    np.testing.assert_array_equal(tw.numpy(), jw)
    idx = rng.integers(0, 32 ** 3, 4000).astype(np.int32)
    want = np.asarray(jocc.occ_lookup_sweep(jnp.asarray(jw.reshape(-1, 128)),
                                            jnp.asarray(idx), interpret=True))
    got = tocc.occ_lookup(tw, T(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), occ.reshape(-1)[idx])


def test_occ_lookup_checks_inputs():
    with pytest.raises(TypeError):
        tocc.occ_lookup(torch.zeros(4, dtype=torch.int64),
                        torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("cascades,contracted", [(1, False), (2, True)])
def test_occupancy_lookup_equal(cascades, contracted):
    rng = np.random.default_rng(1)
    H = 32
    occ = (rng.random((cascades, H, H, H)) < 0.4).astype(np.uint8)
    bound = 2.0 if contracted else 1.0
    xyz = rng.uniform(-bound * 1.5, bound * 1.5, (2000, 3)).astype(np.float32)
    dts = rng.uniform(1e-3, 0.2, 2000).astype(np.float32)
    jo, jc = jsamp.occupancy_lookup(jnp.asarray(occ), jnp.asarray(xyz),
                                    jnp.asarray(dts), bound, contracted,
                                    cascades, H)
    to, tc = tsamp.occupancy_lookup(T(occ), T(xyz), T(dts), bound,
                                    contracted, cascades, H)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


# ---------------------------------------------------------------- sampler

def _sphere_grid(H=32):
    ax = (np.arange(H) + 0.5) / H * 2 - 1
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    return (np.linalg.norm(g, axis=-1) < 0.6).astype(np.uint8)[None]


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    tgt = rng.uniform(-0.5, 0.5, (n, 3))
    d = tgt - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("dt_gamma", [0.0, 1.0 / 256])
def test_sample_rays_parity(dt_gamma):
    H, N, Kc, Kf = 32, 256, 128, 32
    occ = _sphere_grid(H)
    o, d = _rays(N)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jn, jf = jsamp.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(aabb), 0.05)
    tn, tf = tsamp.near_far_from_aabb(T(o), T(d), T(aabb), 0.05)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    key = jax.random.PRNGKey(7)
    kw = dict(num_coarse=Kc, num_fine=Kf, grid_size=H, cascades=1, bound=1.0,
              contracted=False, dt_gamma=dt_gamma, max_steps=1024)
    jm = jsamp.sample_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ),
                           jn, jf, perturb=True, noise_key=key, **kw)
    u = np.asarray(jax.random.uniform(key, (N, Kf)))    # JAX's own draw
    tm = tsamp.sample_rays(T(o), T(d), T(occ), T(np.asarray(jn)),
                           T(np.asarray(jf)), u=T(u), **kw)
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    assert int(tm.total) == int(jm.total) > 0
    np.testing.assert_allclose(tm.ts.numpy(), np.asarray(jm.ts), atol=1e-5)
    np.testing.assert_allclose(tm.dts.numpy(), np.asarray(jm.dts), atol=1e-5)
    np.testing.assert_allclose(tm.xyzs.numpy(), np.asarray(jm.xyzs), atol=1e-5)


def test_searchsorted_pick_matches_onehot_edges():
    """s == 0 and zero-length segments: no pick, as the JAX one-hot."""
    o = np.array([[0.0, 0, 2.0]] * 2, np.float32)
    d = np.array([[0.0, 0, -1.0]] * 2, np.float32)
    occ = np.zeros((1, 16, 16, 16), np.uint8)
    occ[0, :, :, 4:6] = 1
    occ[0, :, :, 10:11] = 1
    u = np.zeros((2, 8), np.float32)           # s = 0 for sample 0
    jn, jf = jsamp.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray([-1.0, -1, -1, 1, 1, 1]), 0.05)
    kw = dict(num_coarse=64, num_fine=8, grid_size=16, cascades=1, bound=1.0)
    jm = jsamp.sample_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ),
                           jn, jf, perturb=True, noise_key=None, **kw)
    # the JAX sampler without a key places at u = 0.5; feed both u = 0.5
    tm = tsamp.sample_rays(T(o), T(d), T(occ), T(np.asarray(jn)),
                           T(np.asarray(jf)), u=None, **kw)
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    tz = tsamp.sample_rays(T(o), T(d), T(occ), T(np.asarray(jn)),
                           T(np.asarray(jf)), u=T(u), **kw)
    assert not bool(tz.valid[:, 0].any())      # s == 0 picks no segment


def test_composite_parity():
    rng = np.random.default_rng(0)
    N, K = 64, 32
    sig = rng.exponential(5.0, (N, K)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, K, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(1, 3, (N, K)), axis=1).astype(np.float32)
    dts = rng.uniform(0.01, 0.1, (N, K)).astype(np.float32)
    valid = rng.random((N, K)) < 0.8
    jo = jcomposite(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(ts),
                    jnp.asarray(dts), jnp.asarray(valid))
    to = tcomposite(T(sig), T(rgb), T(ts), T(dts), T(valid))
    for k in ("weights", "weights_sum", "depth", "image"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=1e-5)


# ---------------------------------------------------------------- splat encode

def test_morton_perm_equal():
    x = mixed_points(1000, n_oob=30)
    x[500:540] = x[0]                     # ties: stable order must match
    jp, ji = jse.morton_perm(jnp.asarray(x))
    tp, ti = tse.morton_perm(T(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("log2", [13, 14])
def test_tile_meta_equal(log2):
    js, ts = specs(log2)
    x = sorted_points(1024).reshape(8, 128, 3)
    for l in range(js.num_levels):
        jb, jr = jse.tile_meta(jnp.asarray(x), js, l)
        tb, tr = tse.tile_meta(T(x), ts, l)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_corner_geometry_equal():
    js, ts = specs(14)
    x = sorted_points(1024)
    tiles = x.reshape(8, 128, 3)
    jb = jnp.stack([jse.tile_meta(jnp.asarray(tiles), js, l)[0]
                    for l in range(js.num_levels)])
    ji, jw, jr = jse._corner_geometry(jnp.asarray(x), js, jb)
    ti, tw, tr = tse._corner_geometry(T(x), ts, T(np.asarray(jb)))
    np.testing.assert_array_equal(ti.reshape(1024, -1).numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.reshape(1024, -1).numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tr.reshape(1024, -1).numpy(), np.asarray(jr))


def _kernel_inputs(js, ts, x, levels):
    tiles = x.reshape(-1, 128, 3)
    metas = [tse.tile_meta(T(tiles), ts, l) for l in levels]
    return (torch.stack([m[0] for m in metas]).contiguous(),
            torch.stack([m[1] for m in metas]).contiguous())


def test_inwin_plain_vs_windowed_reference():
    """K2's plain version == the JAX in-window oracle, all levels."""
    js, ts = specs(14)
    table = uniform_table(js)
    x = sorted_points(1024)
    levels = tuple(range(js.num_levels))
    bases, rows = _kernel_inputs(js, ts, x, levels)
    got = tse.inwin_fwd(T(table), T(x), bases, rows, ts, levels)  # CPU: plain
    want = np.asarray(jse.windowed_reference(
        jnp.asarray(table), jnp.asarray(x.reshape(-1, 128, 3)), js))
    np.testing.assert_allclose(got.numpy(), want.reshape(1024, -1, 3), **ENC_TOL)


def _same_window_tile(js, l, rng):
    """128 points in one 2x2x2 block neighbourhood with a repeated window."""
    slots = np.array([[s & 1, (s >> 1) & 1, (s >> 2) & 1] for s in range(8)])
    nb = int(js.block_counts[l])
    for b0 in np.ndindex(nb - 1, nb - 1, nb - 1):
        b = np.array(b0)
        _, rows = jse.tile_meta(jnp.asarray(((8 * b + 0.25 - 0.5)
                                             / js.level_scale(l))
                                            .astype(np.float32))[None, None],
                                js, l)
        if len(set(np.asarray(rows)[0].tolist())) < 8:
            cells = 8 * b[None] + rng.uniform(0, 15, (128, 3))
            cells[0] = 8 * b + 0.25
            return np.clip((cells - 0.5) / js.level_scale(l), 0, 1).astype(np.float32)
    raise AssertionError("no same-window neighbourhood")


def test_inwin_grad_vs_pallas_with_same_window_slots():
    """K3's plain version == the Pallas backward (interpret), on tiles that
    include two slots sharing one window id."""
    js, ts = specs(14)
    rng = np.random.default_rng(4)
    table = uniform_table(js)
    l_coll = 3
    x = np.concatenate([sorted_points(128), _same_window_tile(js, l_coll, rng)])
    levels = (0, l_coll)
    bases, rows = _kernel_inputs(js, ts, x, levels)
    assert len(set(rows[1, -1].tolist())) < 8
    N = x.shape[0]
    g = rng.normal(size=(N, len(levels), 3)).astype(np.float32)

    # JAX: the Pallas in-window op (interpret) in its kernel layout
    x_t = np.pad(x.reshape(-1, 128, 3).transpose(0, 2, 1),
                 ((0, 0), (0, 5), (0, 0))).reshape(-1, 128)
    g_t = np.zeros((len(levels), N // 128, 8, 128), np.float32)
    g_t[:, :, :3] = g.reshape(N // 128, 128, len(levels), 3).transpose(2, 0, 3, 1)

    def f(tab):
        out = jse._inwin(jse.to_splat(tab, js), jnp.asarray(x_t),
                         jnp.asarray(bases.numpy()), jnp.asarray(rows.numpy()),
                         js, levels, True)
        return jnp.sum(out * jnp.asarray(g_t.reshape(len(levels), -1, 128))), out

    (_, jout), jgrad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(table))
    tt = T(table).requires_grad_()
    out = tse._InWin.apply(tt, T(x), bases, rows, ts, levels)
    (out * T(g)).sum().backward()
    jout = np.asarray(jout).reshape(len(levels), -1, 8, 128)[:, :, :3]
    np.testing.assert_allclose(
        out.detach().numpy(),
        jout.transpose(1, 3, 0, 2).reshape(N, len(levels), 3), **ENC_TOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), **GRAD_TOL)
    # and the plain backward equals autograd of the plain forward
    t2 = T(table).requires_grad_()
    (tse.inwin_fwd_plain(t2, T(x), bases, rows, ts, levels) * T(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), t2.grad.numpy(), **GRAD_TOL)


def _encode_points():
    """512 morton-sorted points, a few out of bounds (shared by the two
    splat parity tests so the eager JAX side reuses its compiled ops)."""
    x = sorted_points(512)
    x[[5, 300]] = [1.4, 0.5, 0.5]
    x[[77, 450]] = [0.5, -0.1, 0.5]
    return x


def test_splat_encode_exact_parity():
    """Port (K2 plain + masked residual, with gather levels) == JAX splat
    encode (Pallas interpret) == hashgrid_encode; residual counts equal."""
    js, ts = specs(14)
    table = uniform_table(js)
    x = _encode_points()
    gl = (2, 3, 4, 5)             # Pallas levels 0 (dense) and 1 (hashed)
    jf, jc = jse.splat_encode_raw(jnp.asarray(table), jnp.asarray(x), js,
                                  resid_budget=1 << 15, gather_levels=gl,
                                  interpret=True)
    g = np.random.default_rng(6).normal(size=(512, js.output_dim)).astype(np.float32)
    tt = T(table).requires_grad_()
    tf, tc = tse.splat_encode_raw(tt, T(x), ts, gather_levels=gl)
    (tf * T(g)).sum().backward()
    tf = tf.detach()
    with jax.disable_jit():
        ref, vjp = jax.vjp(lambda t: jhg.hashgrid_encode(t, jnp.asarray(x), js),
                           jnp.asarray(table))
        jg = vjp(jnp.asarray(g))[0]
    ref = np.asarray(ref)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **ENC_TOL)
    np.testing.assert_allclose(tf.numpy(), ref, **ENC_TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), **GRAD_TOL)
    # the public op pads, sorts and unsorts around it
    perm = np.random.default_rng(9).permutation(500)
    tf2, _ = tse.splat_encode(T(table), T(x[perm]), ts, gather_levels=gl)
    np.testing.assert_allclose(tf2.numpy(), ref[perm], **ENC_TOL)


def test_splat_encode_stochastic_parity():
    """1-corner picks from the position hash: same picks, same values and
    table gradients as JAX on bit-identical (morton-sorted) inputs."""
    js, ts = specs(14)
    table = uniform_table(js)
    x = _encode_points()
    gl = (2, 3, 4, 5)
    g = np.random.default_rng(5).normal(size=(512, js.output_dim)).astype(np.float32)

    def f(tab):
        feat, cnt = jse.splat_encode_raw(tab, jnp.asarray(x), js,
                                         gather_levels=gl, stochastic=True,
                                         interpret=True)
        return jnp.sum(feat * jnp.asarray(g)), (feat, cnt)

    (_, (jf, jc)), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(table))
    assert np.abs(np.asarray(jf)[[5, 77, 300, 450]]).max() == 0
    tt = T(table).requires_grad_()
    tf, tc = tse.splat_encode_raw(tt, T(x), ts, gather_levels=gl,
                                  stochastic=True)
    (tf * T(g)).sum().backward()
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), atol=2e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), **GRAD_TOL)


def test_inwin_rejects_bad_shapes():
    js, ts = specs(13)
    x = torch.zeros((100, 3))
    with pytest.raises(ValueError):
        tse.inwin_fwd(torch.zeros((ts.table_size, 3)), x,
                      torch.zeros((1, 1, 3), dtype=torch.int32),
                      torch.zeros((1, 1, 8), dtype=torch.int32), ts, (0,))
