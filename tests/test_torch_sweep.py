"""The port's small-table ref encode (ops/pallas_encode.py: K4's plain
version and the sweep backward) against the JAX package, on the CPU.

K4's plain version is held to the Pallas kernel itself, run in interpret
mode (``_fwd_pallas`` has no ``interpret`` argument, so the test patches
``pl.pallas_call``), at atol 1e-5: XLA compiles the interpret kernel's
``x * scale + shift`` into a fused multiply-add, so a lattice fraction can
differ by an ulp of the position (~3e-6 on features of magnitude ~1).  It is
held to JAX ``hashgrid_encode`` run op by op (``jax.disable_jit()``), where
both round the product and the sum separately, at atol 1e-6.  The backward
(K4b's plain version, and the input gradient) is held to JAX ``_sweep_bwd``
at rtol 1e-4, atol 1e-4, as tests/test_pallas_encode.py holds JAX's own.
The kernels' launch shapes (``sweep_chunks``) are checked by a numpy model
of their grids: every (point, level) once, and K4b's per-block slices
flushed into the plain gradient.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.ops import hashgrid as jhg
from nerf2mesh_tpu.ops import pallas_encode as jpe
from nerf2mesh_tpu_torch.ops import hashgrid as thg
from nerf2mesh_tpu_torch.ops import pallas_encode as tpe


def specs(log2=12, levels=6, res=128, C=3):
    kw = dict(num_levels=levels, level_dim=C, log2_hashmap_size=log2,
              desired_resolution=res, layout="ref")
    return jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)


def T(a):
    return torch.from_numpy(np.array(a))


def edge_points(spec, n, seed=0):
    """Uniform points plus, per level, points whose lattice position
    x*scale+shift is an integer or 1 ulp from one; coordinates exactly 0 and
    1; and points just and far outside [0, 1]^3.  Just below 0 is the least
    normal float, not the 1-ulp denormal: XLA's CPU backend flushes
    denormals to zero, where PyTorch's CPU and the card keep them."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(0, 1, (n, 3))]
    for l in range(spec.num_levels):
        s = np.float32(spec.level_scale(l))
        p = rng.uniform(0, 1, (8, 3))
        g = rng.integers(1, int(s), 8)
        x = ((g - np.float32(0.5)) / s).astype(np.float32)
        x[2:5] = np.nextafter(x[2:5], np.float32(2))
        x[5:] = np.nextafter(x[5:], np.float32(-1))
        p[np.arange(8), rng.integers(0, 3, 8)] = x
        pts.append(p)
    special = rng.uniform(0, 1, (10, 3))
    special[0, 0], special[1, 1], special[2] = 0.0, 1.0, (1.0, 0.0, 1.0)
    special[3, 0] = -np.finfo(np.float32).tiny
    special[4, 2] = np.nextafter(np.float32(1), np.float32(2))
    special[5, 1], special[6, 0], special[7] = 1.5, -0.2, 2.0
    pts.append(special)
    return np.concatenate(pts).astype(np.float32)


def uniform_table(spec, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.uniform(-1, 1, (spec.table_size, spec.level_dim))
            ).astype(np.float32)


def test_sweep_supported_gate():
    """The gate is JAX's (3-D, linear, at most 2^14 rows) on a ref table:
    level count and level_dim do not enter it."""
    _, ts = specs()
    assert tpe.sweep_supported(ts)
    assert tpe.sweep_supported(specs(log2=14, levels=16, res=2048)[1])
    base = dict(num_levels=6, level_dim=3, log2_hashmap_size=12,
                desired_resolution=128, layout="ref")
    for kw in (dict(log2_hashmap_size=15), dict(layout="block512"),
               dict(interpolation="smoothstep"), dict(input_dim=2),
               dict(level_dim=1), dict(num_levels=40), {}):
        spec = {**base, **kw}
        want = (jpe.sweep_supported(jhg.HashGridSpec(**spec))
                and spec["layout"] == "ref")
        assert tpe.sweep_supported(thg.HashGridSpec(**spec)) == want, kw
    assert tpe.sweep_supported(thg.HashGridSpec(**{**base, "num_levels": 40}))


def test_ref_encode_routes_every_sweep_spec_to_sweep_encode(monkeypatch):
    """network._encode sends every spec the gate accepts, 40 levels
    included, at 1, 2 and 3 channels, to sweep_encode, never to the plain
    hashgrid_encode; a level_dim that K4 (or, on a block512 table, K2-K6)
    has no instantiation for raises there instead of routing around it."""
    from nerf2mesh_tpu_torch.models import network as tnet
    calls = []

    def spy(table, x01, spec):
        calls.append(spec.num_levels)
        return tpe.sweep_encode(table, x01, spec)

    def plain(*a, **k):
        raise AssertionError("routed to the plain hashgrid_encode")

    monkeypatch.setattr(tnet, "sweep_encode", spy)
    monkeypatch.setattr(tnet, "hashgrid_encode", plain)
    nspec = tnet.NetworkSpec(grid_layout="ref", log2_hashmap_size=12)
    ts = thg.HashGridSpec(num_levels=40, level_dim=3, log2_hashmap_size=12,
                          desired_resolution=512, layout="ref")
    table, x = T(uniform_table(ts)), T(edge_points(ts, 64))
    h, cnt = tnet._encode(table, x, ts, None, nspec)
    assert calls == [40] and cnt is None and h.shape == (x.shape[0], 120)
    torch.testing.assert_close(h, thg.hashgrid_encode(table, x, ts),
                               atol=1e-6, rtol=0)
    # the separate tables' channel counts route to the same kernels; a
    # level_dim that no instantiation covers raises on either layout
    for C in (1, 2):
        tc = dataclasses.replace(ts, level_dim=C)
        calls.clear()
        h, _ = tnet._encode(T(uniform_table(tc)), x, tc, None, nspec)
        assert calls == [40] and h.shape == (x.shape[0], 40 * C)
    t4 = thg.HashGridSpec(num_levels=6, level_dim=4, log2_hashmap_size=12,
                          desired_resolution=128, layout="ref")
    with pytest.raises(ValueError, match="level_dim"):
        tnet._encode(T(uniform_table(t4)), x, t4, None, nspec)
    b4 = dataclasses.replace(t4, layout="block512")
    with pytest.raises(ValueError, match="level_dim"):
        tnet._encode(T(uniform_table(b4)), x[:128], b4, None, nspec)


def test_kernel_indices_equal_corner_indices():
    """K4's index formula (dense: ix + iy*side + iz*side^2, whose modulo by
    the size is never taken on a hash grid; hashed: uint32 xor-of-primes &
    (size-1)) equals _corner_indices' (which keeps % size), at the slice's
    spec (levels 0-1 dense, 2-15 hashed)."""
    _, ts = specs(log2=14, levels=16, res=2048)
    assert list(ts.use_hash) == [False, False] + [True] * 14
    assert [int(v) for v in ts.level_sizes[:3]] == [4920, 13824, 16384]
    assert ts.table_size == 248120
    rec = tpe._level_records(ts)                        # K4's and K4b's input
    np.testing.assert_array_equal(
        rec[:, 0].view(np.float32), [ts.level_scale32(l) for l in range(16)])
    np.testing.assert_array_equal(rec[:, 1], ts.offsets[:-1])
    np.testing.assert_array_equal(rec[:, 3], ts.level_sizes)
    x = edge_points(ts, 2000)
    x = x[((x >= 0) & (x <= 1)).all(1)]
    for l in range(16):
        pg, _ = thg.lattice(T(x), ts, l)
        cg = pg.long()[:, None, :] + thg.corner_bits()          # [N, 8, 3]
        want = thg._corner_indices(cg[:, None], ts, [l])[:, 0].numpy()
        c = cg.numpy().astype(np.uint32)
        size = np.uint32(ts.level_sizes[l])
        assert (rec[l, 2] == 0) == bool(ts.use_hash[l])
        if ts.use_hash[l]:
            idx = ((c[..., 0] * np.uint32(1)) ^ (c[..., 1] * np.uint32(2654435761))
                   ^ (c[..., 2] * np.uint32(805459861))) & (size - np.uint32(1))
        else:
            side = np.uint32(rec[l, 2])
            assert side == ts.resolutions[l] + 1
            idx = c[..., 0] + c[..., 1] * side + c[..., 2] * side * side
            assert int(idx.max()) < int(size)
        np.testing.assert_array_equal(idx.astype(np.int64) + ts.offsets[l],
                                      want, err_msg=f"level {l}")


def test_sweep_plain_matches_pallas_interpret(monkeypatch):
    js, ts = specs()
    table = uniform_table(js)
    x = edge_points(js, 180)
    x = x[:x.shape[0] // 128 * 128]
    monkeypatch.setattr(jpe.pl, "pallas_call",
                        functools.partial(jpe.pl.pallas_call, interpret=True))
    want = np.asarray(jpe._fwd_pallas(jpe.pad_table(jnp.asarray(table), js),
                                      jnp.asarray(x), js))
    got = tpe.sweep_fwd_plain(T(table), T(x), ts).numpy()
    assert got.shape == want.shape == (x.shape[0], 18)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(want).max() > 0.5


@pytest.mark.parametrize("log2,res", [(12, 128), (14, 2048)])
def test_sweep_encode_matches_jax_hashgrid(log2, res):
    js, ts = specs(log2=log2, res=res)
    table = uniform_table(js)
    x = edge_points(js, 700)
    with jax.disable_jit():
        want = np.asarray(jhg.hashgrid_encode(jnp.asarray(table),
                                              jnp.asarray(x), js))
    got = tpe.sweep_encode(T(table), T(x), ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    oob = ((x < 0) | (x > 1)).any(1)
    assert oob.sum() == 5 and not got[oob].any()
    torch.testing.assert_close(tpe.sweep_fwd(T(table), T(x), ts),
                               tpe.sweep_fwd_plain(T(table), T(x), ts),
                               atol=0, rtol=0)


def test_sweep_backward_matches_jax(rng):
    js, ts = specs()
    table = uniform_table(js, scale=100.0)
    x = edge_points(js, 120, seed=3)
    g = rng.normal(size=(x.shape[0], js.output_dim)).astype(np.float32)
    dt_want, dx_want = jpe._sweep_bwd(js, (jnp.asarray(table), jnp.asarray(x)),
                                      jnp.asarray(g))
    tt = T(table).requires_grad_()
    tx = T(x).requires_grad_()
    tpe.sweep_encode(tt, tx, ts).backward(T(g))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(dt_want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_want),
                               rtol=1e-4, atol=1e-4)
    # the input gradient is computed only when x01 needs it
    dt, dx = tpe.sweep_bwd(T(table), T(x), T(g), ts, need_dx=False)
    assert dx is None and torch.equal(dt, tt.grad)


def test_sweep_wrapper_rejects_bad_inputs():
    _, ts = specs()
    table = T(uniform_table(ts))
    x = torch.rand(16, 3)
    with pytest.raises(ValueError):
        tpe.sweep_fwd(table[:-8], x, ts)
    with pytest.raises(ValueError):
        tpe.sweep_fwd(table, x.double(), ts)
    with pytest.raises(ValueError):
        tpe.sweep_fwd(table, x, specs(log2=15)[1])
    with pytest.raises(RuntimeError):
        tpe.sweep_fwd(table.to("meta"), x.to("meta"), ts)


@pytest.mark.parametrize("log2,levels,res", [(12, 6, 128), (14, 16, 2048)])
def test_sweep_bwd_plain_matches_jax(rng, log2, levels, res):
    """K4b's plain version (and the input gradient beside it) against JAX
    ``_sweep_bwd``, at the small spec and at the ref slice's."""
    js, ts = specs(log2=log2, levels=levels, res=res)
    table = uniform_table(js, scale=100.0)
    x = edge_points(js, 150, seed=5)
    g = rng.normal(size=(x.shape[0], js.output_dim)).astype(np.float32)
    dt_want, dx_want = jpe._sweep_bwd(js, (jnp.asarray(table), jnp.asarray(x)),
                                      jnp.asarray(g))
    dt, dx = tpe.sweep_bwd_plain(T(table), T(x), T(g), ts)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dt_want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_want), rtol=1e-4,
                               atol=1e-4)
    dt2, none = tpe.sweep_bwd_plain(T(table), T(x), T(g), ts, need_dx=False)
    assert none is None and torch.equal(dt2, dt)


def test_sweep_bwd_cpu_dispatch(rng, monkeypatch):
    """On CPU tensors sweep_bwd is its plain version, and _Sweep.backward
    goes through sweep_bwd with need_dx only when x01 needs a gradient."""
    _, ts = specs()
    table, x = T(uniform_table(ts)), T(edge_points(ts, 100, seed=6))
    g = T(rng.normal(size=(x.shape[0], ts.output_dim)).astype(np.float32))
    for need_dx in (True, False):
        got, want = (tpe.sweep_bwd(table, x, g, ts, need_dx),
                     tpe.sweep_bwd_plain(table, x, g, ts, need_dx))
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None) == (not need_dx)
        if need_dx:
            assert torch.equal(got[1], want[1])
    calls = []
    real = tpe.sweep_bwd

    def spy(table, x01, g, spec, need_dx=True):
        calls.append(need_dx)
        return real(table, x01, g, spec, need_dx)

    monkeypatch.setattr(tpe, "sweep_bwd", spy)
    for x_grad in (False, True):
        tt = table.clone().requires_grad_()
        tx = x.clone().requires_grad_(x_grad)
        tpe.sweep_encode(tt, tx, ts).backward(g)
        assert torch.equal(tt.grad, tpe.sweep_bwd_plain(table, x, g, ts)[0])
    assert calls == [False, True]


def test_sweep_bwd_rejects_bad_inputs():
    _, ts = specs()
    table, x = T(uniform_table(ts)), torch.rand(16, 3)
    g = torch.rand(16, ts.output_dim)
    for bad in (g.double(), g[:8], g[:, :-3], torch.rand(16, ts.output_dim + 3)):
        with pytest.raises(ValueError, match="g must be"):
            tpe.sweep_bwd(table, x, bad, ts)
    with pytest.raises(ValueError, match="different devices"):
        tpe.sweep_bwd(table, x, g.to("meta"), ts)
    with pytest.raises(ValueError):
        tpe.sweep_bwd(table, x.double(), g, ts)
    with pytest.raises(RuntimeError, match="no kernel"):
        tpe.sweep_bwd(table.to("meta"), x.to("meta"), g.to("meta"), ts)


@pytest.mark.parametrize("kw", [dict(log2_hashmap_size=14, num_levels=16),
                                dict(log2_hashmap_size=14, num_levels=40),
                                dict(log2_hashmap_size=14, num_levels=70),
                                dict(log2_hashmap_size=12, num_levels=6,
                                     gridtype="tiled")])
def test_level_records_fit_the_launcher(kw):
    """The host records are the C launcher's array of 16-byte level structs,
    and every level's offset and size is a multiple of 4 rows (its slice is
    whole 16-byte chunks) holding at most 16384 rows (192 KiB of shared
    memory)."""
    spec = thg.HashGridSpec(level_dim=3, desired_resolution=2048, layout="ref",
                            **kw)
    rec = tpe._level_records(spec)
    assert rec.dtype == np.int32 and rec.shape == (spec.num_levels, 4)
    assert rec.flags["C_CONTIGUOUS"] and rec.strides == (16, 4)
    assert not (rec[:, 1] % 4).any() and not (rec[:, 3] % 4).any()
    assert rec[:, 3].max() * 12 <= 196608


def _grid(n_points, chunks):
    """The chunks of the kernels' grid: [start, stop) of each."""
    size = -(-n_points // chunks)
    return [(c * size, min(n_points, (c + 1) * size))
            for c in range(-(-n_points // size))]


@pytest.mark.parametrize("n,levels", [(2 ** 18, 16), (2 ** 14 + 37, 16),
                                      (4096, 16), (3000, 40), (100, 6),
                                      (5000, 1)])
def test_sweep_launch_partition(n, levels):
    """The launch shapes of sweep_chunks on a 132-SM card: a large input
    takes one wave of blocks, a small one chunks of at least
    CHUNK_MIN_POINTS points; K4b's blocks (a level of a chunk, threads
    striding by 1024) visit every (point, level) once, and K4's clusters (a
    pair of levels of a chunk, 1024-point tiles whose halves two owners
    write) write every output element once."""
    sms, threads = 132, 1024
    for forward in (False, True):
        chunks = tpe.sweep_chunks(n, levels, sms, forward)
        per = 2 * -(-levels // 2) if forward else levels
        assert chunks >= 1 and (chunks * per <= sms or chunks == 1)
        if chunks > 1:
            assert -(-n // chunks) >= tpe.CHUNK_MIN_POINTS // 2
        seen = np.zeros((n, levels * 3 if forward else levels), np.int32)
        for p0, p1 in _grid(n, chunks):
            if not forward:
                for l in range(levels):
                    for t in range(threads):
                        seen[p0 + t:p1:threads, l] += 1
                continue
            for h in range(-(-levels // 2)):
                width = 3 * min(2, levels - 2 * h)
                for t0 in range(p0, p1, threads):
                    for owner in (0, 1):
                        q0 = t0 + owner * threads // 2
                        q1 = min(q0 + threads // 2, p1)
                        seen[q0:q1, 6 * h:6 * h + width] += 1
        assert (seen == 1).all()


def test_sweep_bwd_schedule_model(rng):
    """A numpy model of K4b's schedule on the slice's spec: each block
    zeroes its level's slice, adds its chunk's corners there and adds the
    slice into the gradient once, skipping 16-byte chunks that stayed
    zero; the sum equals sweep_bwd_plain (atol 1e-5 + rtol 1e-4 of each
    entry's summed |terms|, the kernel's rule)."""
    _, ts = specs(log2=14, levels=16, res=2048)
    x = edge_points(ts, 3000, seed=8)
    n, L = x.shape[0], ts.num_levels
    g = rng.normal(size=(n, L * 3)).astype(np.float32)
    g[rng.random(n) < 0.2] = 0.0              # points that add nothing
    idx, _, w, _ = tpe._sweep_corners(T(x), ts)
    idx, w = idx.numpy(), w.numpy()           # [N, L, 8] table rows, weights
    offs, sizes = ts.offsets, ts.level_sizes
    dtable = np.zeros((ts.table_size, 3), np.float32)
    chunks = tpe.sweep_chunks(n, L, 132, forward=False)
    assert chunks > 1
    flushed = 0
    for p0, p1 in _grid(n, chunks):
        for l in range(L):
            acc = np.zeros((int(sizes[l]), 3), np.float32)
            rows = idx[p0:p1, l] - offs[l]    # level-local rows
            assert rows.min() >= 0 and rows.max() < sizes[l]
            terms = w[p0:p1, l, :, None] * g[p0:p1, None, 3 * l:3 * l + 3]
            np.add.at(acc, rows.reshape(-1), terms.reshape(-1, 3))
            flat, live = acc.reshape(-1, 4), acc.reshape(-1, 4).any(1)
            dst = dtable[offs[l]:offs[l] + sizes[l]].reshape(-1, 4)
            dst[live] += flat[live]
            flushed += int(live.sum())
    want = tpe.sweep_bwd_plain(T(np.zeros((ts.table_size, 3), np.float32)),
                               T(x), T(g), ts, need_dx=False)[0].numpy()
    mag = tpe.sweep_bwd_plain(T(np.zeros((ts.table_size, 3), np.float32)),
                              T(x), T(np.abs(g)), ts, need_dx=False)[0].numpy()
    assert (np.abs(dtable - want) <= 1e-5 + 1e-4 * mag).all()
    assert 0 < flushed < chunks * ts.table_size * 3 // 4
