"""The port's small-table ref encode (ops/pallas_encode.py: K4's plain
version and the sweep backward) against the JAX package, on the CPU.

K4's plain version is held to the Pallas kernel itself, run in interpret
mode (``_fwd_pallas`` has no ``interpret`` argument, so the test patches
``pl.pallas_call``), at atol 1e-5: XLA compiles the interpret kernel's
``x * scale + shift`` into a fused multiply-add, so a lattice fraction can
differ by an ulp of the position (~3e-6 on features of magnitude ~1).  It is
held to JAX ``hashgrid_encode`` run op by op (``jax.disable_jit()``), where
both round the product and the sum separately, at atol 1e-6.  The backward
is held to JAX ``_sweep_bwd`` at rtol 1e-4, atol 1e-4, as
tests/test_pallas_encode.py holds JAX's own.
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
    included, to sweep_encode, never to the plain hashgrid_encode; a
    level_dim that K4 (or, on a block512 table, K2-K6) cannot read raises
    there instead of routing around it."""
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
    t1 = thg.HashGridSpec(num_levels=6, level_dim=1, log2_hashmap_size=12,
                          desired_resolution=128, layout="ref")
    with pytest.raises(ValueError, match="level_dim"):
        tnet._encode(T(uniform_table(t1)), x, t1, None, nspec)
    b1 = dataclasses.replace(t1, layout="block512")
    with pytest.raises(ValueError, match="level_dim"):
        tnet._encode(T(uniform_table(b1)), x[:128], b1, None, nspec)


def test_kernel_indices_equal_corner_indices():
    """K4's index formula (dense: ix + iy*side + iz*side^2, whose modulo by
    the size is never taken on a hash grid; hashed: uint32 xor-of-primes &
    (size-1)) equals _corner_indices' (which keeps % size), at the slice's
    spec (levels 0-1 dense, 2-15 hashed)."""
    _, ts = specs(log2=14, levels=16, res=2048)
    assert list(ts.use_hash) == [False, False] + [True] * 14
    assert [int(v) for v in ts.level_sizes[:3]] == [4920, 13824, 16384]
    assert ts.table_size == 248120
    rec = tpe._level_records(ts, torch.device("cpu")).numpy()   # K4's input
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
