"""The encode kernels' plain versions at the separate tables' channel
counts, C = 1 (the density table) and C = 2 (the colour table), against
the JAX package, on the CPU at a small size (6 levels, 2^12-2^13 tables).
On a CUDA tensor the same wrappers launch the kernels' C = 1 and C = 2
instantiations; tests/test_torch_kernels.py holds those to these plain
versions on the card.

Tolerances, with their reasons:

* the encode kernels' plain versions at C = 1 and 2 channels (K2/K3 on the
  block512 path, K5/K6 on the winsort path) against JAX's
  ``splat_encode_raw(..., interpret=True)``, whose Pallas kernels run in
  interpret mode as tests/test_splat.py runs them: features atol 2e-6, rtol
  1e-5.  JAX's backward of that encode cannot run at C = 1 or 2: its
  custom VJP returns a [W, 24, 64] splat-table gradient (3 channels x 8
  rows) for a [W, 8C, 64] splat table, and JAX rejects it.  So the table
  gradients are held to ``jax.grad`` of JAX's ``hashgrid_encode`` on the
  exact routes (as tests/test_splat.py holds the splat gradient), atol
  1e-4, rtol 1e-4, and on every route to JAX's splat forward itself: the
  encode is linear in the table, so <v, dtable> must equal sum(f(v) * g)
  for any table v (rtol 1e-5, two random v);
* K4's plain version at C = 1 and 2 against JAX's ``_fwd_pallas`` with
  ``pl.pallas_call`` patched to interpret mode, and K4b's against JAX's
  ``_sweep_bwd``: tests/test_torch_sweep.py's tolerances (atol 1e-5: XLA
  fuses the interpret kernel's lattice multiply-add; 1e-4 for gradients).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.ops import hashgrid as jhg
from nerf2mesh_tpu.ops import pallas_encode as jpe
from nerf2mesh_tpu.ops import splat_encode as jse
from nerf2mesh_tpu_torch import kernels
from nerf2mesh_tpu_torch.ops import hashgrid as thg
from nerf2mesh_tpu_torch.ops import pallas_encode as tpe
from nerf2mesh_tpu_torch.ops import splat_encode as tse


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def specs(C, layout="block512", **kw):
    base = dict(num_levels=6, level_dim=C, log2_hashmap_size=13,
                desired_resolution=256, layout=layout)
    base.update(kw)
    return jhg.HashGridSpec(**base), thg.HashGridSpec(**base)


def mixed_points(n_tiles, seed):
    """Half the tiles clustered (tile-local), half uniform; a few points
    outside [0, 1]^3."""
    rng = np.random.default_rng(seed)
    h = n_tiles // 2
    local = (rng.uniform(0.1, 0.9, (h, 1, 3))
             + rng.uniform(0, 0.03, (h, tse.TILE, 3)))
    rnd = rng.uniform(0, 1, (n_tiles - h, tse.TILE, 3))
    x = np.clip(np.concatenate([local, rnd]), 0, 1).reshape(-1, 3)
    x[[5, 300]] = [[1.4, 0.5, 0.5], [0.5, -0.1, 0.5]]
    return x.astype(np.float32)


def table_and_grad(spec, n, seed):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_size, spec.level_dim))
    g = rng.normal(size=(n, spec.output_dim))
    return table.astype(np.float32), g.astype(np.float32)


def port_encode_and_grad(table, x, g, spec, **kw):
    tt = T(table).requires_grad_()
    feat, cnt = tse.splat_encode_raw(tt, T(x), spec, **kw)
    (feat * T(g)).sum().backward()
    return feat.detach().numpy(), tt.grad.numpy(), cnt


def jax_splat(table, x, spec, **kw):
    f, _ = jse.splat_encode_raw(jnp.asarray(table), jnp.asarray(x), spec,
                                resid_budget=1 << 15, interpret=True, **kw)
    return np.asarray(f)


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("route", ["inwin", "inwin_stochastic", "winsort"])
def test_encode_kernels_plain_match_jax_interpret(C, route):
    """inwin: K2/K3 at every level with the exact residual; stochastic: K2/K3
    at levels 0-3 with the 1-corner residual and gather levels 4-5 (the
    position hash draws the same corners as JAX's); winsort: K5/K6 at levels
    3-5, on uniform points (the fine-level regime)."""
    js, ts = specs(C)
    if route == "winsort":
        x = np.random.default_rng(1).uniform(0, 1, (4 * tse.TILE, 3))
        x[[7, 200]] = [[1.3, 0.5, 0.5], [0.5, 0.5, -0.2]]
        x = x.astype(np.float32)
        kw = dict(gather_levels=(3, 4, 5), winsort_levels=(3, 4, 5))
    else:
        x = mixed_points(4, seed=2)
        kw = (dict(gather_levels=(4, 5), stochastic=True)
              if route == "inwin_stochastic" else {})
    table, g = table_and_grad(ts, x.shape[0], seed=C)
    got, dt, cnt = port_encode_and_grad(table, x, g, ts, **kw)
    want = jax_splat(table, x, js, **kw)
    assert got.shape == want.shape == (x.shape[0], 6 * C)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    assert not got[[5 if route != "winsort" else 7]].any()
    assert cnt.shape == (6,) and np.abs(dt).max() > 0.1
    rng = np.random.default_rng(10 + C)
    for _ in range(2):
        v = rng.uniform(-1, 1, table.shape).astype(np.float32)
        lhs = float(np.sum(v.astype(np.float64) * dt))
        rhs = float(np.sum(jax_splat(v, x, js, **kw).astype(np.float64) * g))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
    if route != "inwin_stochastic":
        # the exact routes are the plain encode, and their gradient its
        dt_want = jax.grad(lambda t: jnp.sum(jhg.hashgrid_encode(
            t, jnp.asarray(x), js) * jnp.asarray(g)))(jnp.asarray(table))
        np.testing.assert_allclose(dt, np.asarray(dt_want), atol=1e-4,
                                   rtol=1e-4)
        ref = thg.hashgrid_encode(T(table), T(x), ts).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("C", [1, 2])
def test_sweep_plain_matches_jax_at_channels(C, monkeypatch):
    """K4's plain version against the Pallas kernel in interpret mode, and
    K4b's (with the input gradient) against JAX's _sweep_bwd."""
    js, ts = specs(C, layout="ref", log2_hashmap_size=12,
                   desired_resolution=128)
    rng = np.random.default_rng(3 + C)
    x = rng.uniform(0, 1, (384, 3)).astype(np.float32)
    x[[3, 4]] = [[1.5, 0.5, 0.5], [0.2, -0.3, 0.9]]
    table, g = table_and_grad(ts, x.shape[0], seed=C)
    monkeypatch.setattr(jpe.pl, "pallas_call",
                        functools.partial(jpe.pl.pallas_call, interpret=True))
    want = np.asarray(jpe._fwd_pallas(jpe.pad_table(jnp.asarray(table), js),
                                      jnp.asarray(x), js))
    got = tpe.sweep_fwd_plain(T(table), T(x), ts).numpy()
    assert got.shape == want.shape == (x.shape[0], 6 * C)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    dt_want, dx_want = jpe._sweep_bwd(js, (jnp.asarray(table), jnp.asarray(x)),
                                      jnp.asarray(g))
    tt, tx = T(table).requires_grad_(), T(x).requires_grad_()
    tpe.sweep_encode(tt, tx, ts).backward(T(g))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(dt_want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_want),
                               rtol=1e-4, atol=1e-4)
    dt, none = tpe.sweep_bwd_plain(T(table), T(x), T(g), ts, need_dx=False)
    assert none is None and dt.shape == (ts.table_size, C)


def test_wrappers_check_channels():
    """A wrapper takes a table of spec.level_dim channels, 1-3; its CPU
    dispatch is the plain version; kernels.count books a launch under its
    name and its channel count."""
    _, ts1 = specs(1)
    x = T(mixed_points(4, seed=4)).clamp(0, 1)
    metas = [tse.tile_meta(x.reshape(-1, tse.TILE, 3), ts1, l) for l in (0, 1)]
    bases = torch.stack([m[0] for m in metas])
    rows = torch.stack([m[1] for m in metas])
    t1 = torch.rand(ts1.table_size, 1)
    out = tse.inwin_fwd(t1, x, bases, rows, ts1, (0, 1))
    assert out.shape == (x.shape[0], 2, 1)
    with pytest.raises(ValueError, match=r"\[total, 1\]"):
        tse.inwin_fwd(torch.rand(ts1.table_size, 2), x, bases, rows, ts1,
                      (0, 1))
    with pytest.raises(ValueError, match="grad"):
        tse.inwin_bwd(torch.rand(x.shape[0], 2, 3), x, bases, rows, ts1,
                      (0, 1), ts1.table_size)
    _, ts4 = specs(4)
    with pytest.raises(ValueError, match="level_dim=4"):
        tse.inwin_fwd(torch.rand(ts4.table_size, 4), x, bases, rows, ts4,
                      (0, 1))
    before = dict(kernels.LAUNCHES)
    kernels.count("winsort_bwd", 2)
    after = dict(kernels.LAUNCHES)
    assert after["winsort_bwd"] == before["winsort_bwd"] + 1
    assert after["winsort_bwd_c2"] == before["winsort_bwd_c2"] + 1
    assert {k for k in after if after[k] != before[k]} == {
        "winsort_bwd", "winsort_bwd_c2"}
    kernels.LAUNCHES.update(before)
