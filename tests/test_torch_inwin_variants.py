"""K7 (ops/inwin_variants.py), K2's plain version and K1's flat index
against the JAX package, on the CPU.

K7's plain versions against the TPU's dense window contraction: JAX's
``_level_pallas_fwd`` (the Pallas forward of K2, in interpret mode), run
on the splat layout of the same table, with each tile's rows (K7b, K7d) or
rows (0, 1) * 4 (K7c, the constant-row probe).  K2's plain version against
the same Pallas forward at every level.  Tolerance: atol 2e-6 / rtol 1e-5
(fp32 sums in another order), as tests/test_torch_ops.py's encodes.  The
wrappers' CPU dispatch and argument checks.  K1's flat index
(``sampling.occupancy_index``) against the index inside JAX's
``occupancy_lookup``, read out bit by bit through grids whose cell n holds
bit b of n.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.ops import sampling as jsamp
from nerf2mesh_tpu.ops import splat_encode as jse
from nerf2mesh_tpu_torch.ops import hashgrid as thg
from nerf2mesh_tpu_torch.ops import inwin_variants as iv
from nerf2mesh_tpu_torch.ops import sampling as tsamp
from nerf2mesh_tpu_torch.ops import splat_encode as tse
from test_torch_ops import ENC_TOL, T, sorted_points, specs, uniform_table


def _pallas_level(table, x, bases, rows, js, l):
    """JAX's Pallas forward of K2 at level l (interpret mode): [N, 3]."""
    n_tiles = x.shape[0] // 128
    x_t = np.pad(x.reshape(-1, 128, 3).transpose(0, 2, 1),
                 ((0, 0), (0, 5), (0, 0))).reshape(-1, 128)
    woffs = jse.window_offsets(js)
    tab_l = jse.to_splat(jnp.asarray(table), js)[int(woffs[l]):int(woffs[l + 1])]
    out = jse._level_pallas_fwd(jnp.asarray(x_t), jnp.asarray(bases),
                                jnp.asarray(rows), tab_l, js, l, interpret=True)
    out = np.asarray(out).reshape(n_tiles, 8, 128)[:, :3]
    return out.transpose(0, 2, 1).reshape(-1, 3)


def _level_inputs(ts, x, l):
    bases, rows = tse.tile_meta(T(x).reshape(-1, 128, 3), ts, l)
    return bases, rows


@pytest.mark.parametrize("name,l", [
    ("inwin_dense_deep", 1), ("inwin_dense_deep", 4),
    ("inwin_dense_four_tiles", 4), ("inwin_dense_const_rows", 1),
    ("inwin_dense_const_rows", 4)])
def test_dense_plain_vs_pallas(name, l):
    """K7's plain versions == the TPU kernel's contraction, at a dense
    level (1) and a hashed one (4)."""
    js, ts = specs(14)
    table = uniform_table(js)
    x = sorted_points(2048)
    bases, rows = _level_inputs(ts, x, l)
    if name == "inwin_dense_const_rows":
        got = iv.inwin_dense_const_rows_plain(T(table), T(x), bases, ts, l)
        rows = iv.const_rows(bases.shape[0])
    else:
        got = iv.inwin_dense_plain(T(table), T(x), bases, rows, ts, l)
    want = _pallas_level(table, x, bases.numpy(), rows.numpy(), js, l)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got[:, 0].numpy(), want, **ENC_TOL)
    # on the CPU each wrapper is its plain version
    args = ((T(table), T(x), bases, ts, l) if name == "inwin_dense_const_rows"
            else (T(table), T(x), bases, rows, ts, l))
    assert torch.equal(getattr(iv, name)(*args), got)


def test_inwin_plain_vs_pallas_every_level():
    """K2's plain version == the Pallas forward, level by level, on tiles
    that include a same-window slot pair (level 3)."""
    from test_torch_ops import _same_window_tile
    js, ts = specs(14)
    table = uniform_table(js)
    rng = np.random.default_rng(4)
    x = np.concatenate([sorted_points(1024), _same_window_tile(js, 3, rng)])
    levels = tuple(range(js.num_levels))
    metas = [_level_inputs(ts, x, l) for l in levels]
    bases = torch.stack([m[0] for m in metas])
    rows = torch.stack([m[1] for m in metas])
    assert len(set(rows[3, -1].tolist())) < 8
    got = tse.inwin_fwd(T(table), T(x), bases, rows, ts, levels)   # CPU: plain
    for k, l in enumerate(levels):
        want = _pallas_level(table, x, bases[k].numpy(), rows[k].numpy(), js, l)
        np.testing.assert_allclose(got[:, k].numpy(), want, **ENC_TOL)


def test_const_rows():
    r = iv.const_rows(3)
    assert r.dtype == torch.int32 and tuple(r.shape) == (3, 8)
    assert r[2].tolist() == [0, 1, 0, 1, 0, 1, 0, 1]


def _tf32(v):
    """cvt.rna.tf32.f32: v rounded to 10 mantissa bits, to nearest with
    ties away from zero (the sign stands apart from the magnitude bits)."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def test_tf32_rounding_model():
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    assert _tf32(v).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                 -(1.0 + 2.0 ** -10), 1.0, 3.0]


@pytest.mark.parametrize("probe", [False, True])
def test_dense_3xtf32_model(probe):
    """The kernels' arithmetic on K7's dense operands at a hashed level:
    the 3xTF32 product (A_lo B_hi + A_hi B_lo + A_hi B_hi in fp32, tf32
    products exact) stays within the kernels' atol 1e-5 of the plain
    version with the table in [-1, 1]; one tf32 product does not; the
    operands in fp32 give the plain version."""
    _, ts = specs(14)
    l = 4
    table = T(uniform_table(ts))
    x = T(sorted_points(2048))
    bases, rows = _level_inputs(ts, x.numpy(), l)
    if probe:
        rows = iv.const_rows(bases.shape[0])
        want = iv.inwin_dense_const_rows_plain(table, x, bases, ts, l)
    else:
        want = iv.inwin_dense_plain(table, x, bases, rows, ts, l)
    a, b, wx = iv.dense_operands(table, x, bases, rows, ts, l)
    assert tuple(a.shape) == (16, 128, 256) and tuple(b.shape) == (16, 256, 48)
    assert float(want.abs().max()) > 0.5
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    split3 = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    def err(prod):
        return float((iv.dense_features(prod, wx) - want).abs().max())
    assert err(a @ b) <= 2e-6
    assert err(split3) <= 1e-5
    assert err(a_hi @ b_hi) > 1e-5


def _dense_args():
    _, ts = specs(14)
    x = T(sorted_points(256))
    bases, rows = _level_inputs(ts, x.numpy(), 4)
    table = torch.zeros((ts.table_size, 3))
    return table, x, bases, rows, ts


@pytest.mark.parametrize("bad", ["level", "x_dtype", "n", "bases", "rows",
                                 "table", "one_window"])
def test_dense_wrappers_check_inputs(bad):
    table, x, bases, rows, ts = _dense_args()
    l, fn = 4, iv.inwin_dense_deep
    if bad == "level":
        l = ts.num_levels
    elif bad == "x_dtype":
        x = x.double()
    elif bad == "n":
        x, bases, rows = x[:200], bases[:1], rows[:1]
    elif bad == "bases":
        bases = bases.long()
    elif bad == "rows":
        rows = rows[:, :4]
    elif bad == "table":
        table = table[:-1]
    else:               # a level of one window cannot hold windows 0 and 1
        one = thg.HashGridSpec(num_levels=2, level_dim=3, log2_hashmap_size=9,
                               desired_resolution=32, layout="block512")
        assert int(one.level_sizes[0]) == 512
        with pytest.raises(ValueError):
            iv.inwin_dense_const_rows(torch.zeros((one.table_size, 3)), x,
                                      bases, one, 0)
        return
    with pytest.raises(ValueError):
        fn(table, x, bases, rows, ts, l)


def test_dense_wrappers_reject_other_devices():
    table, x, bases, rows, ts = _dense_args()
    with pytest.raises(RuntimeError):
        iv.inwin_dense_four_tiles(table.to("meta"), x.to("meta"),
                                  bases.to("meta"), rows.to("meta"), ts, 4)


def _jax_flat_index(xyz, dts, bound, contracted, cascades, H):
    """The flat cell index inside JAX's occupancy_lookup, read out bit by
    bit: grid b holds bit b of each cell's own index.  Points whose occ JAX
    forces on (contracted, |x| > 1) come back as all ones."""
    n_cells = cascades * H ** 3
    cells = np.arange(n_cells)
    flat = np.zeros(xyz.shape[0], np.int64)
    for b in range(int(n_cells - 1).bit_length()):
        grid = ((cells >> b) & 1).astype(np.uint8).reshape(cascades, H, H, H)
        occ, _ = jsamp.occupancy_lookup(jnp.asarray(grid), jnp.asarray(xyz),
                                        jnp.asarray(dts), bound, contracted,
                                        cascades, H)
        flat |= np.asarray(occ).astype(np.int64) << b
    return flat


@pytest.mark.parametrize("cascades,contracted", [(1, False), (2, False),
                                                 (2, True)])
def test_occupancy_index_equals_jax(cascades, contracted):
    rng = np.random.default_rng(2)
    H = 16
    bound = 2.0 if cascades > 1 else 1.0
    xyz = np.concatenate([rng.uniform(-1, 1, (1500, 3)),
                          rng.uniform(-bound * 1.2, bound * 1.2, (1500, 3))]
                         ).astype(np.float32)
    dts = rng.uniform(1e-3, 0.4, 3000).astype(np.float32)
    want = _jax_flat_index(xyz, dts, bound, contracted, cascades, H)
    got, _ = tsamp.occupancy_index(T(xyz), T(dts), bound, contracted,
                                   cascades, H)
    assert got.dtype == torch.int32
    keep = ~(contracted & (np.abs(xyz).max(-1) > 1.0))
    assert keep.sum() > 500
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    assert len(np.unique(want[keep] // H ** 3)) == cascades
