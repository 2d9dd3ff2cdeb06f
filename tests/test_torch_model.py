"""Parity of the port's data, network and renderer modules with the JAX
package, on the CPU at a small size.

Float tolerance atol 1e-5 (fp32 on both sides; the sums run in another
order, and the JAX field runs under jit, where XLA's CPU backend fuses the
lattice multiply-add; the table weights here are the JAX init's +-1e-4, so
that fusion moves the features by ~1e-9).  Integer/bool outputs are exactly
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.config import Config as JConfig
from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
from nerf2mesh_tpu.data.rays import get_rays as jget_rays
from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset as jgen
from nerf2mesh_tpu.models import network as jnet
from nerf2mesh_tpu.models import renderer as jren
from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.data.provider import (dataset_from_frames,
                                               load_nerf_dataset as tload)
from nerf2mesh_tpu_torch.data.rays import get_rays as tget_rays
from nerf2mesh_tpu_torch.data.synthetic import (generate_synthetic_dataset,
                                                render_synthetic_frames)
from nerf2mesh_tpu_torch.models import network as tnet
from nerf2mesh_tpu_torch.models import renderer as tren
from nerf2mesh_tpu_torch.utils.convert import (load_params, params_from_jax,
                                               params_to_numpy)

TOL = dict(atol=1e-5)


def T(a):
    return torch.from_numpy(np.array(a))


def net_specs(**kw):
    base = dict(bound=1.0, num_levels=6, log2_hashmap_size=14,
                grid_layout="block512", encode_gather_levels=(4, 5))
    base.update(kw)
    return jnet.NetworkSpec(**base), tnet.NetworkSpec(**base)


def jax_field(jspec, tspec, seed=0):
    params = jnet.init_network(jax.random.PRNGKey(seed), jspec)
    field = tnet.NeRFField(tspec, torch.Generator().manual_seed(1))
    load_params(field, params_from_jax(params))
    return params, field


def test_params_roundtrip():
    jspec, tspec = net_specs()
    params, field = jax_field(jspec, tspec)
    back = params_to_numpy(dict(field.named_parameters()))
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert tuple(field.table.shape) == (jspec.density_grid_spec.table_size, 3)
    assert tuple(field.color_net[0].w.shape) == (3 + 2 * 6, 64)   # [in, out]


def _field_inputs(n=600, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    x[:5] = 3.0                                  # pool sentinels (oob)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return x, d


@pytest.mark.parametrize("layout", ["block512", "ref"])
@pytest.mark.parametrize("full", [True, False])
def test_field_forward_parity(full, layout):
    """block512: the splat path (sorted, residual counts); ref at a 2^14
    table: the sweep encode (unsorted, no counts)."""
    jspec, tspec = net_specs(grid_layout=layout)
    params, field = jax_field(jspec, tspec)
    x, d = _field_inputs()
    js, jc, jsp, _ = jnet.field_forward(params, jnp.asarray(x), jnp.asarray(d),
                                        jspec, jnp.asarray(full), None,
                                        jnp.int32(16))
    ts_, tc, tsp, cnt = tnet.field_forward(field, T(x), T(d), tspec, full, 16)
    np.testing.assert_allclose(ts_.detach().numpy(), np.asarray(js), rtol=1e-5,
                               **TOL)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tsp.detach().numpy(), np.asarray(jsp), **TOL)
    if layout == "ref":
        assert cnt is None
    else:
        assert cnt.shape == (6,) and cnt.dtype == torch.int32


@pytest.mark.parametrize("layout", ["block512", "ref"])
def test_density_parity_stochastic_off_and_on(layout):
    jspec, tspec = net_specs(grid_layout=layout)
    params, field = jax_field(jspec, tspec)
    x, _ = _field_inputs(500, seed=3)
    want = np.asarray(jnet.density(params, jnp.asarray(x), jspec))
    got = tnet.density(field, T(x), tspec).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, **TOL)
    sto = tnet.density(field, T(x), dataclasses.replace(
        tspec, encode_stochastic=True)).detach().numpy()
    if layout == "ref":
        # the 1-corner estimate exists only on the splat path: ref is exact
        np.testing.assert_array_equal(sto, got)
        return
    # unbiased 1-corner estimate: close to the exact density on average
    assert np.isfinite(sto).all() and abs(sto.mean() / want.mean() - 1) < 0.05


def test_unsupported_modes_raise():
    """Separate tables are ported (sigma_table [total, 1], color_table
    [total, 2]); a table of a channel count that no encode kernel has an
    instantiation for raises on both the block512 and the ref route."""
    _, tspec = net_specs()
    field = tnet.NeRFField(dataclasses.replace(tspec, separate_tables=True),
                           torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in field.named_parameters()
            if n.endswith("table")} == {
        "sigma_table": (tspec.density_grid_spec.table_size, 1),
        "color_table": (tspec.density_grid_spec.table_size, 2)}
    for layout in ("block512", "ref"):
        spec = dataclasses.replace(
            dataclasses.replace(tspec, grid_layout=layout).density_grid_spec,
            level_dim=4)
        table = torch.zeros((spec.table_size, 4))
        with pytest.raises(ValueError, match="level_dim=4"):
            tnet._encode(table, torch.rand(128, 3), spec, None, tspec)


def render_specs(H=32):
    kw = dict(bound=1.0, grid_size=H, num_coarse=128, num_fine=32,
              max_steps=1024, dt_gamma=0.0)
    return jren.RenderSpec(**kw), tren.RenderSpec(**kw)


def test_update_density_slab_parity():
    jspec, tspec = net_specs()
    params, field = jax_field(jspec, tspec)
    jr, tr = render_specs()
    rng = np.random.default_rng(0)
    grid0 = rng.uniform(0, 5, (1, 32, 32, 32)).astype(np.float32)
    grid0[0, :, :, :4] = -1.0                        # untrained cells
    jstate = jren.RenderState(jnp.asarray(grid0), jnp.ones(grid0.shape, jnp.uint8),
                              jnp.float32(0), jnp.int32(0))
    tstate = tren.RenderState(T(grid0), torch.ones(grid0.shape, dtype=torch.uint8),
                              torch.zeros(()))
    key = jax.random.PRNGKey(3)
    slab = 5
    out = jren._update_density_slab(params, jstate, key, jr, jspec, None,
                                    jnp.int32(slab))
    # the same jitter the JAX slab update draws from its key
    half = 1.0 / 32
    n = (32 // tren.GRID_UPDATE_SLABS) * 32 * 32
    noise = np.asarray(jax.random.uniform(jax.random.split(key, 1)[0], (n, 3),
                                          minval=-half, maxval=half))
    got = tren._update_density_slab(field, tstate, [T(noise)], tr, tspec,
                                    None, slab)
    np.testing.assert_allclose(got.density_grid.numpy(),
                               np.asarray(out.density_grid), rtol=1e-5, **TOL)
    np.testing.assert_array_equal(got.occ_grid.numpy(), np.asarray(out.occ_grid))
    np.testing.assert_allclose(float(got.mean_density),
                               float(out.mean_density), rtol=1e-5)
    assert got.iter_density == int(out.iter_density) == 1


@pytest.mark.parametrize("pool", [None, 8192, 640])
def test_render_train_parity(pool):
    """Dense, pooled and overflowing pool (rays dropped from the loss)."""
    jspec, tspec = net_specs()
    params, field = jax_field(jspec, tspec)
    jr, tr = render_specs()
    H, N = 32, 256
    ax = (np.arange(H) + 0.5) / H * 2 - 1
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    occ = (np.linalg.norm(g, axis=-1) < 0.6).astype(np.uint8)[None]
    rng = np.random.default_rng(5)
    o = rng.normal(size=(N, 3))
    o = (2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (N, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    bg = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jo = jren.render_train(params, jnp.asarray(occ), jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(bg), key, jr, jspec,
                           full_flag=jnp.asarray(True), pool_size=pool)
    u = np.asarray(jax.random.uniform(key, (N, jr.num_fine)))  # JAX's draw
    to = tren.render_train(field, T(occ), T(o), T(d), T(bg), T(u), tr, tspec,
                           full_flag=True, pool_size=pool)
    assert int(to["num_points"]) == int(jo["num_points"]) > 640
    assert int(to["pool_overflow"]) == int(jo["pool_overflow"])
    np.testing.assert_array_equal(to["ray_kept"].numpy(),
                                  np.asarray(jo["ray_kept"]))
    assert bool(to["ray_kept"].all()) == (pool != 640)
    for k in ("image", "weights_sum", "depth"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   err_msg=k, **TOL)


def test_compact_ids_matches_nonzero():
    rng = np.random.default_rng(0)
    v = rng.random(1000) < 0.3
    for P in (64, 300, 512):
        want = np.asarray(jnp.nonzero(jnp.asarray(v), size=P,
                                      fill_value=1000)[0])
        np.testing.assert_array_equal(tren.compact_ids(T(v), P).numpy(), want)


def test_synthetic_scene_and_providers_match(tmp_path):
    """In-memory frames == the JAX generator's PNGs, loaded by either
    provider; dataset_from_frames == load_nerf_dataset."""
    kw = dict(H=24, W=24, n_train=3, n_val=1, n_test=1)
    root = str(tmp_path / "scene")
    jgen(root, **kw)
    jcfg = dataclasses.replace(JConfig(path=root), bound=1.0, scale=0.8)
    tcfg = dataclasses.replace(TConfig(path=root), bound=1.0, scale=0.8)
    jds = jload(jcfg, "train")
    frames = render_synthetic_frames(**kw)
    tds = dataset_from_frames(tcfg, frames, "train")
    tds2 = tload(tcfg, "train")
    for ds in (tds, tds2):
        np.testing.assert_array_equal(ds.images, jds.images)
        np.testing.assert_array_equal(ds.poses, jds.poses)
        np.testing.assert_array_equal(ds.intrinsics, jds.intrinsics)
        np.testing.assert_allclose(ds.mvps, jds.mvps, rtol=1e-6)
        assert (ds.H, ds.W, ds.training) == (jds.H, jds.W, jds.training)
    root2 = str(tmp_path / "scene2")
    generate_synthetic_dataset(root2, **kw)
    np.testing.assert_array_equal(
        tload(dataclasses.replace(tcfg, path=root2), "val").images,
        jload(dataclasses.replace(jcfg, path=root), "val").images)


def test_get_rays_and_mark_untrained_parity():
    frames = render_synthetic_frames(H=24, W=24, n_train=5, n_val=0, n_test=0)
    tcfg = dataclasses.replace(TConfig(), bound=1.0, scale=0.8)
    ds = dataset_from_frames(tcfg, frames)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 5, 300)
    pix = rng.integers(0, 24 * 24, 300)
    intr = tuple(float(v) for v in ds.intrinsics)
    jr = jget_rays(jnp.asarray(ds.poses)[img], tuple(jnp.float32(v) for v in intr),
                   24, 24, jnp.asarray(pix))
    tr = tget_rays(T(ds.poses)[T(img)], intr, 24, 24, T(pix))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), atol=1e-6)
    for k in ("i", "j"):
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))

    jrs, trs = render_specs(H=32)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jm = jren.mark_untrained_grid(jren.init_render_state(jrs), ds.poses,
                                  ds.intrinsics, jrs, aabb=aabb)
    tm = tren.mark_untrained_grid(tren.init_render_state(trs), ds.poses,
                                  ds.intrinsics, trs, aabb=aabb)
    np.testing.assert_array_equal(tm.density_grid.numpy(),
                                  np.asarray(jm.density_grid))
    assert (tm.density_grid.numpy() < 0).any()
