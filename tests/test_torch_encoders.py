"""The plain encode's options and the analytic encoders of the port
(ops/hashgrid.py, ops/sh.py, ops/freq.py, ops/encoding.py) against the JAX
package, on the CPU.

* ``hashgrid_encode`` (smoothstep, 1-3-D input, hash and tiled grids,
  ``align_corners``) against JAX's run op by op (``jax.disable_jit()``,
  where both round the lattice product and sum separately): values and
  table gradients at atol 1e-6;
* ``sh_encode`` (degrees 1-8), ``freq_encode`` and every name of
  ``get_encoder``: atol 1e-6 (float32 polynomials and sines evaluated in
  the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf2mesh_tpu.ops import encoding as jenc
from nerf2mesh_tpu.ops import freq as jfreq
from nerf2mesh_tpu.ops import hashgrid as jhg
from nerf2mesh_tpu.ops import sh as jsh
from nerf2mesh_tpu_torch.ops import encoding as tenc
from nerf2mesh_tpu_torch.ops import freq as tfreq
from nerf2mesh_tpu_torch.ops import hashgrid as thg
from nerf2mesh_tpu_torch.ops import sh as tsh


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


# ---------------------------------------------------------------------------
# the plain encode's options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("opts", [
    dict(), dict(interpolation="smoothstep"), dict(gridtype="tiled"),
    dict(align_corners=True), dict(interpolation="smoothstep",
                                   gridtype="tiled", align_corners=True)])
def test_hashgrid_encode_options_match_jax(D, opts):
    kw = dict(num_levels=5, level_dim=2, log2_hashmap_size=10,
              desired_resolution=256, input_dim=D, **opts)
    js, ts = jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)
    rng = np.random.default_rng(D)
    x = rng.uniform(0, 1, (300, D)).astype(np.float32)
    x[0, 0], x[1, -1], x[2] = 1.2, -0.1, 1.0
    table = rng.uniform(-1, 1, (ts.table_size, 2)).astype(np.float32)
    g = rng.normal(size=(300, ts.output_dim)).astype(np.float32)
    with jax.disable_jit():
        want, vjp = jax.vjp(lambda t: jhg.hashgrid_encode(t, jnp.asarray(x),
                                                         js, 3),
                            jnp.asarray(table))
        dt_want = vjp(jnp.asarray(g))[0]
    tt = T(table).requires_grad_()
    got = thg.hashgrid_encode(tt, T(x), ts, 3)
    got.backward(T(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(dt_want),
                               atol=1e-6, rtol=0)
    assert not got[:2].any() and got[2:].abs().max() > 0.1


def test_hashgrid_encode_rejects_wrong_width():
    ts = thg.HashGridSpec(num_levels=4, level_dim=2, log2_hashmap_size=10,
                          input_dim=2)
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        thg.hashgrid_encode(torch.zeros(ts.table_size, 2), torch.rand(8, 3),
                            ts)


# ---------------------------------------------------------------------------
# the SH and frequency encoders and get_encoder
# ---------------------------------------------------------------------------

def unit_dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode_matches_jax(degree):
    d = unit_dirs(200, degree)
    got = tsh.sh_encode(T(d), degree).numpy()
    want = np.asarray(jsh.sh_encode(jnp.asarray(d), degree))
    assert got.shape == (200, tsh.sh_output_dim(degree)) == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sh_encode_reference_golden():
    """tests/test_network.py's degree-3 golden values (the reference
    kernel's constants, the Condon-Shortley phase on odd m)."""
    x, y, z = 0.3, -0.5, 0.81240384
    out = tsh.sh_encode(torch.tensor([[x, y, z]]), 3).numpy()[0]
    expect = np.array([
        0.28209479177387814, -0.48860251190291987 * y,
        0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.94617469575755997 * z * z - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * (x * x - y * y)])
    np.testing.assert_allclose(out, expect, atol=1e-6)
    with pytest.raises(ValueError):
        tsh.sh_encode(torch.zeros(1, 3), 9)


@pytest.mark.parametrize("degree", [0, 1, 4, 10])
def test_freq_encode_matches_jax(degree):
    x = np.random.default_rng(degree).uniform(-2, 2, (100, 3)).astype(
        np.float32)
    got = tfreq.freq_encode(T(x), degree).numpy()
    want = np.asarray(jfreq.freq_encode(jnp.asarray(x), degree))
    assert got.shape[1] == tfreq.freq_output_dim(3, degree) == want.shape[1]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", [
    None, "None", "identity", "frequency", "freq", "frequency_torch",
    "sphere_harmonics", "SH", "hashgrid", "tiledgrid", "hashgrid_tcnn"])
def test_get_encoder_matches_jax(name):
    kw = dict(input_dim=3, degree=3, num_levels=4, level_dim=2,
              log2_hashmap_size=10, desired_resolution=64)
    jfn, jinit, jdim = jenc.get_encoder(name, **kw)
    tfn, tinit, tdim = tenc.get_encoder(name, **kw)
    assert tdim == jdim and (tinit is None) == (jinit is None)
    x = unit_dirs(64, 0) * 0.9
    if tinit is None:
        got, want = tfn(None, T(x)), jfn(None, jnp.asarray(x))
    else:
        params = tinit(torch.Generator().manual_seed(0))
        jparams = jinit(jax.random.PRNGKey(0))
        assert tuple(params.shape) == tuple(jparams.shape)
        assert float(params.abs().max()) <= 1e-4
        table = np.random.default_rng(1).uniform(
            -1, 1, tuple(params.shape)).astype(np.float32)
        got = tfn(T(table), T(x), bound=1.0)
        with jax.disable_jit():
            want = jfn(jnp.asarray(table), jnp.asarray(x), bound=1.0)
    assert got.shape == (64, tdim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_get_encoder_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown encoder"):
        tenc.get_encoder("spline")
