"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one.
The machine with the card has no JAX, so run this file there without the
repository's conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerances: K1 exact; K2, K4 and K5 atol 1e-5; K3, K4b and K6 atol 1e-5
with rtol 1e-4 of each row's summed |contribution| (their shared-memory
atomics add in another order, which changes from run to run).
"""

import numpy as np
import pytest
import torch

from nerf2mesh_tpu_torch import kernels
from nerf2mesh_tpu_torch.ops import occ_sweep
from nerf2mesh_tpu_torch.ops import pallas_encode as pe
from nerf2mesh_tpu_torch.ops import splat_encode as se
from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode

pytestmark = pytest.mark.cuda

SPEC = HashGridSpec(num_levels=6, level_dim=3, log2_hashmap_size=14,
                    desired_resolution=256, layout="block512")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _points(n, seed=0):
    rng = np.random.default_rng(seed)
    h = n // 2
    c = rng.uniform(0.2, 0.8, (8, 3))
    pts = np.concatenate([c[rng.integers(0, 8, h)]
                          + rng.uniform(0, 0.03, (h, 3)),
                          rng.uniform(0, 1, (n - h, 3))])
    return torch.from_numpy(np.clip(pts, 0, 1).astype(np.float32))


def _same_window_tile(l=3, seed=0):
    """128 points around a 2x2x2 block neighbourhood of level l in which two
    slots share one window id (levels 2-5 of SPEC have such blocks)."""
    from nerf2mesh_tpu_torch.ops.hashgrid import block_window
    slots = torch.tensor([[s & 1, (s >> 1) & 1, (s >> 2) & 1] for s in range(8)])
    ax = torch.arange(int(SPEC.block_counts[l]) - 1)
    b = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    win = torch.sort(block_window(b[:, None] + slots[None], SPEC, l), 1)[0]
    base = b[(win[:, 1:] == win[:, :-1]).any(1).nonzero()[0, 0]].numpy()
    rng = np.random.default_rng(seed)
    cells = 8 * base[None] + rng.uniform(0, 15, (128, 3))
    cells[0] = 8 * base + 0.25
    pts = (cells - SPEC.shift) / SPEC.level_scale32(l)
    return torch.from_numpy(np.clip(pts, 0, 1).astype(np.float32))


def _inputs(dev, n=2048, levels=tuple(range(6))):
    x = _points(n - 128).to(dev)
    perm, _ = se.morton_perm(x)
    x = torch.cat([x[perm], _same_window_tile().to(dev)]).contiguous()
    tiles = x.reshape(-1, se.TILE, 3)
    metas = [se.tile_meta(tiles, SPEC, l) for l in levels]
    bases = torch.stack([m[0] for m in metas]).contiguous()
    rows = torch.stack([m[1] for m in metas]).contiguous()
    g = torch.Generator(device="cpu").manual_seed(1)
    table = (torch.rand((SPEC.table_size, 3), generator=g) * 2 - 1).to(dev)
    return table, x, bases, rows, levels


def test_occ_lookup_kernel_exact(dev):
    g = torch.Generator(device="cpu").manual_seed(0)
    occ = (torch.rand((1, 64, 64, 64), generator=g) < 0.3).to(torch.uint8).to(dev)
    words = occ_sweep.pack_bits(occ)
    idx = torch.randint(0, 64 ** 3, (4096, 128), generator=g,
                        dtype=torch.int32).to(dev)
    before = kernels.LAUNCHES["occ_lookup"]
    got = occ_sweep.occ_lookup(words, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["occ_lookup"] == before + 1
    assert torch.equal(got, occ_sweep.occ_lookup_plain(words, idx))
    assert torch.equal(got, occ.reshape(-1)[idx.long()].to(torch.int32))


def test_inwin_kernels_match_plain(dev):
    table, x, bases, rows, levels = _inputs(dev)
    assert len(set(rows[3, -1].tolist())) < 8          # same-window slots
    out = se.inwin_fwd(table, x, bases, rows, SPEC, levels)
    ref = se.inwin_fwd_plain(table, x, bases, rows, SPEC, levels)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    gr = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    dk = se.inwin_bwd(gr, x, bases, rows, SPEC, levels, SPEC.table_size)
    dp = se.inwin_bwd_plain(gr, x, bases, rows, SPEC, levels, SPEC.table_size)
    mag = se.inwin_bwd_plain(gr.abs(), x, bases, rows, SPEC, levels,
                             SPEC.table_size)
    assert bool(((dk - dp).abs() <= 1e-5 + 1e-4 * mag).all())
    # with |g| every term is >= 0, so the same bound is the plain allclose
    mk = se.inwin_bwd(gr.abs(), x, bases, rows, SPEC, levels, SPEC.table_size)
    torch.testing.assert_close(mk, mag, atol=1e-5, rtol=1e-4)


def test_inwin_autograd_and_encode_on_card(dev):
    table, x, bases, rows, levels = _inputs(dev, levels=(0, 1, 2, 3))
    t = table.clone().requires_grad_()
    before = dict(kernels.LAUNCHES)
    feat, cnt = se.splat_encode_raw(t, x, SPEC, gather_levels=(4, 5))
    feat.square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["inwin_fwd"] == before["inwin_fwd"] + 1
    assert kernels.LAUNCHES["inwin_bwd"] == before["inwin_bwd"] + 1
    t_ref = table.clone().requires_grad_()
    ref = hashgrid_encode(t_ref, x, SPEC)
    ref.square().sum().backward()
    torch.testing.assert_close(feat, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(t.grad, t_ref.grad, atol=1e-4, rtol=1e-4)
    # the card and the CPU pick the same stochastic corners
    fs, cs = se.splat_encode_raw(table, x, SPEC, (4, 5), stochastic=True)
    fc, cc = se.splat_encode_raw(table.cpu(), x.cpu(), SPEC, (4, 5),
                                 stochastic=True)
    torch.testing.assert_close(fs.cpu(), fc, atol=1e-5, rtol=0)
    assert torch.equal(cs.cpu(), cc) and torch.equal(cnt.cpu(), cc)


WS_LEVELS = (3, 4, 5)          # the hashed levels of SPEC


def _ws_inputs(dev, n=2048, seed=0):
    """Uniform points plus 256 inside one level-5 block (a tile of the
    window-sorted order whose two clamped slots are equal) and 40 out of
    bounds (they sort last: the last tile ends with them, its last slot
    clamps from -1 to 0)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3))
    s5 = SPEC.level_scale32(5)
    x[:256] = (8 * np.array([5, 6, 7]) + rng.uniform(0.01, 7.99, (256, 3))
               - SPEC.shift) / s5
    x[-40:, 0] = 1.5
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    xc = x.clamp(0, 1).contiguous()
    oob = ((x < 0) | (x > 1)).any(-1)
    metas = [se.winsort_meta(xc, oob, SPEC, l) for l in WS_LEVELS]
    perm = torch.stack([m[0] for m in metas]).to(torch.int32).contiguous()
    wins = torch.stack([m[1] for m in metas]).contiguous()
    slots = torch.stack([m[2] for m in metas]).contiguous()
    g = torch.Generator(device="cpu").manual_seed(1)
    table = (torch.rand((SPEC.table_size, 3), generator=g) * 2 - 1).to(dev)
    return table, x, xc, perm, wins, slots


def test_winsort_kernels_match_plain(dev):
    table, _, xc, perm, wins, slots = _ws_inputs(dev)
    assert bool((slots[2, :, 0] == slots[2, :, 1]).any())   # equal slots
    assert int(wins[0, -1]) == -1 and int(slots[0, -1, 1]) == 0
    before = dict(kernels.LAUNCHES)
    out = se.winsort_fwd(table, xc, perm, wins, slots, SPEC, WS_LEVELS)
    ref = se.winsort_fwd_plain(table, xc, perm, wins, slots, SPEC, WS_LEVELS)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert float(ref.abs().max()) > 0.1
    gr = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    args = (xc, perm, wins, slots, SPEC, WS_LEVELS, SPEC.table_size)
    dk = se.winsort_bwd(gr, *args)
    dp = se.winsort_bwd_plain(gr, *args)
    mag = se.winsort_bwd_plain(gr.abs(), *args)
    assert bool(((dk - dp).abs() <= 1e-5 + 1e-4 * mag).all())
    torch.testing.assert_close(se.winsort_bwd(gr.abs(), *args), mag,
                               atol=1e-5, rtol=1e-4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["winsort_fwd"] == before["winsort_fwd"] + 1
    assert kernels.LAUNCHES["winsort_bwd"] == before["winsort_bwd"] + 2


def _assert_grad_matches(kernel, plain, gr, args):
    """kernel(g, *args) against plain(g, *args) within atol 1e-5 + rtol 1e-4
    of each row's summed |terms| (the plain gradient of |g|), for g and |g|."""
    mag = plain(gr.abs(), *args)
    assert bool(((kernel(gr, *args) - plain(gr, *args)).abs()
                 <= 1e-5 + 1e-4 * mag).all())
    torch.testing.assert_close(kernel(gr.abs(), *args), mag, atol=1e-5,
                               rtol=1e-4)


def _meta(x, levels):
    tiles = x.reshape(-1, se.TILE, 3)
    metas = [se.tile_meta(tiles, SPEC, l) for l in levels]
    return (torch.stack([m[0] for m in metas]).contiguous(),
            torch.stack([m[1] for m in metas]).contiguous())


def test_inwin_bwd_hot_spot(dev):
    """16 tiles inside one lattice cell of level 0: every lane of every warp
    adds into the same 8 rows there."""
    rng = np.random.default_rng(7)
    s0 = SPEC.level_scale32(0)
    x = ((7 + rng.uniform(0.01, 0.99, (2048, 3)) - SPEC.shift) / s0)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    levels = tuple(range(6))
    bases, rows = _meta(x, levels)
    pg = torch.floor(x * s0 + SPEC.shift)
    assert bool((pg == 7).all())
    gr = torch.randn((2048, 6, 3), generator=torch.Generator().manual_seed(8)).to(dev)
    before = kernels.LAUNCHES["inwin_bwd"]
    _assert_grad_matches(se.inwin_bwd, se.inwin_bwd_plain, gr,
                         (x, bases, rows, SPEC, levels, SPEC.table_size))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["inwin_bwd"] == before + 2


def test_inwin_bwd_tiles_share_windows(dev):
    """Consecutive morton tiles share their coarse windows, so the blocks of
    neighbouring tiles add into the same gradient chunks with their vector
    atomics; the same-window slot pair of the last tile stays."""
    table, x, bases, rows, levels = _inputs(dev, n=4096)
    gr = torch.randn((4096, 6, 3), generator=torch.Generator().manual_seed(9)).to(dev)
    args = (x, bases, rows, SPEC, levels, SPEC.table_size)
    r = se.inwin_bwd_plain(gr.abs(), *args).sum(-1).nonzero()[:, 0]
    chunks = torch.unique(torch.cat([(3 * r) >> 2, (3 * r + 2) >> 2])).numel()
    assert se.inwin_bwd_vector_adds(gr, *args[:-1]) > chunks
    _assert_grad_matches(se.inwin_bwd, se.inwin_bwd_plain, gr, args)


def test_inwin_bwd_rejects_misaligned_buffer(dev):
    """K3's launcher refuses a gradient buffer that is not 16-byte aligned
    (its vector adds need one), and kernels.check raises on its code."""
    from nerf2mesh_tpu_torch.ops.hashgrid import level_arrays
    table, x, bases, rows, levels = _inputs(dev)
    gr = torch.ones((x.shape[0], 6, 3), device=dev)
    buf = torch.zeros(SPEC.table_size * 3 + 1, device=dev)
    scales, offsets = level_arrays(SPEC, levels)
    lib = kernels.load()

    def launch(out):
        return lib.n2m_inwin_bwd(
            gr.data_ptr(), x.data_ptr(), bases.data_ptr(), rows.data_ptr(),
            scales, offsets, float(SPEC.shift), x.shape[0],
            x.shape[0] // se.TILE, len(levels), out.data_ptr(),
            kernels.current_stream_handle(dev))

    with pytest.raises(RuntimeError, match="misaligned"):
        kernels.check(lib, "n2m_inwin_bwd", launch(buf[1:]))
    kernels.check(lib, "n2m_inwin_bwd", launch(buf[:-1]))
    torch.testing.assert_close(buf[:-1].view(-1, 3),
                               se.inwin_bwd(gr, x, bases, rows, SPEC, levels,
                                            SPEC.table_size),
                               atol=1e-5, rtol=1e-4)


def _ws_meta(x):
    xc = x.clamp(0, 1).contiguous()
    oob = ((x < 0) | (x > 1)).any(-1)
    metas = [se.winsort_meta(xc, oob, SPEC, l) for l in WS_LEVELS]
    return (xc, torch.stack([m[0] for m in metas]).to(torch.int32).contiguous(),
            torch.stack([m[1] for m in metas]).contiguous(),
            torch.stack([m[2] for m in metas]).contiguous(), metas)


def _block_points(rng, l, blocks, counts):
    """counts[i] points inside 8^3 block blocks[i] of level l."""
    s = np.float32(SPEC.level_scale32(l))
    return np.concatenate([(8 * np.asarray(b) + rng.uniform(0.01, 7.99, (n, 3))
                            - SPEC.shift) / s for b, n in zip(blocks, counts)])


def test_winsort_bwd_long_run(dev):
    """One level-5 window whose run spans 16 tiles (2048 points): one owner
    block loops over it."""
    rng = np.random.default_rng(10)
    x = np.concatenate([_block_points(rng, 5, [(9, 9, 9)], [2048]),
                        rng.uniform(0, 1, (2048, 3))])
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    xc, perm, wins, slots, _ = _ws_meta(x)
    w = int(wins[2, perm[2].long().argsort()[0]])     # point 0's window
    assert int((wins[2] == w).sum()) >= 2048
    gr = torch.randn((4096, 3, 3), generator=torch.Generator().manual_seed(11)).to(dev)
    _assert_grad_matches(se.winsort_bwd, se.winsort_bwd_plain, gr,
                         (xc, perm, wins, slots, SPEC, WS_LEVELS, SPEC.table_size))


def test_winsort_bwd_points_in_one_cell(dev):
    """512 points inside one lattice cell of level 5 (and 512 uniform): at
    every winsort level each warp of their run has all its lanes in one
    cell, so it sums the cell's terms over its lanes before its shared adds."""
    rng = np.random.default_rng(14)
    s5 = np.float32(SPEC.level_scale32(5))
    x = np.concatenate([(8 * 9 + 3 + rng.uniform(0.01, 0.99, (512, 3))
                         - SPEC.shift) / s5, rng.uniform(0, 1, (512, 3))])
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    assert bool((torch.floor(x[:512] * s5 + SPEC.shift) == 75).all())
    xc, perm, wins, slots, _ = _ws_meta(x)
    gr = torch.randn((1024, 3, 3), generator=torch.Generator().manual_seed(15)).to(dev)
    _assert_grad_matches(se.winsort_bwd, se.winsort_bwd_plain, gr,
                         (xc, perm, wins, slots, SPEC, WS_LEVELS, SPEC.table_size))


def test_winsort_bwd_run_inside_one_tile(dev):
    """A level-5 window whose run lies strictly inside one tile: its points
    are not slotted and add nothing; its window stays zero."""
    from nerf2mesh_tpu_torch.ops.hashgrid import block_window
    rng = np.random.default_rng(12)
    blocks = [(3, 4, 5), (10, 11, 12), (20, 5, 7), (25, 26, 1), (2, 30, 9)]
    win = block_window(torch.tensor(blocks), SPEC, 5).tolist()
    order = sorted(range(len(blocks)), key=lambda i: win[i])[:4]
    x = _block_points(rng, 5, [blocks[i] for i in order], [40, 48, 40, 128])
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    xc, perm, wins, slots, metas = _ws_meta(x)
    wb = int(wins[2, 40])
    assert int(wins[2, 39]) < wb < int(wins[2, 88]) and int(wins[2, 87]) == wb
    assert not bool(metas[2][3][perm[2, 40:88].long()].any())
    gr = torch.randn((256, 3, 3), generator=torch.Generator().manual_seed(13)).to(dev)
    args = (xc, perm, wins, slots, SPEC, WS_LEVELS, SPEC.table_size)
    _assert_grad_matches(se.winsort_bwd, se.winsort_bwd_plain, gr, args)
    off = int(SPEC.offsets[5]) + wb * 512
    assert not se.winsort_bwd(gr, *args)[off:off + 512].any()


def test_winsort_autograd_and_encode_on_card(dev):
    table, x, _, _, _, _ = _ws_inputs(dev, seed=3)
    t = table.clone().requires_grad_()
    feat, _ = se.splat_encode_raw(t, x, SPEC, gather_levels=WS_LEVELS,
                                  winsort_levels=WS_LEVELS)
    feat.square().sum().backward()
    t_ref = table.clone().requires_grad_()
    ref = hashgrid_encode(t_ref, x, SPEC)
    ref.square().sum().backward()
    torch.testing.assert_close(feat, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(t.grad, t_ref.grad, atol=1e-4, rtol=1e-4)
    assert not feat[-40:].any()


def test_wrappers_reject_bad_inputs(dev):
    table, x, bases, rows, levels = _inputs(dev)
    with pytest.raises(ValueError):
        se.inwin_fwd(table, x, bases.cpu(), rows, SPEC, levels)
    with pytest.raises(ValueError):
        se.inwin_fwd(table.double(), x, bases, rows, SPEC, levels)
    with pytest.raises(TypeError):
        occ_sweep.occ_lookup(torch.zeros(8, dtype=torch.int32, device=dev),
                             torch.zeros(4, dtype=torch.int64, device=dev))


# the slice's ref table: levels 0-1 dense, 2-15 hashed at 2^14 rows
REF_SPEC = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=14,
                        desired_resolution=2048, layout="ref")


def _ref_points(n, seed=0):
    """Uniform points, lattice-edge points (exact and 1 ulp off) at every
    level, coordinates 0 and 1, and points just and far out of bounds."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3))
    for l in range(16):
        s = REF_SPEC.level_scale32(l)
        g = rng.integers(1, int(s), 16)
        v = ((g - 0.5) / np.float32(s)).astype(np.float32)
        v[4:10] = np.nextafter(v[4:10], np.float32(2))
        v[10:] = np.nextafter(v[10:], np.float32(-1))
        x[16 * l:16 * l + 16, l % 3] = v
    x[-6:] = rng.uniform(0, 1, (6, 3))
    x[-6, 0], x[-5, 1] = 0.0, 1.0
    x[-4, 2] = np.nextafter(np.float32(0), np.float32(-1))
    x[-3, 0] = np.nextafter(np.float32(1), np.float32(2))
    x[-2, 1], x[-1] = 1.5, 2.0
    return torch.from_numpy(x.astype(np.float32))


def test_sweep_kernel_matches_plain(dev):
    x = _ref_points(4096).to(dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    table = (torch.rand((REF_SPEC.table_size, 3), generator=g) * 2 - 1).to(dev)
    before = kernels.LAUNCHES["sweep_fwd"]
    out = pe.sweep_fwd(table, x, REF_SPEC)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sweep_fwd"] == before + 1
    ref = pe.sweep_fwd_plain(table, x, REF_SPEC)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert not out[-4:].any() and float(out[:-4].abs().max()) > 0.5


@pytest.mark.parametrize("kw", [dict(num_levels=40, log2_hashmap_size=14),
                                dict(num_levels=70, log2_hashmap_size=14),
                                dict(num_levels=6, log2_hashmap_size=12,
                                     gridtype="tiled")])
def test_sweep_kernel_level_count_and_tiled(dev, kw):
    """K4 at more levels than the 16 of the slice (70: a second launch for
    the levels past 64) and on a tiled grid, whose dense levels wrap modulo
    their size."""
    spec = HashGridSpec(**{**dict(level_dim=3, desired_resolution=2048,
                                  layout="ref"), **kw})
    x = _ref_points(4096, seed=4).to(dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    table = (torch.rand((spec.table_size, 3), generator=g) * 2 - 1).to(dev)
    torch.testing.assert_close(pe.sweep_fwd(table, x, spec),
                               pe.sweep_fwd_plain(table, x, spec),
                               atol=1e-5, rtol=0)


def test_sweep_autograd_on_card(dev):
    x = _ref_points(2048, seed=2).to(dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    table = (torch.rand((REF_SPEC.table_size, 3), generator=g) * 2 - 1).to(dev)
    t = table.clone().requires_grad_()
    before = dict(kernels.LAUNCHES)
    feat = pe.sweep_encode(t, x, REF_SPEC)
    feat.square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sweep_fwd"] == before["sweep_fwd"] + 1
    assert kernels.LAUNCHES["sweep_bwd"] == before["sweep_bwd"] + 1
    t_ref = table.clone().requires_grad_()
    ref = hashgrid_encode(t_ref, x, REF_SPEC)
    ref.square().sum().backward()
    torch.testing.assert_close(feat, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(t.grad, t_ref.grad, atol=1e-4, rtol=1e-4)


def _k4b(gr, table, x, spec):
    return pe.sweep_bwd(table, x, gr, spec, need_dx=False)[0]


def _k4b_plain(gr, table, x, spec):
    return pe.sweep_bwd_plain(table, x, gr, spec, need_dx=False)[0]


def _ref_table(spec, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.rand((spec.table_size, 3), generator=g) * 2 - 1


def test_sweep_bwd_kernel_matches_plain(dev):
    """K4b on the lattice-edge and out-of-bounds points of _ref_points; the
    out-of-bounds points add nothing."""
    x = _ref_points(4096, seed=6).to(dev)
    table = _ref_table(REF_SPEC, 7).to(dev)
    gr = torch.randn((4096, 48), generator=torch.Generator().manual_seed(8)).to(dev)
    before = kernels.LAUNCHES["sweep_bwd"]
    _assert_grad_matches(_k4b, _k4b_plain, gr, (table, x, REF_SPEC))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sweep_bwd"] == before + 2
    oob_only = gr.clone()
    oob_only[:-4] = 0
    assert not _k4b(oob_only, table, x, REF_SPEC).any()


@pytest.mark.parametrize("kw", [dict(num_levels=40, log2_hashmap_size=14),
                                dict(num_levels=70, log2_hashmap_size=14),
                                dict(num_levels=6, log2_hashmap_size=12,
                                     gridtype="tiled")])
def test_sweep_bwd_kernel_level_count_and_tiled(dev, kw):
    """K4b at 40 and 70 levels (a second launch for the levels past 64) and
    on a tiled grid, whose dense levels wrap."""
    spec = HashGridSpec(**{**dict(level_dim=3, desired_resolution=2048,
                                  layout="ref"), **kw})
    x = _ref_points(4096, seed=9).to(dev)
    gr = torch.randn((4096, spec.num_levels * 3),
                     generator=torch.Generator().manual_seed(10)).to(dev)
    _assert_grad_matches(_k4b, _k4b_plain, gr,
                         (_ref_table(spec, 11).to(dev), x, spec))


def test_sweep_bwd_hot_spot(dev):
    """2048 points inside one lattice cell of level 0: every lane of every
    warp adds into the same 8 rows there, so the warps sum over their lanes
    before the shared atomics."""
    rng = np.random.default_rng(12)
    s0 = REF_SPEC.level_scale32(0)
    x = ((7 + rng.uniform(0.01, 0.99, (2048, 3)) - REF_SPEC.shift) / s0)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    assert bool((torch.floor(x * s0 + REF_SPEC.shift) == 7).all())
    gr = torch.randn((2048, 48), generator=torch.Generator().manual_seed(13)).to(dev)
    _assert_grad_matches(_k4b, _k4b_plain, gr,
                         (_ref_table(REF_SPEC, 14).to(dev), x, REF_SPEC))


@pytest.mark.parametrize("n", [0, 1, 4096, 2 ** 18])
def test_sweep_kernels_at_sizes(dev, n):
    """K4 and K4b on no points, one point (one chunk, one partial tile), a
    late eval round's size and the training step's (one wave of chunks)."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(dev)
    table = _ref_table(REF_SPEC, 16).to(dev)
    torch.testing.assert_close(pe.sweep_fwd(table, x, REF_SPEC),
                               pe.sweep_fwd_plain(table, x, REF_SPEC),
                               atol=1e-5, rtol=0)
    gr = torch.randn((n, 48), generator=torch.Generator().manual_seed(17)).to(dev)
    _assert_grad_matches(_k4b, _k4b_plain, gr, (table, x, REF_SPEC))


def test_sweep_bwd_rejects_misaligned_buffer(dev):
    """K4b's launcher refuses a gradient buffer that is not 16-byte aligned
    (its flush adds 16-byte chunks), and kernels.check raises on its code."""
    x = _ref_points(1024, seed=18).to(dev)
    gr = torch.ones((1024, 48), device=dev)
    buf = torch.zeros(REF_SPEC.table_size * 3 + 1, device=dev)
    lib = kernels.load()

    def launch(out):
        return lib.n2m_sweep_bwd(
            gr.data_ptr(), x.data_ptr(), pe._level_records(REF_SPEC).ctypes.data,
            float(REF_SPEC.shift), 1024, 16, 1, out.data_ptr(),
            kernels.current_stream_handle(dev))

    with pytest.raises(RuntimeError, match="misaligned"):
        kernels.check(lib, "n2m_sweep_bwd", launch(buf[1:]))
    kernels.check(lib, "n2m_sweep_bwd", launch(buf[:-1]))
    table = _ref_table(REF_SPEC, 19).to(dev)
    torch.testing.assert_close(buf[:-1].view(-1, 3),
                               _k4b(gr, table, x, REF_SPEC), atol=1e-5,
                               rtol=1e-4)
