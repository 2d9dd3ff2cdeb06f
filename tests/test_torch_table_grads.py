"""The host side of the table-gradient kernels K3 (``inwin_bwd``) and K6
(``winsort_bwd``), and the launch plan of K5 (``winsort_fwd``), on the CPU at
a small size (6 levels, 2^14 tables, resolution 256).

K3 reduces one tile's slot windows at one level in shared memory and adds
each touched 16-byte gradient chunk into device memory once;
``inwin_bwd_vector_adds`` counts those adds with the plain corner walk, and
is held here to a count written straight from the K2 contract in numpy.  K6 gives each (level, window) one owner block that
walks the window's run of the window-sorted points: the runs of slotted
points must be contiguous, and a numpy walk of the runs as the kernel walks
them must give the plain gradient (atol 1e-6: the same terms in another
order).  K5 gives each chunk of 4 consecutive tiles of a level one block,
which stages the chunk's distinct slot windows: a numpy walk of that plan
must stage at most 8 windows a chunk, find every slotted point's window
among them, cover every sorted point once and give the plain output (atol
1e-6).  The wrapper's argument checks run here too; the kernels themselves,
and the launcher's alignment check, are tested on a card
(tests/test_torch_kernels.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf2mesh_tpu_torch.ops import splat_encode as se
from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec, block_window

SPEC = HashGridSpec(num_levels=6, level_dim=3, log2_hashmap_size=14,
                    desired_resolution=256, layout="block512")
LEVELS = tuple(range(6))
WS_LEVELS = (3, 4, 5)          # the hashed levels of SPEC


def _clustered(n, seed=0):
    """Morton-sorted points around 4 centres (neighbouring tiles share their
    coarse windows) and a quarter uniform."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (4, 3))
    h = 3 * n // 4
    pts = np.concatenate([c[rng.integers(0, 4, h)] + rng.uniform(0, 0.05, (h, 3)),
                          rng.uniform(0, 1, (n - h, 3))])
    x = torch.from_numpy(np.clip(pts, 0, 1).astype(np.float32))
    perm, _ = se.morton_perm(x)
    return x[perm].contiguous()


def _inwin_inputs(n=1024, seed=0, kind="clustered"):
    """Morton-sorted points (clustered, uniform, or all inside one lattice
    cell of level 0, where every lane adds into the same 8 rows), their
    tile metadata and a gradient that is zero on every 7th point."""
    if kind == "clustered":
        x = _clustered(n, seed)
    else:
        rng = np.random.default_rng(seed)
        if kind == "uniform":
            pts = rng.uniform(0, 1, (n, 3))
        else:                                               # hot_spot
            s0 = SPEC.level_scale32(0)
            pts = (7 + rng.uniform(0.01, 0.99, (n, 3)) - SPEC.shift) / s0
        x = torch.from_numpy(pts.astype(np.float32))
        x = x[se.morton_perm(x)[0]].contiguous()
    tiles = x.reshape(-1, se.TILE, 3)
    metas = [se.tile_meta(tiles, SPEC, l) for l in LEVELS]
    bases = torch.stack([m[0] for m in metas]).contiguous()
    rows = torch.stack([m[1] for m in metas]).contiguous()
    g = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(n, len(LEVELS), 3)).astype(np.float32))
    g[::7] = 0.0                               # points that add nothing
    return g, x, bases, rows


def _count_from_contract(g, x, bases, rows):
    """K3's vector adds, from the K2 contract: per block (one tile at one
    level) the distinct 16-byte chunks of the rows its in-window corners of
    points with a nonzero gradient land on."""
    g, x = g.numpy(), x.numpy()
    bases, rows = bases.numpy(), rows.numpy()
    seen = set()
    for k, l in enumerate(LEVELS):
        s, off = np.float32(SPEC.level_scale32(l)), int(SPEC.offsets[l])
        pos = (x * s).astype(np.float32) + np.float32(SPEC.shift)
        pg = np.floor(pos).astype(np.int64)
        for p in range(x.shape[0]):
            if not g[p, k].any():
                continue
            t = p // se.TILE
            for c in range(8):
                loc = pg[p] + [(c >> d) & 1 for d in range(3)] - 8 * bases[k, t]
                if (loc < 0).any() or (loc >= 16).any():
                    continue
                slot = (loc[0] >> 3) + 2 * (loc[1] >> 3) + 4 * (loc[2] >> 3)
                row = (off + int(rows[k, t, slot]) * 512 + (loc[0] & 7)
                       + 8 * (loc[1] & 7) + 64 * (loc[2] & 7))
                for f in (3 * row, 3 * row + 2):
                    seen.add((t, k, f // 4))
    return len(seen)


@pytest.mark.parametrize("kind", ["clustered", "uniform", "hot_spot"])
def test_vector_add_count_matches_the_contract(kind):
    g, x, bases, rows = _inwin_inputs(n=512, kind=kind)
    got = se.inwin_bwd_vector_adds(g, x, bases, rows, SPEC, LEVELS)
    assert got == _count_from_contract(g, x, bases, rows)


def test_vector_adds_are_far_fewer_than_scalar_atomics():
    """A tile's corners land on few chunks of its slot windows, so the
    vector adds are far fewer than the scalar atomics they replace (3 a
    corner); on the hot spot each block adds the same few chunks."""
    g, x, bases, rows = _inwin_inputs()
    n = se.inwin_bwd_vector_adds(g, x, bases, rows, SPEC, LEVELS)
    _, w, inw = se._inwin_corners(x, bases, rows, SPEC, LEVELS)
    scalar = 3 * int((inw & (g != 0).any(-1)[..., None]).sum())
    assert n < scalar / 4
    g, x, bases, rows = _inwin_inputs(n=256, kind="hot_spot")
    # level 0: cell 7 straddles the blocks, so its 8 rows lie in the 8 slot
    # windows, 1 or 2 chunks each: 8 to 16 chunks for each of the 2 blocks
    n0 = se.inwin_bwd_vector_adds(g[:, :1], x, bases[:1], rows[:1], SPEC, (0,))
    assert 2 * 8 <= n0 <= 2 * 16


def test_inwin_bwd_checks_on_cpu():
    g, x, bases, rows = _inwin_inputs(n=256)
    plain = se.inwin_bwd_plain(g, x, bases, rows, SPEC, LEVELS,
                               SPEC.table_size)
    torch.testing.assert_close(
        se.inwin_bwd(g, x, bases, rows, SPEC, LEVELS, SPEC.table_size),
        plain, atol=0, rtol=0)
    with pytest.raises(ValueError):                     # rows != the spec's
        se.inwin_bwd(g, x, bases, rows, SPEC, LEVELS, SPEC.table_size - 512)
    with pytest.raises(ValueError):
        se.inwin_bwd(g.double(), x, bases, rows, SPEC, LEVELS, SPEC.table_size)
    with pytest.raises(ValueError):
        se.inwin_bwd(g[:, :5], x, bases, rows, SPEC, LEVELS, SPEC.table_size)
    with pytest.raises(RuntimeError):                   # no kernel there
        se.inwin_bwd(g.to("meta"), x.to("meta"), bases.to("meta"),
                     rows.to("meta"), SPEC, LEVELS, SPEC.table_size)


def test_max_windows():
    assert se.table_rows(SPEC) == SPEC.table_size
    assert se.max_windows(SPEC, (0,)) == 27
    assert se.max_windows(SPEC, WS_LEVELS) == 32
    assert se.max_windows(SPEC, LEVELS) == int(SPEC.level_sizes.max()) // 512


def _block_points(rng, l, blocks, counts):
    """counts[i] points inside 8^3 block blocks[i] of level l."""
    s = np.float32(SPEC.level_scale32(l))
    pts = [(8 * np.asarray(b) + rng.uniform(0.01, 7.99, (n, 3)) - SPEC.shift) / s
           for b, n in zip(blocks, counts)]
    return np.concatenate(pts)


def _window_zero_block(l):
    """An 8^3 block of level l, off the grid's faces, whose window id is 0."""
    ax = torch.arange(1, int(SPEC.block_counts[l]) - 1)
    b = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    return tuple(b[(block_window(b, SPEC, l) == 0).nonzero()[0, 0]].tolist())


def _ws_case(name):
    """Window-sorted inputs: uniform points with out-of-bounds ones (the -1
    tail) and a tile with equal slots; a window whose run spans 16 tiles; a
    window whose run lies strictly inside one tile; 16 tight clusters; only
    out-of-bounds points (every slot clamps to 0); or a clamped tail: the
    last tile's last slot clamps from -1 to 0 while window 0 is a real
    window of level 5 whose run reaches into that tile."""
    rng = np.random.default_rng(5)
    if name == "uniform":
        x = rng.uniform(0, 1, (1024, 3))
        x[:256] = _block_points(rng, 5, [(5, 6, 7)], [256])
        x[-40:, 0] = 1.5
    elif name == "long_run":
        x = np.concatenate([_block_points(rng, 5, [(9, 9, 9)], [2048]),
                            rng.uniform(0, 1, (512, 3))])
    elif name == "clusters":
        c = rng.uniform(0.2, 0.8, (16, 3))
        x = np.clip(c[rng.integers(0, 16, 1024)]
                    + rng.normal(0, 0.002, (1024, 3)), 0, 1)
    elif name == "all_oob":
        x = rng.uniform(0, 1, (512, 3))
        x[:, 1] = -0.5
    elif name == "clamped_tail":
        x = np.concatenate([_block_points(rng, 5, [_window_zero_block(5)], [140]),
                            rng.uniform(0, 1, (100, 3)), np.full((16, 3), 2.0)])
    else:                                    # inside_one_tile
        blocks = [(3, 4, 5), (10, 11, 12), (20, 5, 7), (25, 26, 1), (2, 30, 9)]
        win = block_window(torch.tensor(blocks), SPEC, 5).tolist()
        order = sorted(range(len(blocks)), key=lambda i: win[i])[:4]
        assert len({win[i] for i in order}) == 4
        x = _block_points(rng, 5, [blocks[i] for i in order], [40, 48, 40, 128])
    x = torch.from_numpy(x.astype(np.float32))
    xc = x.clamp(0, 1).contiguous()
    oob = ((x < 0) | (x > 1)).any(-1)
    metas = [se.winsort_meta(xc, oob, SPEC, l) for l in WS_LEVELS]
    perm = torch.stack([m[0] for m in metas]).to(torch.int32)
    wins = torch.stack([m[1] for m in metas])
    slots = torch.stack([m[2] for m in metas])
    return xc, perm, wins, slots, metas


def _runs(wk):
    """{window id: (lo, hi)} of the ascending window ids wk, -1 excluded."""
    ids, counts = torch.unique_consecutive(wk, return_counts=True)
    ends = torch.cumsum(counts, 0)
    return {int(w): (int(e - c), int(e)) for w, c, e in zip(ids, counts, ends)
            if int(w) >= 0}


@pytest.mark.parametrize("case", ["uniform", "long_run", "inside_one_tile"])
def test_winsort_slotted_points_of_a_window_are_its_whole_run(case):
    """K6's ownership argument: per level the window ids ascend with the -1
    tail last, each id is one run, and a run's points are either all
    slotted or, when the run lies strictly inside one tile, none is."""
    xc, perm, wins, slots, _ = _ws_case(case)
    T = slots.shape[1]
    for k in range(len(WS_LEVELS)):
        wk = wins[k]
        live = wk[wk >= 0]
        assert bool((live[1:] >= live[:-1]).all())
        assert bool((wk[len(live):] == -1).all())
        s = slots[k].long().repeat_interleave(se.TILE, 0)
        hit = (wk == s[:, 0]) | (wk == s[:, 1])
        runs = _runs(wk)
        assert sum(hi - lo for lo, hi in runs.values()) == len(live)
        for w, (lo, hi) in runs.items():
            h = hit[lo:hi]
            inside = lo % se.TILE != 0 and (hi - 1) % se.TILE != se.TILE - 1 \
                and lo // se.TILE == (hi - 1) // se.TILE
            assert bool(h.all()) != inside and not (inside and bool(h.any()))
        assert not bool(hit[len(live):].any())
    if case == "long_run":                  # level 5: 2048 points, 16+ tiles
        lo, hi = max(_runs(wins[2]).values(), key=lambda r: r[1] - r[0])
        assert hi - lo >= 2048 and (hi - 1) // se.TILE - lo // se.TILE >= 16
    if case == "inside_one_tile":           # level 5: the 2nd window's run
        runs = sorted(_runs(wins[2]).values())
        assert runs[1] == (40, 88) and T == 2


def _block_run(wk, w, threads=256):
    """K6's block_run in numpy: [lo, hi) of window w's run in the ascending
    window ids wk (the -1 tail as the largest uint32 key), both ends found
    by a `threads`-ary search; checks that each round's tests below the
    target are a prefix of the threads (what __syncthreads_count relies on)."""
    key = wk.astype(np.int64) & 0xFFFFFFFF
    lo, hi, target = [0, 0], [len(wk)] * 2, [w, w + 1]
    while hi[0] > lo[0] or hi[1] > lo[1]:
        for e in (0, 1):
            if hi[e] <= lo[e]:
                continue
            step = -(-(hi[e] - lo[e]) // threads)
            j = lo[e] + (np.arange(threads) + 1) * step - 1
            below = (j < hi[e]) & (key[np.minimum(j, len(wk) - 1)] < target[e])
            c = int(below.sum())
            assert below[:c].all()
            lo[e], hi[e] = lo[e] + c * step, min(hi[e], lo[e] + (c + 1) * step - 1)
    return lo[0], lo[1]


@pytest.mark.parametrize("threads", [256, 4])
def test_block_run_finds_each_window_run(threads):
    """The block-wide search K6 uses gives each window's run exactly, on the
    winsort inputs and on edge cases: an empty level, all out of bounds, a
    window only at the ends, 2^18 ids with a -1 tail."""
    rng = np.random.default_rng(3)
    big = np.sort(rng.integers(0, 1024, 2 ** 18 - 100)).astype(np.int32)
    arrays = [np.zeros(0, np.int32), np.full(7, -1, np.int32),
              np.array([0, 0, 5, 9, 9, -1], np.int32),
              np.concatenate([big, np.full(100, -1, np.int32)])]
    for case in ("uniform", "long_run", "inside_one_tile"):
        arrays += list(_ws_case(case)[2].numpy())
    for wk in arrays:
        key = wk.astype(np.int64) & 0xFFFFFFFF
        ws = set(range(0, 12)) | set(int(v) for v in wk[:50]) | {1023, 1024}
        if len(wk) > 1000:
            ws |= set(int(v) for v in rng.choice(wk[wk >= 0], 20))
        for w in ws:
            want = tuple(int(v) for v in np.searchsorted(key, [w, w + 1]))
            assert _block_run(wk, w, threads) == want, (w, len(wk))


def _winsort_bwd_by_owner(grad, xc, perm, wins, slots):
    """K6's walk in numpy: for each (level, window) the run found by
    _block_run, the slotted points of the run, their in-block corners added
    into the window."""
    x, grad = xc.numpy(), grad.numpy()
    dtab = np.zeros((SPEC.table_size, 3), np.float32)
    for k, l in enumerate(WS_LEVELS):
        wk = wins[k].numpy()
        s, off = np.float32(SPEC.level_scale32(l)), int(SPEC.offsets[l])
        for w in range(se.max_windows(SPEC, WS_LEVELS)):
            lo, hi = _block_run(wk, w)
            win = np.zeros((512, 3), np.float32)
            for i in range(lo, hi):
                t = i // se.TILE
                if w not in slots[k, t].tolist():
                    continue
                p = int(perm[k, i])
                pos = (x[p] * s).astype(np.float32) + np.float32(SPEC.shift)
                pg = np.floor(pos)
                fr, lg = pos - pg, pg.astype(np.int64) & 7
                for c in range(8):
                    bit = np.array([(c >> d) & 1 for d in range(3)])
                    loc = lg + bit
                    if (loc > 7).any():
                        continue
                    wt = np.prod(np.where(bit == 1, fr, 1 - fr))
                    win[loc[0] + 8 * loc[1] + 64 * loc[2]] += grad[p, k] * wt
            if hi > lo:
                dtab[off + w * 512:off + (w + 1) * 512] = win
    return torch.from_numpy(dtab)


@pytest.mark.parametrize("case", ["uniform", "long_run", "inside_one_tile"])
def test_winsort_owner_walk_gives_the_plain_gradient(case):
    xc, perm, wins, slots, metas = _ws_case(case)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(xc.shape[0], len(WS_LEVELS), 3)).astype(np.float32))
    plain = se.winsort_bwd(g, xc, perm, wins, slots, SPEC, WS_LEVELS,
                           SPEC.table_size)
    got = _winsort_bwd_by_owner(g, xc, perm, wins, slots)
    torch.testing.assert_close(got, plain, atol=1e-6, rtol=0)
    if case == "inside_one_tile":   # the unslotted run adds nothing
        wb = int(wins[2, 40])
        assert not bool(metas[2][3][perm[2, 40:88].long()].any())
        off = int(SPEC.offsets[5]) + wb * 512
        assert not plain[off:off + 512].any()


def _k5_tiles():
    """Tiles a K5 block: kWsFwdTiles in the kernel's source."""
    src = (Path(se.__file__).resolve().parent.parent / "csrc"
           / "splat_winsort.cu").read_text()
    return int(re.search(r"constexpr int kWsFwdTiles = (\d+);", src).group(1))


def _stage(v):
    """K5's warp-0 dedupe of a chunk's slots v (tile-major): (the distinct
    windows in order of first appearance, each slot's index among them)."""
    first = [j for j in range(len(v)) if v[j] not in v[:j]]
    staged = [int(v[j]) for j in first]
    return staged, [staged.index(int(s)) for s in v]


def _winsort_fwd_by_plan(table, xc, perm, wins, slots, levels):
    """K5's launch plan in numpy: one block a (chunk of C tiles, level)
    stages the chunk's distinct slot windows and sums each slotted point's
    in-block corners from them, writing out[perm[i], k].  Checks the plan's
    invariants on the way; returns (out, most windows a chunk staged)."""
    C = _k5_tiles()
    x, tab = xc.numpy(), table.numpy()
    N, T = x.shape[0], slots.shape[1]
    out = np.full((N, len(levels), 3), np.nan, np.float32)
    most = 0
    for k, l in enumerate(levels):
        s, off = np.float32(SPEC.level_scale32(l)), int(SPEC.offsets[l])
        wk, sk, pk = wins[k].numpy(), slots[k].numpy(), perm[k].numpy()
        covered = np.zeros(N, int)
        for t0 in range(0, T, C):                       # the grid's x
            nt = min(C, T - t0)
            staged, idx = _stage(list(sk[t0:t0 + nt].reshape(-1)))
            assert len(staged) <= 2 * C
            most = max(most, len(staged))
            win_rows = [tab[off + w * 512:off + (w + 1) * 512] for w in staged]
            for j in range(nt * se.TILE):
                i, lt = t0 * se.TILE + j, j // se.TILE
                covered[i] += 1
                u0, u1 = idx[2 * lt], idx[2 * lt + 1]
                u = u0 if wk[i] == staged[u0] else u1 if wk[i] == staged[u1] else -1
                assert (u >= 0) == (wk[i] in sk[t0 + lt])   # slotted <=> staged
                acc = np.zeros(3, np.float32)
                if u >= 0:
                    pos = (x[pk[i]] * s).astype(np.float32) + np.float32(SPEC.shift)
                    pg = np.floor(pos)
                    fr, lg = pos - pg, pg.astype(np.int64) & 7
                    for c in range(8):
                        bit = np.array([(c >> d) & 1 for d in range(3)])
                        loc = lg + bit
                        if (loc <= 7).all():
                            wt = np.prod(np.where(bit == 1, fr, 1 - fr))
                            acc += wt * win_rows[u][loc[0] + 8 * loc[1] + 64 * loc[2]]
                out[pk[i], k] = acc
        assert (covered == 1).all()
    return torch.from_numpy(out), most


@pytest.mark.parametrize("case", ["uniform", "clusters", "all_oob",
                                  "clamped_tail"])
def test_winsort_fwd_plan_stages_every_slotted_window(case):
    """K5's plan on uniform (with an oob tail), clustered, all-oob and
    clamped-tail inputs: at most 2C windows a chunk, every slotted point's
    window among its chunk's staged ones, every sorted point once, and the
    plain output."""
    xc, perm, wins, slots, _ = _ws_case(case)
    table = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, (SPEC.table_size, 3)).astype(np.float32))
    got, most = _winsort_fwd_by_plan(table, xc, perm, wins, slots, WS_LEVELS)
    want = se.winsort_fwd(table, xc, perm, wins, slots, SPEC, WS_LEVELS)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert 1 <= most <= 2 * _k5_tiles()
    if case == "all_oob":                    # every slot clamps to window 0
        assert bool((wins == -1).all()) and bool((slots == 0).all())
        assert most == 1 and not want.any()
    if case == "clamped_tail":               # level 5: tile 1 is (0, 0)
        assert slots[2, -1].tolist() == [0, 0] and int(wins[2, -1]) == -1
        assert int((wins[2] == 0).sum()) >= 140
        assert bool(want[perm[2, 128:140].long(), 2].any())
