"""Block512 hash encode with window kernels (port of nerf2mesh_tpu/ops/splat_encode.py).

The JAX package splits each kernel-routed level of the encode into an
*in-window* part, computed by a Pallas kernel from the 2x2x2 neighbourhood
of 8^3 table blocks around each 128-point tile's base block (`tile_meta`),
and a *residual* for the corners outside that 16^3 neighbourhood, computed
in XLA.  The port keeps that split and the routing probe (`resid_counts`)
exactly, and replaces the kernels:

  K2 ``inwin_fwd`` (csrc/splat_inwin.cu) - in-window part, read straight from
     the canonical [total, C] table (no splat-layout transpose): a thread
     block takes a tile at all its levels, a warp 32 points at one level,
     and the tile's results leave through shared memory as 16-byte stores;
  K3 ``inwin_bwd`` - its table gradient: a thread block reduces one tile's
     slot windows at one level in shared memory and adds each touched
     16-byte chunk into a zeroed [total, C] buffer with one vector atomic.

Every kernel here reads a table of C = spec.level_dim channels, C = 1, 2 or
3: the merged table (C = 3), or the separate density (C = 1) and colour
(C = 2) tables of ``NetworkSpec(separate_tables=True)``; each CUDA kernel
has one instantiation for each C, and its launch counts under its name and
under "<name>_c<C>" (kernels.count).  Any other C raises ValueError.

``_InWin`` wraps both as one autograd Function (no gradient to x).  The
residual is a masked 8-corner gather (exact mode) or the position-hashed
1-corner pick (stochastic training mode), both in PyTorch.  The JAX budget,
``jnp.nonzero`` compaction and ``lax.cond`` fallback around the exact
residual, and ``gather_rows``' per-channel scatter, were TPU workarounds
and give the same values as the masked gather.

Points are expected morton-sorted (``morton_perm``) so that tiles are local.

The *winsort* levels (exact encode of fine hashed levels, where 128-point
tiles have no spatial locality) sort the points per level by the window id
of their own 8^3 block (``winsort_meta``), so that a tile touches one or
two windows: its first and last point's, the two clamped slots.  A point
whose window is one of its tile's slots has its in-block corners computed
by a kernel; corners that cross the block edge, and points outside the
slots, ride an exact masked-gather residual.  Kernels (csrc/splat_winsort.cu):

  K5 ``winsort_fwd`` - the in-block part, [N, Lw, C] in the caller's order:
     one thread block a chunk of 4 tiles of one level stages the chunk's
     distinct slot windows in shared memory;
  K6 ``winsort_bwd`` - its table gradient: one thread block owns each
     (level, window), reduces the window's run of sorted points in shared
     memory and writes the window once, with no global atomic.

``_InWinWS`` wraps both.  The JAX residual budget and ``lax.cond``
full-gather fallback (splat_encode.py:840-865) were TPU workarounds that
give the same values as the masked gather, and are dropped.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import torch

from .. import kernels
from .hashgrid import (HashGridSpec, _MASK32, _PRIMES, block_window,
                       corner_bits, corner_weights, gather_rows, lattice,
                       level_arrays, mul32)

TILE = 128          # points per tile

_GOLDEN = 0x9E3779B9


def splat_supported(spec: HashGridSpec) -> bool:
    return (spec.layout == "block512" and spec.input_dim == 3
            and spec.interpolation == "linear")


def _check_table(name, table, x, spec):
    C = kernels.channels(spec)
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != C:
        raise ValueError(f"{name}: table must be float32 [total, {C}]")
    if table.device != x.device:
        raise ValueError(f"{name}: table and x on different devices")
    return C


def _check_grad(name, grad, x, shape):
    if grad.dtype != torch.float32 or tuple(grad.shape) != shape:
        raise ValueError(f"{name}: grad must be float32 {list(shape)}")
    if grad.device != x.device:
        raise ValueError(f"{name}: grad and x on different devices")


# ---------------------------------------------------------------------------
# per-(tile, level) window metadata
# ---------------------------------------------------------------------------

def tile_meta(x_tiles: torch.Tensor, spec: HashGridSpec, l: int):
    """Per-tile base block + the 8 neighbourhood window ids for level l.

    x_tiles: [T, TILE, 3] clipped positions in [0, 1].  Returns (base
    [T, 3] int32 block coords, rows [T, 8] int32 level-local window ids);
    slot bit order matches the corner bit order (bit0=x, bit1=y, bit2=z)."""
    pg, _ = lattice(x_tiles, spec, l)
    base = pg.amin(dim=1).to(torch.int32) >> 3                      # [T, 3]
    # slot s = sx + 2*sy + 4*sz: the same bit order as the corners
    b = base.long()[:, None, :] + corner_bits(x_tiles.device)       # [T, 8, 3]
    return base, block_window(b, spec, l).to(torch.int32)


# ---------------------------------------------------------------------------
# K2 / K3 wrappers and their plain versions
# ---------------------------------------------------------------------------

def _inwin_corners(x, bases, rows, spec, levels):
    """Plain corner walk of K2/K3: (row [N, Lk, 8] int64, w [N, Lk, 8],
    inw [N, Lk, 8] bool) with w = 0 on out-of-window corners (~inw; their
    row is then a valid dummy)."""
    corners = corner_bits(x.device)
    rows_out, w_out, inw_out = [], [], []
    for k, l in enumerate(levels):
        pg, frac = lattice(x, spec, l)
        base = bases[k].long().repeat_interleave(TILE, dim=0)       # [N, 3]
        local = pg.long()[:, None, :] + corners[None] - 8 * base[:, None, :]
        inw = ((local >= 0) & (local < 16)).all(dim=-1)             # [N, 8]
        local = local.clamp(0, 15)
        slot = (local[..., 0] >> 3) + 2 * (local[..., 1] >> 3) \
            + 4 * (local[..., 2] >> 3)
        win = torch.gather(rows[k].long().repeat_interleave(TILE, dim=0),
                           1, slot)                                 # [N, 8]
        loc = local & 7
        row = (int(spec.offsets[l]) + win * 512 + loc[..., 0]
               + 8 * loc[..., 1] + 64 * loc[..., 2])
        rows_out.append(row)
        w_out.append(torch.where(inw, corner_weights(frac), 0.0))
        inw_out.append(inw)
    return (torch.stack(rows_out, 1), torch.stack(w_out, 1),
            torch.stack(inw_out, 1))


def inwin_fwd_plain(table, x, bases, rows, spec, levels):
    """Plain version of K2: [N, Lk, C] in-window features."""
    N, Lk, C = x.shape[0], len(levels), table.shape[1]
    row, w, _ = _inwin_corners(x, bases, rows, spec, levels)
    vals = gather_rows(table, row.reshape(-1)).reshape(N, Lk, 8, C)
    return (w[..., None] * vals).sum(dim=2)


def inwin_bwd_plain(grad, x, bases, rows, spec, levels, total):
    """Plain version of K3: [total, C] table gradient of K2."""
    C = grad.shape[-1]
    row, w, _ = _inwin_corners(x, bases, rows, spec, levels)
    contrib = (grad[:, :, None, :] * w[..., None]).reshape(-1, C)
    dtab = torch.zeros((total, C), dtype=torch.float32, device=x.device)
    return dtab.index_add_(0, row.reshape(-1), contrib)


def inwin_bwd_vector_adds(grad, x, bases, rows, spec, levels) -> int:
    """The 16-byte vector adds into device memory that K3 makes for these
    inputs, counted by the plain corner walk: the distinct (thread block,
    gradient chunk) pairs over the in-window corners of points with a
    nonzero gradient, a block being one tile at one level (slots of one
    window id share a chunk in a block); a row of C floats lies in one or
    two chunks."""
    C = grad.shape[-1]
    row, _, inw = _inwin_corners(x, bases, rows, spec, levels)      # [N, Lk, 8]
    N, Lk = row.shape[:2]
    live = inw & (grad != 0).any(-1)[:, :, None]
    ar = torch.arange(N, device=x.device)
    blk = ((ar // TILE)[:, None] * Lk
           + torch.arange(Lk, device=x.device)[None, :])            # [N, Lk]
    blk = blk[:, :, None].expand_as(row)[live]
    rc = C * row[live]
    n_chunks = (int(spec.table_size) * C + 3) // 4
    keys = torch.cat([blk * n_chunks + (rc >> 2),
                      blk * n_chunks + ((rc + C - 1) >> 2)])
    return int(torch.unique(keys).numel())


def _check_inwin_args(x, bases, rows, levels):
    N, Lk = x.shape[0], len(levels)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError("inwin: x must be float32 [N, 3]")
    if N % TILE:
        raise ValueError(f"inwin: N={N} is not a multiple of {TILE}")
    T = N // TILE
    if bases.dtype != torch.int32 or tuple(bases.shape) != (Lk, T, 3):
        raise ValueError(f"inwin: bases must be int32 [{Lk}, {T}, 3]")
    if rows.dtype != torch.int32 or tuple(rows.shape) != (Lk, T, 8):
        raise ValueError(f"inwin: rows must be int32 [{Lk}, {T}, 8]")
    for t in (bases, rows):
        if t.device != x.device:
            raise ValueError("inwin: inputs on different devices")
    return N, T, Lk


def _launch_inwin(name, src, x, bases, rows, spec, levels, C, out):
    N, T, Lk = x.shape[0], x.shape[0] // TILE, len(levels)
    scales, offsets = level_arrays(spec, tuple(levels))
    lib = kernels.load()
    fn = getattr(lib, f"n2m_{name}")
    code = fn(src.data_ptr(), x.data_ptr(), bases.data_ptr(), rows.data_ptr(),
              scales, offsets, float(spec.shift), N, T, Lk, C, out.data_ptr(),
              kernels.current_stream_handle(x.device))
    kernels.check(lib, f"n2m_{name}", code)
    kernels.count(name, C)


def inwin_fwd(table, x, bases, rows, spec: HashGridSpec,
              levels: Tuple[int, ...]) -> torch.Tensor:
    """In-window features [N, Lk, C] of the kernel levels `levels`.

    table [total, C] f32 canonical block512, C = spec.level_dim in 1-3; x
    [N, 3] f32 clipped to [0, 1], N a multiple of TILE; bases/rows from
    tile_meta, stacked over `levels`.  A CPU tensor takes the plain
    version; a CUDA tensor launches K2."""
    N, T, Lk = _check_inwin_args(x, bases, rows, levels)
    C = _check_table("inwin_fwd", table, x, spec)
    if x.device.type == "cpu":
        return inwin_fwd_plain(table, x, bases, rows, spec, levels)
    if x.device.type != "cuda":
        raise RuntimeError(f"inwin_fwd: no kernel for {x.device}")
    table, x = table.contiguous(), x.contiguous()
    if x.data_ptr() % 16:           # K2 reads a tile's x as 16-byte vectors
        x = x.clone()
    bases, rows = bases.contiguous(), rows.contiguous()
    out = torch.empty((N, Lk, C), dtype=torch.float32, device=x.device)
    _launch_inwin("inwin_fwd", table, x, bases, rows, spec, levels, C, out)
    return out


def inwin_bwd(grad, x, bases, rows, spec: HashGridSpec,
              levels: Tuple[int, ...], total: int) -> torch.Tensor:
    """Table gradient [total, C] of inwin_fwd for output gradient grad
    [N, Lk, C], C = spec.level_dim.  A CPU tensor takes the plain version;
    a CUDA tensor launches K3 into a zeroed buffer."""
    N, T, Lk = _check_inwin_args(x, bases, rows, levels)
    C = kernels.channels(spec)
    _check_grad("inwin_bwd", grad, x, (N, Lk, C))
    if total != table_rows(spec):       # the kernel indexes rows by the spec
        raise ValueError(f"inwin_bwd: table of {total} rows, spec has "
                         f"{spec.table_size}")
    if x.device.type == "cpu":
        return inwin_bwd_plain(grad, x, bases, rows, spec, levels, total)
    if x.device.type != "cuda":
        raise RuntimeError(f"inwin_bwd: no kernel for {x.device}")
    grad, x = grad.contiguous(), x.contiguous()
    bases, rows = bases.contiguous(), rows.contiguous()
    dtab = torch.zeros((total, C), dtype=torch.float32, device=x.device)
    _launch_inwin("inwin_bwd", grad, x, bases, rows, spec, levels, C, dtab)
    return dtab


class _InWin(torch.autograd.Function):
    """K2 forward, K3 backward; gradient flows to the table only."""

    @staticmethod
    def forward(ctx, table, x, bases, rows, spec, levels):
        ctx.save_for_backward(x, bases, rows)
        ctx.spec, ctx.levels, ctx.total = spec, levels, table.shape[0]
        return inwin_fwd(table, x, bases, rows, spec, levels)

    @staticmethod
    def backward(ctx, g):
        x, bases, rows = ctx.saved_tensors
        dtab = inwin_bwd(g.float().contiguous(), x, bases, rows, ctx.spec,
                         ctx.levels, ctx.total)
        return dtab, None, None, None, None, None


# ---------------------------------------------------------------------------
# K5 / K6: window-sorted fine levels
# ---------------------------------------------------------------------------

def point_windows(xc: torch.Tensor, oob: torch.Tensor, spec: HashGridSpec,
                  l: int) -> torch.Tensor:
    """Level-local window id (int64) of each point's own block; -1 for
    out-of-bounds points (JAX ``_point_windows``)."""
    pg, _ = lattice(xc, spec, l)
    win = block_window(pg.long() >> 3, spec, l)
    return torch.where(oob, -1, win)


def winsort_meta(xc: torch.Tensor, oob: torch.Tensor, spec: HashGridSpec,
                 l: int):
    """Window sort of level l: (perm [N] int64 stable sort by own-block
    window id, oob points last; wins [N] int32 window ids in sorted order;
    slots [T, 2] int32 each tile's first and last window, clamped to >= 0;
    in_slot [N] bool in the input order: the point's window is one of its
    tile's clamped slots, so the kernels take its in-block corners).

    Membership is tested against the clamped slots, which the kernels match
    on, so a slot clamped from -1 to 0 never counts a point twice."""
    wp = point_windows(xc, oob, spec, l)
    key = torch.where(wp < 0, 0x7FFFFFFF, wp)
    perm = torch.argsort(key, stable=True)
    tw = wp[perm].reshape(-1, TILE)                                 # [T, TILE]
    slots = torch.stack([tw[:, 0], tw[:, -1]], 1).clamp(min=0)
    hit = (tw == slots[:, :1]) | (tw == slots[:, 1:])
    in_slot = torch.empty_like(hit.reshape(-1))
    in_slot[perm] = hit.reshape(-1)
    return (perm, tw.reshape(-1).to(torch.int32), slots.to(torch.int32),
            in_slot)


def _block_corners(x, spec, l):
    """Own-block corner walk of a level: (local [N, 8, 3] int64 in-block
    coords clamped to 7, in_block [N, 8] corners that do not cross the
    block edge, w [N, 8] trilinear weights)."""
    pg, frac = lattice(x, spec, l)
    local = (pg.long() & 7)[:, None, :] + corner_bits(x.device)[None]
    in_block = (local <= 7).all(dim=-1)
    return local.clamp(max=7), in_block, corner_weights(frac)


def _winsort_corners(x, perm, wins, slots, spec, levels):
    """Plain corner walk of K5/K6 in the caller's point order: (row [N, Lw,
    8] int64, w [N, Lw, 8]) with w = 0 on corners the kernels skip (their
    row is then a valid dummy)."""
    rows_out, w_out = [], []
    for k, l in enumerate(levels):
        p = perm[k].long()
        s = slots[k].long().repeat_interleave(TILE, dim=0)          # [N, 2]
        ws = wins[k].long()
        hit_sorted = (ws == s[:, 0]) | (ws == s[:, 1])
        hit = torch.empty_like(hit_sorted)
        hit[p] = hit_sorted
        win = torch.empty_like(ws)
        win[p] = ws
        local, in_block, w = _block_corners(x, spec, l)
        row = (int(spec.offsets[l]) + win.clamp(min=0)[:, None] * 512
               + local[..., 0] + 8 * local[..., 1] + 64 * local[..., 2])
        rows_out.append(row)
        w_out.append(torch.where(in_block & hit[:, None], w, 0.0))
    return torch.stack(rows_out, 1), torch.stack(w_out, 1)


def winsort_fwd_plain(table, x, perm, wins, slots, spec, levels):
    """Plain version of K5: [N, Lw, C] in-block features of slotted points."""
    N, Lw, C = x.shape[0], len(levels), table.shape[1]
    row, w = _winsort_corners(x, perm, wins, slots, spec, levels)
    vals = gather_rows(table, row.reshape(-1)).reshape(N, Lw, 8, C)
    return (w[..., None] * vals).sum(dim=2)


def winsort_bwd_plain(grad, x, perm, wins, slots, spec, levels, total):
    """Plain version of K6: [total, C] table gradient of K5."""
    C = grad.shape[-1]
    row, w = _winsort_corners(x, perm, wins, slots, spec, levels)
    contrib = (grad[:, :, None, :] * w[..., None]).reshape(-1, C)
    dtab = torch.zeros((total, C), dtype=torch.float32, device=x.device)
    return dtab.index_add_(0, row.reshape(-1), contrib)


@lru_cache(maxsize=64)
def table_rows(spec: HashGridSpec) -> int:
    """spec.table_size, computed once a spec (its properties recompute the
    per-level tables on every access, ~20 us: more than a small kernel)."""
    return int(spec.table_size)


@lru_cache(maxsize=64)
def max_windows(spec: HashGridSpec, levels: Tuple[int, ...]) -> int:
    """The most 512-row windows of any of the levels: K6's grid width."""
    sizes = spec.level_sizes
    return max(int(sizes[l]) // 512 for l in levels)


def _check_winsort_args(x, perm, wins, slots, spec, levels, total):
    N, Lw = x.shape[0], len(levels)
    if total != table_rows(spec):       # the kernels index rows by the spec
        raise ValueError(f"winsort: table of {total} rows, spec has "
                         f"{spec.table_size}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError("winsort: x must be float32 [N, 3]")
    if N % TILE:
        raise ValueError(f"winsort: N={N} is not a multiple of {TILE}")
    T = N // TILE
    for name, t, shape in (("perm", perm, (Lw, N)), ("wins", wins, (Lw, N)),
                           ("slots", slots, (Lw, T, 2))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"winsort: {name} must be int32 {list(shape)}")
        if t.device != x.device:
            raise ValueError("winsort: inputs on different devices")
    return N, T, Lw


def _launch_winsort(name, src, x, perm, wins, slots, spec, levels, C, out,
                    *extra):
    N, T, Lw = x.shape[0], x.shape[0] // TILE, len(levels)
    scales, offsets = level_arrays(spec, tuple(levels))
    lib = kernels.load()
    fn = getattr(lib, f"n2m_{name}")
    code = fn(src.data_ptr(), x.data_ptr(), perm.data_ptr(), wins.data_ptr(),
              slots.data_ptr(), scales, offsets, float(spec.shift), N, T, Lw,
              C, *extra, out.data_ptr(),
              kernels.current_stream_handle(x.device))
    kernels.check(lib, f"n2m_{name}", code)
    kernels.count(name, C)


def winsort_fwd(table, x, perm, wins, slots, spec: HashGridSpec,
                levels: Tuple[int, ...]) -> torch.Tensor:
    """In-block features [N, Lw, C] of the winsort levels `levels`.

    table [total, C] f32 canonical block512, C = spec.level_dim in 1-3; x
    [N, 3] f32 clipped to [0, 1] (any order, N a multiple of TILE); perm,
    wins, slots from winsort_meta, stacked over `levels` (perm and wins as
    int32).  A CPU tensor takes the plain version; a CUDA tensor launches
    K5."""
    N, T, Lw = _check_winsort_args(x, perm, wins, slots, spec, levels,
                                   table.shape[0])
    C = _check_table("winsort_fwd", table, x, spec)
    if x.device.type == "cpu":
        return winsort_fwd_plain(table, x, perm, wins, slots, spec, levels)
    if x.device.type != "cuda":
        raise RuntimeError(f"winsort_fwd: no kernel for {x.device}")
    table, x = table.contiguous(), x.contiguous()
    perm, wins, slots = perm.contiguous(), wins.contiguous(), slots.contiguous()
    out = torch.empty((N, Lw, C), dtype=torch.float32, device=x.device)
    _launch_winsort("winsort_fwd", table, x, perm, wins, slots, spec, levels,
                    C, out)
    return out


def winsort_bwd(grad, x, perm, wins, slots, spec: HashGridSpec,
                levels: Tuple[int, ...], total: int) -> torch.Tensor:
    """Table gradient [total, C] of winsort_fwd for output gradient grad
    [N, Lw, C], C = spec.level_dim.  A CPU tensor takes the plain version;
    a CUDA tensor launches K6, one thread block a (level, window), into a
    zeroed buffer."""
    N, T, Lw = _check_winsort_args(x, perm, wins, slots, spec, levels, total)
    C = kernels.channels(spec)
    _check_grad("winsort_bwd", grad, x, (N, Lw, C))
    if x.device.type == "cpu":
        return winsort_bwd_plain(grad, x, perm, wins, slots, spec, levels,
                                 total)
    if x.device.type != "cuda":
        raise RuntimeError(f"winsort_bwd: no kernel for {x.device}")
    grad, x = grad.contiguous(), x.contiguous()
    perm, wins, slots = perm.contiguous(), wins.contiguous(), slots.contiguous()
    dtab = torch.zeros((total, C), dtype=torch.float32, device=x.device)
    _launch_winsort("winsort_bwd", grad, x, perm, wins, slots, spec, levels,
                    C, dtab, max_windows(spec, tuple(levels)))
    return dtab


class _InWinWS(torch.autograd.Function):
    """K5 forward, K6 backward; gradient flows to the table only."""

    @staticmethod
    def forward(ctx, table, x, perm, wins, slots, spec, levels):
        ctx.save_for_backward(x, perm, wins, slots)
        ctx.spec, ctx.levels, ctx.total = spec, levels, table.shape[0]
        return winsort_fwd(table, x, perm, wins, slots, spec, levels)

    @staticmethod
    def backward(ctx, g):
        x, perm, wins, slots = ctx.saved_tensors
        dtab = winsort_bwd(g.float().contiguous(), x, perm, wins, slots,
                           ctx.spec, ctx.levels, ctx.total)
        return dtab, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# corner geometry + the public op
# ---------------------------------------------------------------------------

def _corner_geometry(xc, spec: HashGridSpec, bases):
    """Canonical corner indices, weights and residual weights.

    xc: [N, 3] in [0, 1]; bases: [L, T, 3] per-level tile base blocks.
    Returns (idx [N, L, 8] int64, w_all [N, L, 8], w_resid [N, L, 8] with
    in-window corners zeroed)."""
    corners = corner_bits(xc.device)
    idx_l, w_l, wr_l = [], [], []
    for l in range(spec.num_levels):
        pg, frac = lattice(xc, spec, l)
        cg = pg.long()[:, None, :] + corners[None]                  # [N, 8, 3]
        win = block_window(cg >> 3, spec, l)
        loc = cg & 7
        idx_l.append(win * 512 + loc[..., 0] + 8 * loc[..., 1]
                     + 64 * loc[..., 2] + int(spec.offsets[l]))
        w = corner_weights(frac)                                    # [N, 8]
        w_l.append(w)
        base = bases[l].long().repeat_interleave(TILE, dim=0)
        local = cg - 8 * base[:, None, :]
        inw = ((local >= 0) & (local < 16)).all(dim=-1)
        wr_l.append(torch.where(inw, 0.0, w))
    return (torch.stack(idx_l, 1), torch.stack(w_l, 1), torch.stack(wr_l, 1))


def _position_hash(xc: torch.Tensor) -> torch.Tensor:
    """uint32 xor-of-primes hash of the float32 bit patterns of xc [N, 3]."""
    xb = xc.contiguous().view(torch.int32).long() & _MASK32
    return (mul32(xb[:, 0], _PRIMES[0]) ^ mul32(xb[:, 1], _PRIMES[1])
            ^ mul32(xb[:, 2], _PRIMES[2]))


def _pick_one_corner(hsh, salt: int, w8, idx8):
    """Unbiased 1-corner estimate: pick corner k with probability w8[k] /
    sum(w8) from the position-hash draw; returns (row [N], weight sum [N])."""
    hl = hsh ^ (salt & _MASK32)
    u = ((hl >> 8) & 0xFFFF).float() / 65536.0
    # running sum in corner order (XLA's order for 8 terms); on a card this
    # beats cumsum's scan kernel on 8-wide rows ~10x
    cols = [w8[:, 0]]
    for k in range(1, 8):
        cols.append(cols[-1] + w8[:, k])
    cdf = torch.stack(cols, dim=1)
    total = cols[-1]
    k = ((u * total)[:, None] >= cdf).sum(dim=-1).clamp(max=7)
    return torch.gather(idx8, 1, k[:, None])[:, 0], total


def splat_encode_raw(table: torch.Tensor, x01: torch.Tensor,
                     spec: HashGridSpec,
                     gather_levels: Tuple[int, ...] = (),
                     stochastic: bool = False,
                     winsort_levels: Tuple[int, ...] = ()):
    """Hash encode of morton-sorted points with per-level routing.

    Levels in `gather_levels` use a plain gather (8 corners, or 1 sampled
    corner when `stochastic`), except those also in `winsort_levels`, which
    take K5/K6 for their in-block part plus an exact masked-gather residual;
    the other levels use K2/K3 for their in-window part plus a residual
    (exact masked gather, or 1 sampled out-of-window corner when
    `stochastic`).  N must be a multiple of TILE.

    Returns (feat [N, L*C], resid_counts [L] int32: per level, the number of
    out-of-window corners with nonzero weight - the trainer's routing probe;
    gather-routed levels report what their kernel residual would be).  No
    gradient flows to x01."""
    if not splat_supported(spec):
        raise ValueError("splat_encode needs a block512, 3-D, linear spec")
    kernels.channels(spec)
    x01 = x01.detach()
    N = x01.shape[0]
    if N % TILE:
        raise ValueError(f"splat_encode_raw: N={N} not a multiple of {TILE}")
    L, C = spec.num_levels, spec.level_dim
    T = N // TILE
    winsort_levels = tuple(l for l in winsort_levels if l in gather_levels)
    gather_levels = tuple(l for l in gather_levels
                          if 0 <= l < L and l not in winsort_levels)
    k_levels = tuple(l for l in range(L)
                     if l not in gather_levels and l not in winsort_levels)

    xc = x01.float().clamp(0.0, 1.0).contiguous()
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)

    tiles = xc.reshape(T, TILE, 3)
    metas = [tile_meta(tiles, spec, l) for l in range(L)]
    bases_all = torch.stack([m[0] for m in metas])                 # [L, T, 3]

    idx, w_all, w = _corner_geometry(xc, spec, bases_all)          # [N, L, 8]
    w = torch.where(oob[:, None, None], 0.0, w)
    w_all = torch.where(oob[:, None, None], 0.0, w_all)
    resid_counts = (w != 0.0).sum(dim=(0, 2)).to(torch.int32)

    by_level: Dict[int, torch.Tensor] = {}
    hsh = _position_hash(xc) if stochastic else None

    if gather_levels:
        gl = list(gather_levels)
        if stochastic:
            picks = [_pick_one_corner(hsh, l * _GOLDEN, w_all[:, l], idx[:, l])
                     for l in gl]
            rows_g = torch.stack([p[0] for p in picks], 1)          # [N, G]
            w_g = torch.stack([p[1] for p in picks], 1)
            contrib = w_g[..., None] * gather_rows(
                table, rows_g.reshape(-1)).reshape(N, len(gl), C)
        else:
            rows_g = torch.stack([idx[:, l] for l in gl], 1)        # [N, G, 8]
            w_g = torch.stack([w_all[:, l] for l in gl], 1)
            vals = gather_rows(table, rows_g.reshape(-1)).reshape(
                N, len(gl), 8, C)
            contrib = (w_g[..., None] * vals).sum(dim=2)
        for i, l in enumerate(gl):
            by_level[l] = contrib[:, i]

    if winsort_levels:
        wl = list(winsort_levels)
        metas_ws = [winsort_meta(xc, oob, spec, l) for l in wl]
        perm = torch.stack([m[0] for m in metas_ws]).to(torch.int32)
        wins = torch.stack([m[1] for m in metas_ws])
        slots = torch.stack([m[2] for m in metas_ws])
        kf = _InWinWS.apply(table, xc, perm, wins, slots, spec,
                            winsort_levels)                         # [N, Lw, C]
        # residual: corners that cross the own block's edge, and every
        # corner of a point outside its tile's slots
        w_res = []
        for i, l in enumerate(wl):
            _, in_block, _ = _block_corners(xc, spec, l)
            keep = in_block & metas_ws[i][3][:, None]
            w_res.append(torch.where(keep, 0.0, w_all[:, l]))
        idx_w = torch.stack([idx[:, l] for l in wl], 1)             # [N, Lw, 8]
        vals = gather_rows(table, idx_w.reshape(-1)).reshape(N, len(wl), 8, C)
        kf = kf + (torch.stack(w_res, 1)[..., None] * vals).sum(dim=2)
        for i, l in enumerate(wl):
            by_level[l] = kf[:, i]

    if k_levels:
        kl = list(k_levels)
        bases = torch.stack([metas[l][0] for l in kl]).contiguous()
        rows = torch.stack([metas[l][1] for l in kl]).contiguous()
        kf = _InWin.apply(table, xc, bases, rows, spec, k_levels)  # [N, Lk, C]
        if stochastic:
            picks = [_pick_one_corner(hsh, (l * _GOLDEN) ^ 0xA5A5A5A5,
                                      w[:, l], idx[:, l]) for l in kl]
            rows_r = torch.stack([p[0] for p in picks], 1)          # [N, Lk]
            w_r = torch.stack([p[1] for p in picks], 1)
            kf = kf + w_r[..., None] * gather_rows(
                table, rows_r.reshape(-1)).reshape(N, len(kl), C)
        else:
            idx_k = torch.stack([idx[:, l] for l in kl], 1)         # [N, Lk, 8]
            w_k = torch.stack([w[:, l] for l in kl], 1)
            vals = gather_rows(table, idx_k.reshape(-1)).reshape(
                N, len(kl), 8, C)
            kf = kf + (w_k[..., None] * vals).sum(dim=2)
        for i, l in enumerate(kl):
            by_level[l] = kf[:, i]

    feat = torch.stack([by_level[l] for l in range(L)], dim=1)     # [N, L, C]
    feat = torch.where(oob[:, None, None], 0.0, feat)
    return feat.reshape(N, L * C), resid_counts


def splat_encode(table, x01, spec: HashGridSpec, sort: bool = True,
                 gather_levels: Tuple[int, ...] = (),
                 stochastic: bool = False,
                 winsort_levels: Tuple[int, ...] = ()):
    """Drop-in replacement for hashgrid_encode on block512 specs: pads N to a
    TILE multiple (with out-of-bounds points) and, unless sort=False, morton
    sorts and unsorts around splat_encode_raw.  Returns (feat [N, L*C],
    resid_counts [L])."""
    N0 = x01.shape[0]
    pad = (-N0) % TILE
    xp = torch.cat([x01, x01.new_full((pad, 3), 2.0)]) if pad else x01
    if sort:
        perm, inv = morton_perm(xp)
        xp = permute(xp, perm, inv)
    feat, cnt = splat_encode_raw(table, xp, spec, gather_levels, stochastic,
                                 winsort_levels)
    if sort:
        feat = permute(feat, inv, perm)
    return feat[:N0], cnt


# ---------------------------------------------------------------------------
# morton ordering + permutation with a gather backward
# ---------------------------------------------------------------------------

def _spread3(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_perm(x01: torch.Tensor):
    """(perm, inv_perm) sorting points by fine-block (8^3-cell at 2048)
    morton id, stably (ties keep input order, as jnp.argsort).
    Out-of-[0,1] points sort to the end."""
    b = (x01.float() * 256.0).to(torch.int32).clamp(0, 255)
    key = _spread3(b[:, 0]) | (_spread3(b[:, 1]) << 1) | (_spread3(b[:, 2]) << 2)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    key = torch.where(oob, torch.full_like(key, 0x7FFFFFFF), key)
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return perm, inv


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g[inv_perm], None, None


def permute(x: torch.Tensor, perm: torch.Tensor, inv_perm: torch.Tensor):
    """out[i] = x[perm[i]]; the backward is a gather by inv_perm, not a
    scatter-add."""
    return _Permute.apply(x, perm, inv_perm)
