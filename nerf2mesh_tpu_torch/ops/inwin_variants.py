"""K7: the TPU's timing variants of K2's dense window contraction, as
Hopper kernels (csrc/inwin_dense.cu) beside their plain PyTorch versions.

Counterpart of workspace/ab/microbench_kernel_variants.py, whose three
Pallas kernels time K2's MXU formulation (`_fwd_kernel`) at one level of
the block512 table: `_kern_b`, one deep [48, 256] x [256, 128] product a
tile; `_kern_c`, the constant-row probe, where every slot pair reads
windows 0 and 1; `_kern_d`, the 4-product form with 4 tiles a grid step.
Each kernel here computes what its TPU kernel computes, K2's in-window
features [N, 1, 3] of one level, through the same dense contraction:

  inwin_dense_deep        (b) one K=256 accumulation a tile;
  inwin_dense_const_rows  (c) windows 0 and 1 for every pair (no rows);
  inwin_dense_four_tiles  (d) 4 products of K=64 summed apart, 4 tiles a
                          block.

The kernels run the product on the tensor cores (wgmma) as three tf32
products of split operands (3xTF32).  No path of the system runs them:
chip_smoke.py launches them in its kernel phase and holds each against its
plain version (atol 1e-5).  (b) and (d) equal K2's plain version at the
level; (c) equals it with every tile's rows (0, 1, 0, 1, 0, 1, 0, 1), since
the TPU kernel reads slots s0 and s0 + 1 of the pair (s0 = 2sy + 4sz) as
windows 0 and 1.  ``dense_operands`` builds the product's operands in
plain PyTorch, as the kernels lay them out, and ``dense_features`` applies
the x contraction to a product of them.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import kernels
from .hashgrid import HashGridSpec, lattice, level_arrays
from .splat_encode import TILE, _check_inwin_args, inwin_fwd_plain

VARIANTS = {"inwin_dense_deep": 0, "inwin_dense_const_rows": 1,
            "inwin_dense_four_tiles": 2}


def const_rows(n_tiles: int, device=None) -> torch.Tensor:
    """[n_tiles, 8] int32 rows of the constant-row probe: slot s reads
    window s & 1."""
    return torch.tensor([0, 1] * 4, dtype=torch.int32,
                        device=device).repeat(n_tiles, 1)


def inwin_dense_plain(table, x, bases, rows, spec: HashGridSpec,
                      level: int) -> torch.Tensor:
    """Plain version of K7b and K7d: K2's plain in-window features [N, 1, 3]
    of one level, bases [T, 3] and rows [T, 8] from tile_meta."""
    return inwin_fwd_plain(table, x, bases[None], rows[None], spec, (level,))


def inwin_dense_const_rows_plain(table, x, bases, spec: HashGridSpec,
                                 level: int) -> torch.Tensor:
    """Plain version of K7c: inwin_dense_plain with const_rows."""
    return inwin_dense_plain(table, x, bases,
                             const_rows(bases.shape[0], x.device), spec, level)


def dense_operands(table, x, bases, rows, spec: HashGridSpec, level: int):
    """K7's product a tile in plain PyTorch, laid out as its kernels lay it
    out: (weights [T, 128, 256], windows [T, 256, 48], wx [N, 48]).  Row k =
    64q + y + 8z of slot pair q = 2sy + sz and column m = 24sx + 8c + x:
    weights[t, j, k] = wy(y + 8sy) * wz(z + 8sz) of point j of tile t,
    windows[t, k, m] = channel c of cell (x, y, z) of the window of slot
    sx + 2sy + 4sz, wx[p, m] = wx(x + 8sx) of point p, with w(X) = 1 - f at
    the point's tile-local floor, f one row above, 0 elsewhere.  rows [T, 8]
    from tile_meta, or const_rows for the constant-row probe."""
    T, N = bases.shape[0], x.shape[0]
    pg, fr = lattice(x, spec, level)
    lg = pg.long() - 8 * bases.long().repeat_interleave(TILE, dim=0)
    X = torch.arange(16, device=x.device)
    aw = torch.where(X == lg[..., None], 1.0 - fr[..., None],
                     torch.where(X == lg[..., None] + 1, fr[..., None], 0.0))
    wy = aw[:, 1].reshape(N, 2, 1, 1, 8)                   # [N, sy, ., ., y]
    wz = aw[:, 2].reshape(N, 1, 2, 8, 1)                   # [N, ., sz, z, .]
    weights = (wy * wz).reshape(T, TILE, 256)
    win = (int(spec.offsets[level]) + 512 * rows.long()[..., None]
           + torch.arange(512, device=x.device))           # [T, 8, 512]
    vals = table.index_select(0, win.reshape(-1))
    # [T, sz, sy, sx, z, y, x, c] -> [T, (sy, sz, z, y), (sx, c, x)]
    windows = (vals.reshape(T, 2, 2, 2, 8, 8, 8, 3)
               .permute(0, 2, 1, 4, 5, 3, 7, 6).reshape(T, 256, 48))
    wx = aw[:, 0].reshape(N, 2, 1, 8).expand(N, 2, 3, 8).reshape(N, 48)
    return weights, windows, wx


def dense_features(product, wx) -> torch.Tensor:
    """The x contraction of K7's product [T, 128, 48] (weights @ windows):
    in-window features [N, 1, 3]."""
    N = wx.shape[0]
    per_x = (product.reshape(N, 48) * wx).reshape(N, 2, 3, 8)
    return per_x.sum((1, 3))[:, None]


@lru_cache(maxsize=64)
def _launch_consts(spec: HashGridSpec, level: int):
    """(lattice scale, first row, rows of the level, rows of the table),
    once a (spec, level): the spec's properties recompute their tables on
    every access, which took longer than the kernel."""
    scales, offsets = level_arrays(spec, (level,))
    return (scales[0], offsets[0], int(spec.level_sizes[level]),
            int(spec.table_size))


def _dense(name, table, x, bases, rows, spec, level):
    """Checks, then the plain version on the CPU or the kernel on a card;
    rows None is the constant-row probe."""
    if not 0 <= level < spec.num_levels:
        raise ValueError(f"{name}: level {level} outside the spec")
    scale, offset, level_rows, total = _launch_consts(spec, level)
    if rows is None and level_rows < 1024:
        raise ValueError(f"{name}: level {level} has fewer than 2 windows")
    # (c) reads no rows: an unfilled [T, 8] view stands in for the checks
    N, T, _ = _check_inwin_args(
        x, bases[None], (bases.new_empty(()).expand(bases.shape[0], 8)
                         if rows is None else rows)[None], (level,))
    if table.dtype != torch.float32 or tuple(table.shape) != (total, 3):
        raise ValueError(f"{name}: table must be float32 [{total}, 3]")
    if table.device != x.device:
        raise ValueError(f"{name}: table and x on different devices")
    if x.device.type == "cpu":
        if rows is None:
            return inwin_dense_const_rows_plain(table, x, bases, spec, level)
        return inwin_dense_plain(table, x, bases, rows, spec, level)
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {x.device}")
    table, x, bases = table.contiguous(), x.contiguous(), bases.contiguous()
    rows = bases if rows is None else rows.contiguous()   # (c) reads none
    out = torch.empty((N, 1, 3), dtype=torch.float32, device=x.device)
    lib = kernels.load()
    code = lib.n2m_inwin_dense(VARIANTS[name], table.data_ptr(), x.data_ptr(),
                               bases.data_ptr(), rows.data_ptr(), scale,
                               offset, float(spec.shift), N, T, out.data_ptr(),
                               kernels.current_stream_handle(x.device))
    kernels.check(lib, "n2m_inwin_dense", code)
    kernels.LAUNCHES[name] += 1
    return out


def inwin_dense_deep(table, x, bases, rows, spec: HashGridSpec,
                     level: int) -> torch.Tensor:
    """K7b: in-window features [N, 1, 3] of `level` by one deep product a
    tile.  table [total, 3] f32 canonical block512; x [N, 3] f32 clipped to
    [0, 1], morton-sorted, N a multiple of 128; bases [T, 3] and rows
    [T, 8] int32 from tile_meta at `level`.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    return _dense("inwin_dense_deep", table, x, bases, rows, spec, level)


def inwin_dense_four_tiles(table, x, bases, rows, spec: HashGridSpec,
                           level: int) -> torch.Tensor:
    """K7d: as inwin_dense_deep, by 4 products of K=64 a tile summed apart,
    4 tiles a block."""
    return _dense("inwin_dense_four_tiles", table, x, bases, rows, spec, level)


def inwin_dense_const_rows(table, x, bases, spec: HashGridSpec,
                           level: int) -> torch.Tensor:
    """K7c: as inwin_dense_four_tiles (one tile a block), every slot pair
    reading windows 0 and 1 of the level in place of the tile's rows (the
    level needs 2 windows)."""
    return _dense("inwin_dense_const_rows", table, x, bases, None, spec, level)
