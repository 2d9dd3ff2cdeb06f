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

No path of the system runs them: chip_smoke.py launches them in its kernel
phase and holds each against its plain version (atol 1e-5).  (b) and (d)
equal K2's plain version at the level; (c) equals it with every tile's rows
(0, 1, 0, 1, 0, 1, 0, 1), since the TPU kernel reads slots s0 and s0 + 1 of
the pair (s0 = 2sy + 4sz) as windows 0 and 1.
"""

from __future__ import annotations

import torch

from .. import kernels
from .hashgrid import HashGridSpec
from .splat_encode import _check_inwin_args, inwin_fwd_plain

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


def _dense(name, table, x, bases, rows, spec, level):
    """Checks, then the plain version on the CPU or the kernel on a card;
    rows None is the constant-row probe."""
    if not 0 <= level < spec.num_levels:
        raise ValueError(f"{name}: level {level} outside the spec")
    if rows is None and int(spec.level_sizes[level]) < 1024:
        raise ValueError(f"{name}: level {level} has fewer than 2 windows")
    N, T, _ = _check_inwin_args(
        x, bases[None], (bases.new_zeros((bases.shape[0], 8)) if rows is None
                         else rows)[None], (level,))
    if table.dtype != torch.float32 or tuple(table.shape) != (
            int(spec.table_size), 3):
        raise ValueError(f"{name}: table must be float32 "
                         f"[{int(spec.table_size)}, 3]")
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
                               bases.data_ptr(), rows.data_ptr(),
                               spec.level_scale32(level),
                               int(spec.offsets[level]), float(spec.shift),
                               N, T, out.data_ptr(),
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
