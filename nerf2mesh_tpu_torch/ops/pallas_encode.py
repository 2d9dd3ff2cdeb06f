"""Small-table hash encode of the "ref" layout: kernels K4 (forward) and
K4b (table gradient), csrc/sweep_encode.cu, and their plain PyTorch
versions.  Port of nerf2mesh_tpu/ops/pallas_encode.py.

``sweep_encode(table, x01, spec)`` is hashgrid_encode without the max_level
mask on qualifying specs (``sweep_supported``, the JAX gate: ref layout,
3-D, linear, at most 2^14 rows a level).  K4 and K4b read and write a
table of C = spec.level_dim channels, C = 1, 2 or 3 (the separate density
and colour tables, or the merged one), with one instantiation of each
kernel for each C; any other level_dim raises ValueError.  Each wrapper
launches its kernel for a CUDA tensor and takes the plain version for a
CPU tensor: the forward's a per-level 8-corner gather, the backward's the
JAX package's ``_sweep_bwd`` (XLA there, its table gradient an
``index_add_`` here).  The input gradient dx stays plain PyTorch on every
device and is computed only when x01 needs it.  The TPU kernel read a
padded channel-major [L*C, S] copy of the table (``pad_table``, a VMEM
layout); the port reads the canonical ragged [total, C] table through the
ref indices of ``hashgrid._corner_indices``, one level's slice at a time in
a thread block's shared memory.  There is no backend gate: the spec and
the tensor's device decide.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .hashgrid import (HashGridSpec, _corner_indices, corner_bits,
                       gather_rows, lattice, level_arrays)

MAX_SWEEP_SIZE = 2 ** 14


def sweep_supported(spec: HashGridSpec) -> bool:
    return (spec.layout == "ref" and spec.input_dim == 3
            and spec.interpolation == "linear"
            and 2 ** spec.log2_hashmap_size <= MAX_SWEEP_SIZE)


def _sweep_corners(x01: torch.Tensor, spec: HashGridSpec):
    """The 8-corner walk of every level: (idx [N, L, 8] int64 table rows,
    per_dim [N, L, 8, 3] per-axis weights, w [N, L, 8] trilinear weights
    zeroed for out-of-bounds points, oob [N])."""
    x = x01.float()
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    pg, frac = (torch.stack(t, dim=1) for t in zip(
        *[lattice(x, spec, l) for l in range(spec.num_levels)]))    # [N, L, 3]
    bits = corner_bits(x.device)                                    # [8, 3]
    idx = _corner_indices(pg.long()[:, :, None, :] + bits, spec)    # [N, L, 8]
    f = frac[:, :, None, :]
    per_dim = torch.where(bits.bool(), f, 1.0 - f)                  # [N,L,8,3]
    w = per_dim[..., 0] * per_dim[..., 1] * per_dim[..., 2]
    return idx, per_dim, torch.where(oob[:, None, None], 0.0, w), oob


def sweep_fwd_plain(table: torch.Tensor, x01: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """Plain version of K4: [N, L*C] features, zero out of bounds."""
    N, L, C = x01.shape[0], spec.num_levels, spec.level_dim
    idx, _, w, oob = _sweep_corners(x01, spec)
    vals = gather_rows(table, idx.reshape(-1)).reshape(N, L, 8, C)
    feat = (w[..., None] * vals).sum(dim=2)
    return torch.where(oob[:, None, None], 0.0, feat).reshape(N, L * C)


def _check_args(table, x01, spec):
    if not sweep_supported(spec):
        raise ValueError("sweep_encode needs a ref-layout, 3-D, linear spec "
                         f"with at most {MAX_SWEEP_SIZE} rows a level")
    total, C = _table_rows(spec), kernels.channels(spec)
    if table.dtype != torch.float32 or tuple(table.shape) != (total, C):
        raise ValueError(f"sweep_encode: table must be float32 [{total}, {C}]")
    if x01.dtype != torch.float32 or x01.dim() != 2 or x01.shape[1] != 3:
        raise ValueError("sweep_encode: x01 must be float32 [N, 3]")
    if table.device != x01.device:
        raise ValueError("sweep_encode: table and x01 on different devices")


@lru_cache(maxsize=16)
def _table_rows(spec: HashGridSpec) -> int:
    return spec.table_size


@lru_cache(maxsize=16)
def _level_records(spec: HashGridSpec) -> np.ndarray:
    """K4's and K4b's per-level records on the host, made once a spec and
    read-only: int32 [L, 4] of (float32 lattice scale's bits, first table
    row, dense corner side or 0 on a hashed level, row count).  The
    launchers copy them into the launch's arguments."""
    L = spec.num_levels
    scales, offsets = level_arrays(spec, tuple(range(L)))
    sizes, hashed = spec.level_sizes, spec.use_hash
    sides = []
    for l in range(L):
        size = int(sizes[l])
        if hashed[l] and size & (size - 1):
            raise ValueError(f"sweep_encode: hashed level {l} has size {size},"
                             " not a power of two")
        sides.append(0 if hashed[l] else int(spec.resolutions[l])
                     + (0 if spec.align_corners else 1))
    rec = np.ascontiguousarray(np.stack(
        [np.ctypeslib.as_array(scales).view(np.int32),
         np.ctypeslib.as_array(offsets), np.asarray(sides, np.int32),
         sizes.astype(np.int32)], axis=1))
    rec.setflags(write=False)
    return rec


# K4/K4b launch shape: a block (1024 threads, one level's slice of up to
# 64C KiB in shared memory, so one block an SM at C = 3) takes one level of
# a chunk of at least CHUNK_MIN_POINTS points, and a large input gets one
# wave of blocks.  K4 runs a chunk's levels in clusters of 2 blocks (the
# second block of an odd last pair idle), K4b one block a level.
CHUNK_MIN_POINTS = 1024


def sweep_chunks(n_points: int, n_levels: int, n_sms: int,
                 forward: bool = True) -> int:
    """Point chunks per level of a K4 (forward) or K4b launch.  Chunk c
    holds the points [c * P, min(N, (c + 1) * P)) with P = ceil(N / chunks),
    walked by its blocks a block's size at a time.  K4b's block b takes
    level b % L of chunk b // L; K4's cluster k takes the level pair
    k % ceil(L / 2) of chunk k // ceil(L / 2) (csrc/sweep_encode.cu)."""
    blocks = 2 * (-(-n_levels // 2)) if forward else n_levels
    return max(1, min(n_sms // blocks, -(-n_points // CHUNK_MIN_POINTS)))


@lru_cache(maxsize=8)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_grad(x01, g, spec):
    N, width = x01.shape[0], spec.num_levels * spec.level_dim
    if g.dtype != torch.float32 or tuple(g.shape) != (N, width):
        raise ValueError(f"sweep_bwd: g must be float32 [{N}, {width}]")
    if g.device != x01.device:
        raise ValueError("sweep_bwd: g and x01 on different devices")


def sweep_fwd(table: torch.Tensor, x01: torch.Tensor,
              spec: HashGridSpec) -> torch.Tensor:
    """Features [N, L*C] of x01 [N, 3] (zero outside [0, 1]^3) from the
    canonical ref table [total, C].  A CPU tensor takes the plain version; a
    CUDA tensor launches K4 (counted in kernels.LAUNCHES["sweep_fwd"] and
    ["sweep_fwd_c<C>"])."""
    _check_args(table, x01, spec)
    if x01.device.type == "cpu":
        return sweep_fwd_plain(table, x01, spec)
    if x01.device.type != "cuda":
        raise RuntimeError(f"sweep_fwd: no kernel for {x01.device}")
    table, x01 = table.contiguous(), x01.contiguous()
    N, L, C = x01.shape[0], spec.num_levels, spec.level_dim
    out = torch.empty((N, L * C), dtype=torch.float32, device=x01.device)
    lib = kernels.load()
    code = lib.n2m_sweep_fwd(
        table.data_ptr(), x01.data_ptr(), _level_records(spec).ctypes.data,
        float(spec.shift), N, L, C, sweep_chunks(N, L, _num_sms(x01.device)),
        out.data_ptr(), kernels.current_stream_handle(x01.device))
    kernels.check(lib, "n2m_sweep_fwd", code)
    kernels.count("sweep_fwd", C)
    return out


def sweep_bwd_plain(table: torch.Tensor, x01: torch.Tensor, g: torch.Tensor,
                    spec: HashGridSpec, need_dx: bool = True):
    """Plain version of K4b and of the input gradient: (dtable [total, C],
    dx [N, 3] or None) for the output gradient g [N, L*C], the JAX
    ``_sweep_bwd`` in PyTorch (the table gradient through ``index_add_``)."""
    N, L, C = x01.shape[0], spec.num_levels, spec.level_dim
    idx, per_dim, w, oob = _sweep_corners(x01, spec)
    g3 = g.float().reshape(N, L, C)
    contrib = (w[..., None] * g3[:, :, None, :]).reshape(-1, C)
    dtable = torch.zeros((table.shape[0], C), dtype=torch.float32,
                         device=table.device).index_add_(0, idx.reshape(-1),
                                                         contrib)
    if not need_dx:
        return dtable, None
    return dtable, _sweep_dx(table, x01, g3, spec, idx, per_dim, oob)


def _sweep_dx(table, x01, g3, spec, idx, per_dim, oob):
    """dx [N, 3]: scale_l times the corner values against the derivative of
    the trilinear weights, zero for out-of-bounds points (plain PyTorch on
    every device: only stage 1's offset gradient under
    enable_offset_nerf_grad asks for it)."""
    N, L, C = g3.shape
    vals = gather_rows(table.detach(), idx.reshape(-1)).reshape(N, L, 8, C)
    sgn = 2.0 * corner_bits(x01.device).float() - 1.0                # [8, 3]
    scales = torch.tensor([spec.level_scale32(l) for l in range(L)],
                          device=x01.device)
    cols = []
    for d in range(3):
        dw = sgn[None, None, :, d]
        for od in range(3):
            if od != d:
                dw = dw * per_dim[..., od]
        acc = torch.zeros((N, L), device=x01.device)
        for c in range(C):
            acc = acc + (vals[..., c] * dw).sum(dim=-1) * g3[:, :, c]
        cols.append((acc * scales[None, :]).sum(dim=1))
    dx = torch.where(oob[:, None], 0.0, torch.stack(cols, dim=1))
    return dx.to(x01.dtype)


def sweep_bwd(table: torch.Tensor, x01: torch.Tensor, g: torch.Tensor,
              spec: HashGridSpec, need_dx: bool = True):
    """(dtable [total, C], dx [N, 3] or None) for the output gradient g
    [N, L*C] float32.  A CPU tensor takes the plain version; a CUDA tensor
    launches K4b for dtable (counted in kernels.LAUNCHES["sweep_bwd"] and
    ["sweep_bwd_c<C>"]) and
    adds dx, when asked, in plain PyTorch."""
    _check_args(table, x01, spec)
    _check_grad(x01, g, spec)
    if x01.device.type == "cpu":
        return sweep_bwd_plain(table, x01, g, spec, need_dx)
    if x01.device.type != "cuda":
        raise RuntimeError(f"sweep_bwd: no kernel for {x01.device}")
    x01, g = x01.contiguous(), g.contiguous()
    N, L, C = x01.shape[0], spec.num_levels, spec.level_dim
    dtable = torch.zeros((table.shape[0], C), dtype=torch.float32,
                         device=x01.device)
    lib = kernels.load()
    code = lib.n2m_sweep_bwd(
        g.data_ptr(), x01.data_ptr(), _level_records(spec).ctypes.data,
        float(spec.shift), N, L, C,
        sweep_chunks(N, L, _num_sms(x01.device), forward=False),
        dtable.data_ptr(), kernels.current_stream_handle(x01.device))
    kernels.check(lib, "n2m_sweep_bwd", code)
    kernels.count("sweep_bwd", C)
    if not need_dx:
        return dtable, None
    idx, per_dim, _, oob = _sweep_corners(x01, spec)
    return dtable, _sweep_dx(table, x01, g.reshape(N, L, C), spec, idx,
                             per_dim, oob)


class _Sweep(torch.autograd.Function):
    """K4 forward, K4b backward (or their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, table, x01, spec):
        ctx.save_for_backward(table, x01)
        ctx.spec = spec
        return sweep_fwd(table, x01, spec)

    @staticmethod
    def backward(ctx, g):
        table, x01 = ctx.saved_tensors
        dtable, dx = sweep_bwd(table, x01, g.float().contiguous(), ctx.spec,
                               need_dx=ctx.needs_input_grad[1])
        return (dtable if ctx.needs_input_grad[0] else None), dx, None


def sweep_encode(table: torch.Tensor, x01: torch.Tensor,
                 spec: HashGridSpec) -> torch.Tensor:
    """Drop-in for hashgrid_encode (without the max_level mask) on specs
    that sweep_supported accepts; differentiable in table and x01."""
    return _Sweep.apply(table, x01, spec)
