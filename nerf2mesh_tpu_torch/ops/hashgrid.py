"""Multiresolution hash/tiled grid encoding (instant-NGP) in PyTorch.

Port of nerf2mesh_tpu/ops/hashgrid.py.  ``HashGridSpec`` is a copy of the
JAX module's (pure Python/numpy; that module imports jax).  Hash arithmetic
is uint32 wraparound done in int64: every product is reduced mod 2^32 with
``mul32`` (which never overflows int64) and every xor of reduced values stays
below 2^32, so the indices equal JAX's uint32 ones.

``hashgrid_encode`` is the plain exact encode (a gather of all 2^D corners
per level, D = 1-3 input dimensions, linear or smoothstep interpolation);
it is the oracle that the splat path (ops/splat_encode.py) is held
against.  ``hashgrid_tv_loss`` is the stage-0 TV regularizer.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

# xor-hash primes (instant-NGP): applied per input dimension.
_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridSpec:
    """Static metadata for one encoder instance (copy of the JAX spec).

    layout "ref" indexes entries like the reference CUDA gridencoder;
    "block512" partitions the corner lattice into aligned 8^3 blocks, index =
    window*512 + row-major offset in the block, window = dense block id
    (coarse levels) or an xor-of-primes hash of the block coords (fine).
    """
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: Optional[int] = None
    per_level_scale: float = 2.0
    gridtype: str = "hash"          # "hash" | "tiled"
    align_corners: bool = False
    interpolation: str = "linear"   # "linear" | "smoothstep"
    input_dim: int = 3
    layout: str = "ref"             # "ref" | "block512"

    def __post_init__(self):
        if self.desired_resolution is not None:
            s = math.exp2(
                math.log2(self.desired_resolution / self.base_resolution)
                / (self.num_levels - 1)
            )
            object.__setattr__(self, "per_level_scale", float(s))
        if self.layout not in ("ref", "block512"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.layout == "block512" and self.input_dim != 3:
            raise ValueError("block512 layout is 3-D only")
        if (self.layout == "block512" and self.gridtype == "hash"
                and self.log2_hashmap_size < 9):
            # a hashed level holds whole 512-row windows: below 2^9 rows it
            # holds none (JAX's encode turns the parameters to NaN there)
            raise ValueError(
                f"block512 layout needs at least 2^9 rows a level "
                f"(log2_hashmap_size >= 9), not 2^{self.log2_hashmap_size}")

    @property
    def log2_scale(self) -> float:
        return math.log2(self.per_level_scale)

    def level_scale(self, l: int) -> float:
        return math.exp2(l * self.log2_scale) * self.base_resolution - 1.0

    def level_scale32(self, l: int) -> float:
        """level_scale rounded to float32, as the JAX code multiplies by it."""
        return float(np.float32(self.level_scale(l)))

    @property
    def shift(self) -> float:
        return 0.0 if self.align_corners else 0.5

    @property
    def resolutions(self) -> np.ndarray:
        return np.array(
            [int(math.ceil(self.level_scale(l))) + 1 for l in range(self.num_levels)],
            dtype=np.int64,
        )

    @property
    def block_counts(self) -> np.ndarray:
        """(block512) blocks per dim per level: ceil(corner_side / 8)."""
        side = self.resolutions + (0 if self.align_corners else 1)
        return ((side + 7) // 8).astype(np.int64)

    @property
    def level_sizes(self) -> np.ndarray:
        max_params = 2 ** self.log2_hashmap_size
        sizes = []
        if self.layout == "block512":
            for nb in self.block_counts:
                dense = int(nb) ** self.input_dim * 512
                if self.gridtype == "hash" and dense > max_params:
                    sizes.append(max_params)
                else:
                    sizes.append(dense)
            return np.array(sizes, dtype=np.int64)
        for r in self.resolutions:
            side = int(r) if self.align_corners else int(r) + 1
            n = min(max_params, side ** self.input_dim)
            sizes.append(int(math.ceil(n / 8) * 8))
        return np.array(sizes, dtype=np.int64)

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.level_sizes)]).astype(np.int64)

    @property
    def table_size(self) -> int:
        return int(self.offsets[-1])

    @property
    def use_hash(self) -> np.ndarray:
        if self.layout == "block512":
            dense = self.block_counts ** self.input_dim * 512
            return (self.gridtype == "hash") & (dense > self.level_sizes)
        side = self.resolutions + (0 if self.align_corners else 1)
        return (self.gridtype == "hash") & (side ** self.input_dim > self.level_sizes)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


@lru_cache(maxsize=64)
def level_arrays(spec: HashGridSpec, levels: Tuple[int, ...]):
    """Host arrays of the levels' float32 lattice scales and first table
    rows, the per-level constants of the kernel launches.  Computed once a
    (spec, levels): the spec's properties recompute their per-level tables
    in Python on every access."""
    offs = spec.offsets
    return ((ctypes.c_float * len(levels))(*[spec.level_scale32(l)
                                            for l in levels]),
            (ctypes.c_int32 * len(levels))(*[int(offs[l]) for l in levels]))


def init_hashgrid(generator: torch.Generator, spec: HashGridSpec,
                  dtype=torch.float32) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) table init (reference grid.py:141-144)."""
    t = torch.rand((spec.table_size, spec.level_dim), generator=generator,
                   dtype=dtype, device=generator.device)
    return t * 2e-4 - 1e-4


def mul32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a * prime) mod 2^32 for int64 a in [0, 2^32) without int64 overflow:
    split the prime into 16-bit halves so each partial product is < 2^48."""
    lo, hi = prime & 0xFFFF, prime >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def xor_hash3(b: torch.Tensor) -> torch.Tensor:
    """uint32 xor-of-primes hash of int64 coords b [..., 3] in [0, 2^32)."""
    return (mul32(b[..., 0], _PRIMES[0]) ^ mul32(b[..., 1], _PRIMES[1])
            ^ mul32(b[..., 2], _PRIMES[2]))


def block_window(b: torch.Tensor, spec: HashGridSpec, l: int) -> torch.Tensor:
    """Level-local window id (int64) of int64 block coords b [..., 3]."""
    n_win = int(spec.level_sizes[l]) // 512
    nb = int(spec.block_counts[l])
    if bool(spec.use_hash[l]):
        win = xor_hash3(b)
    else:
        win = (b[..., 0] + b[..., 1] * nb + b[..., 2] * (nb * nb)) & _MASK32
    return win % n_win


def _corner_indices_block(pos_grid: torch.Tensor, spec: HashGridSpec,
                          levels=None) -> torch.Tensor:
    """block512 index for int64 grid coords pos_grid [N, Lsel, 8, 3]; levels
    names the Lsel levels (default all).  Returns int64 [N, Lsel, 8]."""
    levels = range(spec.num_levels) if levels is None else levels
    b = pos_grid >> 3
    loc = pos_grid & 7
    local_off = loc[..., 0] + loc[..., 1] * 8 + loc[..., 2] * 64
    out = []
    for i, l in enumerate(levels):
        win = block_window(b[:, i], spec, l)
        out.append(win * 512 + local_off[:, i] + int(spec.offsets[l]))
    return torch.stack(out, dim=1)


def _corner_indices(pos_grid: torch.Tensor, spec: HashGridSpec,
                    levels=None) -> torch.Tensor:
    """Table index (int64) for int64 grid coords pos_grid [N, Lsel, 8, D]."""
    if spec.layout == "block512":
        return _corner_indices_block(pos_grid, spec, levels)
    levels = range(spec.num_levels) if levels is None else levels
    out = []
    for i, l in enumerate(levels):
        pg = pos_grid[:, i]
        side = int(spec.resolutions[l]) + (0 if spec.align_corners else 1)
        size = int(spec.level_sizes[l])
        if bool(spec.use_hash[l]):
            idx = torch.zeros_like(pg[..., 0])
            for d in range(spec.input_dim):
                idx = idx ^ mul32(pg[..., d], _PRIMES[d])
        else:
            idx = torch.zeros_like(pg[..., 0])
            stride = 1
            for d in range(spec.input_dim):
                idx = (idx + mul32(pg[..., d], stride)) & _MASK32
                stride = (stride * side) & _MASK32
        out.append(idx % size + int(spec.offsets[l]))
    return torch.stack(out, dim=1)


def corner_bits(device=None, dim: int = 3) -> torch.Tensor:
    """[2^dim, dim] int64 corner bit patterns: bit d of corner i is its
    offset along axis d (gridencoder.cu:166-180 order; JAX
    ``_corner_offsets``).  Built on the device (arange), so no host-to-device
    copy stalls the stream."""
    i = torch.arange(1 << dim, device=device)
    return (i[:, None] >> torch.arange(dim, device=device)) & 1


def lattice(x: torch.Tensor, spec: HashGridSpec, l: int):
    """floor and fraction of x * scale_l + shift for level l, with the
    product and the sum rounded separately (as JAX does op by op, and as
    the CUDA kernels do with __fmul_rn/__fadd_rn)."""
    pos = x.float() * spec.level_scale32(l) + spec.shift
    pg = torch.floor(pos)
    return pg, pos - pg


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for flat int64 row ids, as index_select: its backward is an
    index_add (atomic adds on a card), where advanced indexing's backward
    sorts the ids first (measured ~23 ms per 2^18-point call on an H100)."""
    return torch.index_select(table, 0, idx)


def corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """Multilinear weights [..., 2^D] from per-axis fractions [..., D]; corner
    bit d picks frac (1) or 1 - frac (0) on axis d; product (x*y)*z."""
    D = frac.shape[-1]
    f = frac.unsqueeze(-2)                                          # [...,1,D]
    per_axis = torch.where(corner_bits(frac.device, D).bool(), f, 1.0 - f)
    w = per_axis[..., 0]
    for d in range(1, D):
        w = w * per_axis[..., d]
    return w


def hashgrid_encode(table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec,
                    max_level: Optional[int] = None) -> torch.Tensor:
    """Exact encode: [N, D] positions in [0, 1] -> [N, L*C] features.

    D = spec.input_dim (1-3; 2^D corners a level, the hashed levels take
    the first D primes); spec.interpolation "smoothstep" maps each fraction
    f to f*f*(3-2f) before the weights, as JAX's hashgrid_encode.  Points
    outside [0, 1]^D give zeros; levels >= max_level give zeros.
    Differentiable in the table (gather backward = scatter-add)."""
    N = x01.shape[0]
    L, C, D = spec.num_levels, spec.level_dim, spec.input_dim
    if not 1 <= D <= 3 or x01.shape[-1] != D:
        raise ValueError(f"hashgrid_encode: x01 must be [N, {D}], D in 1-3")
    x01 = x01.float()
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    pos_grid, frac = (torch.stack(t, dim=1) for t in zip(
        *[lattice(x01, spec, l) for l in range(L)]))                # [N, L, D]
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    bits = corner_bits(x01.device, D)                               # [2^D, D]
    cg = pos_grid.long()[:, :, None, :] + bits                      # [N,L,2^D,D]
    idx = _corner_indices(cg, spec)                                 # [N,L,2^D]
    w = corner_weights(frac)                                        # [N,L,2^D]
    vals = gather_rows(table, idx.reshape(-1)).reshape(N, L, len(bits), C)
    feat = (w[..., None] * vals).sum(dim=2)                         # [N,L,C]
    if max_level is not None:
        keep = torch.arange(L, device=x01.device) < max_level
        feat = feat * keep[None, :, None]
    feat = torch.where(oob[:, None, None], 0.0, feat)
    return feat.reshape(N, L * C)


def hashgrid_tv_loss(table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec,
                     point_weight: Optional[torch.Tensor] = None,
                     channel: Optional[int] = 0) -> torch.Tensor:
    """Total-variation loss at sampled locations: summed squared differences
    between each point's base corner and its +x/+y/+z neighbours, per level,
    divided by N (the reference's injected TV gradient, gridencoder.cu:505-644).
    channel=0 is the density channel of the merged table; None diffs all."""
    N = x01.shape[0]
    L, C, D = spec.num_levels, spec.level_dim, spec.input_dim
    x01 = x01.float()
    inb = ((x01 >= 0.0) & (x01 <= 1.0)).all(dim=-1).float()
    if point_weight is not None:
        inb = inb * point_weight
    pos_grid = torch.stack([lattice(x01, spec, l)[0] for l in range(L)],
                           dim=1).long()                            # [N, L, 3]
    channels = range(C) if channel is None else [channel]
    base_idx = _corner_indices(pos_grid[:, :, None, :], spec)[..., 0]
    eye = torch.eye(D, dtype=torch.long, device=x01.device)
    loss = table.new_zeros(())
    nb_idx = [_corner_indices((pos_grid + eye[d])[:, :, None, :], spec)[..., 0]
              for d in range(D)]
    v0 = gather_rows(table, base_idx.reshape(-1)).reshape(N, L, C)
    vn = [gather_rows(table, i.reshape(-1)).reshape(N, L, C) for i in nb_idx]
    for c in channels:
        for d in range(D):
            diff = v0[..., c] - vn[d][..., c]
            loss = loss + (diff * diff * inb[:, None]).sum()
    return loss / max(N, 1)
