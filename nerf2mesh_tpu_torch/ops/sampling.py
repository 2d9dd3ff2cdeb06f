"""Occupancy-guided two-pass ray sampling (port of nerf2mesh_tpu/ops/sampling.py).

Pass 1 places Kc coarse candidates per ray on the closed-form dt schedule
over [near, far] and tests each against the packed occupancy grid (kernel K1
via ``occupancy_lookup``).  Pass 2 places Kf samples per ray by inverse CDF
over the occupied arc length.  The JAX package selects each sample's segment
with a dense [N, Kf, Kc] one-hot and a HIGHEST-precision einsum (a TPU
workaround for gathers); here the same selection is ``torch.searchsorted``
plus ``picked = (c < Kc) & (cdf0[c] < s)``, which reproduces the one-hot's
empty row at s == 0 and across zero-length segments exactly.

The sampler's noise ``u`` [N, Kf] is an explicit argument, so the port can
be fed the JAX package's exact draws.  The segment mode (``sample_dt``)
places samples at a fixed per-ray spacing for the eval march and reports
where it stopped (``t_exit``); ``occupied_length`` sets that spacing.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .contraction import contract
from .occ_sweep import occ_lookup, pack_bits

SQRT3 = math.sqrt(3.0)


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.05):
    """Slab test (raymarching.cu:91-156). aabb: [6]. Misses get near == far."""
    tiny = torch.where(rays_d >= 0, 1e-15, -1e-15)
    rd = torch.where(rays_d.abs() < 1e-15, tiny, rays_d)
    inv_d = 1.0 / rd
    t0 = (aabb[None, :3] - rays_o) * inv_d
    t1 = (aabb[None, 3:] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    nears = tmin.clamp(min=min_near)
    fars = torch.maximum(tmax, nears)
    return nears, fars


def occupancy_index(xyzs, dts, bound: float, contracted: bool,
                    cascades: int, grid_size: int):
    """The occupancy grid cell of each point, with cascade (mip) selection
    (raymarching.cu:42-54, 405-464): (flat int32 [...] linear cell index
    ((level*H + x)*H + y)*H + z, cxyz [..., 3] the contracted positions).
    xyzs: [..., 3]; dts: [...]."""
    H = grid_size
    mag = xyzs.abs().amax(dim=-1)
    mip_pos = torch.ceil(torch.log2(mag.clamp(min=1e-12)).clamp(min=0.0))
    mip_dt = torch.ceil(torch.log2((dts * H / 2.0).clamp(min=1e-12))
                        .clamp(min=0.0))
    level = torch.maximum(mip_pos, mip_dt).clamp(0, cascades - 1).to(torch.int32)
    mip_bound = torch.pow(2.0, level.float()).clamp(max=bound)
    cxyz = contract(xyzs) if contracted else xyzs
    n = (0.5 * (cxyz / mip_bound[..., None] + 1.0) * H).to(torch.int32)
    n = n.clamp(0, H - 1)
    return ((level * H + n[..., 0]) * H + n[..., 1]) * H + n[..., 2], cxyz


def occupancy_lookup(occ_grid, xyzs, dts, bound: float, contracted: bool,
                     cascades: int, grid_size: int):
    """Pointwise occupancy test of the cells of occupancy_index.
    occ_grid: [CAS, H, H, H]; xyzs: [..., 3]; dts: [...].  Returns (occ
    bool [...], cxyz [..., 3])."""
    flat, cxyz = occupancy_index(xyzs, dts, bound, contracted, cascades,
                                 grid_size)
    occ = occ_lookup(pack_bits(occ_grid), flat) > 0
    if contracted:      # contracted outer region always marched
        occ = occ | (xyzs.abs().amax(dim=-1) > 1.0)
    return occ, cxyz


def _dt_schedule(t0, steps: int, dt_gamma: float, dt_min: float, dt_max: float):
    """Closed-form t_i for t_{i+1} = t_i + clamp(t_i*dt_gamma, dt_min, dt_max)
    (raymarching.cu:389,407): linear below dt_min/g, geometric, then linear."""
    i = torch.arange(steps, dtype=torch.float32, device=t0.device)[None, :]
    t0 = t0[:, None]
    if dt_gamma <= 0.0:
        ts = t0 + i * dt_min
        return ts, torch.full_like(ts, dt_min)
    g = dt_gamma
    a, b, r = dt_min / g, dt_max / g, 1.0 + g
    n1 = torch.ceil((a - t0).clamp(min=0.0) / dt_min)
    t_a = t0 + n1 * dt_min
    n2 = torch.ceil(torch.log((b / t_a.clamp(min=1e-12)).clamp(min=1.0))
                    .clamp(min=0.0) / math.log(r))
    t_b = t_a * r ** n2
    in2 = torch.minimum((i - n1).clamp(min=0.0), n2)
    in3 = (i - n1 - n2).clamp(min=0.0)
    ts = torch.where(i <= n1, t0 + torch.minimum(i, n1) * dt_min,
                     torch.where(i <= n1 + n2, t_a * r ** in2,
                                 t_b + in3 * dt_max))
    return ts, (ts * g).clamp(dt_min, dt_max)


def coarse_candidates(rays_o, rays_d, nears, fars, num_coarse: int,
                      grid_size: int, bound: float, dt_gamma: float,
                      max_steps: int):
    """Kc coarse candidates a ray on the dt schedule, stretched to cover
    [near, far]: (t0c, dtc [N, Kc], xyz_c [N, Kc, 3] their midpoints)."""
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * bound / grid_size
    span = (fars - nears).clamp(min=1e-9)
    ts_sched, _ = _dt_schedule(nears, num_coarse + 1, dt_gamma, dt_min, dt_max)
    reach = ts_sched[:, -1] - nears
    scale = (span / reach.clamp(min=1e-9)).clamp(min=1.0)
    edges = nears[:, None] + (ts_sched - nears[:, None]) * scale[:, None]
    t0c = edges[:, :-1]
    dtc = edges[:, 1:] - edges[:, :-1]                        # [N, Kc]
    tmidc = t0c + 0.5 * dtc

    xyz_c = rays_o[:, None, :] + tmidc[..., None] * rays_d[:, None, :]
    return t0c, dtc, xyz_c.clamp(-bound, bound)


def _coarse_pass(rays_o, rays_d, occ_grid, nears, fars, num_coarse: int,
                 grid_size: int, cascades: int, bound: float,
                 contracted: bool, dt_gamma: float, max_steps: int):
    """coarse_candidates tested against the occupancy grid: (t0c, dtc, occ)
    [N, Kc]."""
    t0c, dtc, xyz_c = coarse_candidates(rays_o, rays_d, nears, fars,
                                        num_coarse, grid_size, bound,
                                        dt_gamma, max_steps)
    occ, _ = occupancy_lookup(occ_grid, xyz_c, dtc, bound, contracted,
                              cascades, grid_size)
    return t0c, dtc, occ & (t0c < fars[:, None])


def occupied_length(rays_o, rays_d, occ_grid, nears, fars, *,
                    num_coarse: int = 128, grid_size: int = 128,
                    cascades: int = 1, bound: float = 1.0,
                    contracted: bool = False, dt_gamma: float = 0.0,
                    max_steps: int = 1024) -> torch.Tensor:
    """[N] occupied length along each ray (coarse pass only, no field
    queries): it sets the fixed sample spacing of the eval march."""
    _, dtc, occ = _coarse_pass(rays_o, rays_d, occ_grid, nears, fars,
                               num_coarse, grid_size, cascades, bound,
                               contracted, dt_gamma, max_steps)
    return torch.where(occ, dtc, 0.0).sum(dim=-1)


class Samples(NamedTuple):
    """Dense per-ray samples, [N, K] layout."""
    ts: torch.Tensor      # [N, K] sample t
    dts: torch.Tensor     # [N, K] segment length
    xyzs: torch.Tensor    # [N, K, 3] world (or contracted) positions
    valid: torch.Tensor   # [N, K] bool: the ray had occupied space here
    total: torch.Tensor   # [] int64 number of valid samples
    t_exit: Optional[torch.Tensor] = None   # [N] segment mode: where the
    #                                         march consumed its budget


def sample_rays(
    rays_o, rays_d, occ_grid, nears, fars, *,
    num_coarse: int = 128,
    num_fine: int = 64,
    grid_size: int = 128,
    cascades: int = 1,
    bound: float = 1.0,
    contracted: bool = False,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    u: Optional[torch.Tensor] = None,
    sample_dt: Optional[torch.Tensor] = None,
) -> Samples:
    """Two-pass occupancy-importance sampling. rays_o/d: [N, 3].

    u: [N, num_fine] uniform noise in [0, 1) (the JAX package draws it from
    its noise key when perturbing); None places samples at u = 0.5.

    sample_dt [N] (segment mode, for the eval march): instead of stretching
    Kf samples over the whole occupied length, place them at the fixed
    spacing sample_dt from `nears`, consuming at most Kf * sample_dt of
    occupied length; `t_exit` then reports where the march stopped (the
    next segment's near), or far + 1 once the ray's occupied space is
    exhausted.  A sequence of segment calls is one long fixed-spacing march
    (the reference's inference loop, raymarching.cu:750-832)."""
    N = rays_o.shape[0]
    Kf = num_fine
    dev = rays_o.device

    # pass 1: coarse candidates tested against the occupancy grid
    t0c, dtc, occ = _coarse_pass(rays_o, rays_d, occ_grid, nears, fars,
                                 num_coarse, grid_size, cascades, bound,
                                 contracted, dt_gamma, max_steps)
    Kc = t0c.shape[1]

    # pass 2: inverse-CDF placement of Kf samples over occupied length
    occ_len = torch.where(occ, dtc, 0.0)
    cdf = torch.cumsum(occ_len, dim=-1)                       # [N, Kc]
    total_len = cdf[:, -1:]                                   # [N, 1]
    has_any = total_len[:, 0] > 0

    if u is None:
        u = torch.full((N, Kf), 0.5, device=dev)
    i = torch.arange(Kf, dtype=torch.float32, device=dev)[None, :]
    if sample_dt is None:
        s = (i + u) / Kf * total_len                          # [N, Kf]
    else:
        sd = sample_dt[:, None].float()                       # [N, 1]
        s = (i + u) * sd

    # segment c holds s when cdf0[c] < s <= cdf[c] (the JAX one-hot)
    cdf0 = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=-1)
    cdf = cdf.contiguous()
    c = torch.searchsorted(cdf, s.contiguous(), side="left")
    cc = c.clamp(max=Kc - 1)
    picked = (c < Kc) & (torch.gather(cdf0, 1, cc) < s)
    seg_t0 = torch.where(picked, torch.gather(t0c, 1, cc), 0.0)
    seg_dt = torch.where(picked, torch.gather(dtc, 1, cc), 0.0)
    seg_cdf0 = torch.where(picked, torch.gather(cdf0, 1, cc), 0.0)

    frac = torch.where(seg_dt > 0,
                       (s - seg_cdf0) / seg_dt.clamp(min=1e-12), 0.0)
    ts = seg_t0 + frac * seg_dt
    dts = (total_len / Kf if sample_dt is None else sd).expand(N, Kf)

    valid = picked & has_any[:, None] & (ts < fars[:, None])
    t_exit = None
    if sample_dt is not None:
        valid = valid & (s < total_len)                       # budget inside occ
        # t where the cumulative occupied length reaches the consumed budget
        consumed = torch.minimum(Kf * sd[:, 0], total_len[:, 0])       # [N]
        ce = torch.searchsorted(cdf, consumed[:, None].contiguous(),
                                side="left")
        cec = ce.clamp(max=Kc - 1)
        e_cdf0 = torch.gather(cdf0, 1, cec)
        hit = (ce < Kc) & (e_cdf0 < consumed[:, None])
        e_t0 = torch.where(hit, torch.gather(t0c, 1, cec), 0.0)[:, 0]
        e_cdf0 = torch.where(hit, e_cdf0, 0.0)[:, 0]
        exhausted = Kf * sd[:, 0] >= total_len[:, 0]
        t_exit = torch.where(exhausted | ~has_any, fars + 1.0,
                             e_t0 + (consumed - e_cdf0))

    xyz = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    xyz = xyz.clamp(-bound, bound)
    if contracted:
        xyz = contract(xyz)

    return Samples(
        ts=torch.where(valid, ts, 0.0),
        dts=torch.where(valid, dts, 0.0),
        xyzs=torch.where(valid[..., None], xyz, 0.0),
        valid=valid,
        total=valid.sum(),
        t_exit=t_exit,
    )
