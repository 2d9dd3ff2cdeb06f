"""Stage-0 volumetric renderer (port of nerf2mesh_tpu/models/renderer.py).

Occupancy-grid state, the density-grid update (one of 8 x-slabs per call,
round-robin: the EMA-max, or under ``trainable_density_grid`` a descent
step on the slab's loss), ``mark_untrained_grid``, the training render
``render_train`` with valid-sample pool compaction, and the early-exit eval
march (``render_eval_segment``, ``render_frame_queue``).  In SDF mode the
field's raw SDF becomes a NeuS alpha (``neus_alpha_from_sdf``) from the
finite-difference normal.

At bound > 1 the grid has 1 + ceil(log2(grid bound)) cascades, cascade c
covering [-min(2^c, grid bound), +...]^3; under contraction the field and
the grid see contracted positions in [-2, 2]^3 (grid bound 2, two
cascades).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.rays import safe_normalize
from ..ops.composite import composite_rays
from ..ops.sampling import near_far_from_aabb, occupied_length, sample_rays
from .network import (NeRFField, NetworkSpec, density, field_forward,
                      finite_diff_normal)


@dataclass(frozen=True)
class RenderSpec:
    """Static geometry/render configuration (derived from Config)."""
    bound: float = 1.0
    contract: bool = False
    grid_size: int = 128
    min_near: float = 0.05
    density_thresh: float = 10.0
    max_steps: int = 1024         # sets dt_min = 2*sqrt(3)/max_steps
    num_coarse: int = 128         # coarse occupancy candidates per ray
    num_fine: int = 64            # field samples per ray (dense layout)
    dt_gamma: float = 0.0
    T_thresh: float = 1e-4
    sdf: bool = False

    @property
    def grid_bound(self) -> float:
        return 2.0 if self.contract else self.bound

    @property
    def cascades(self) -> int:
        gb = self.grid_bound
        return 1 + int(math.ceil(math.log2(gb))) if gb > 1 else 1


@dataclass
class RenderState:
    """Occupancy state carried across steps."""
    density_grid: torch.Tensor   # [CAS, H, H, H] f32; -1 marks untrained cells
    occ_grid: torch.Tensor       # [CAS, H, H, H] uint8 thresholded occupancy
    mean_density: torch.Tensor   # [] f32
    iter_density: int = 0


def init_render_state(spec: RenderSpec, device=None) -> RenderState:
    H, C = spec.grid_size, spec.cascades
    return RenderState(
        density_grid=torch.zeros((C, H, H, H), device=device),
        occ_grid=torch.ones((C, H, H, H), dtype=torch.uint8, device=device),
        mean_density=torch.zeros((), device=device),
    )


GRID_UPDATE_SLABS = 8
GRID_LR = 1e-2          # the trainable grid's step (JAX's grid_lr default)


def slab_points(spec: RenderSpec, slab: int, device=None) -> torch.Tensor:
    """[HX*H*H, 3] cell-center coords in [-1, 1] of x-slab `slab`."""
    H = spec.grid_size
    sh = H // GRID_UPDATE_SLABS
    ax = 2.0 * torch.arange(H, dtype=torch.float32, device=device) / (H - 1) - 1.0
    gi = torch.arange(sh, dtype=torch.float32, device=device) + float(slab * sh)
    ax_x = 2.0 * gi / (H - 1) - 1.0
    gx, gy, gz = torch.meshgrid(ax_x, ax, ax, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def slab_noise(spec: RenderSpec, generator: torch.Generator,
               device=None) -> List[torch.Tensor]:
    """Per-cascade jitter, uniform in [-half, half) per cell coordinate."""
    H = spec.grid_size
    n = (H // GRID_UPDATE_SLABS) * H * H
    out = []
    for cas in range(spec.cascades):
        half = min(2 ** cas, spec.grid_bound) / H
        u = torch.rand((n, 3), generator=generator, device=device)
        out.append(u * (2 * half) - half)
    return out


@torch.no_grad()
def _update_density_slab(params: NeRFField, state: RenderState,
                         noise: List[torch.Tensor], spec: RenderSpec,
                         net_spec: NetworkSpec, max_level: Optional[int],
                         slab: int, decay: float = 0.95,
                         trainable: bool = False,
                         lambda_density: float = 0.0) -> RenderState:
    """Query density at jittered cell centers of one x-slab, EMA-max update,
    re-threshold occupancy (reference renderer.py:1074-1149).  noise:
    per-cascade [HX*H*H, 3] jitter (slab_noise).

    trainable (--trainable_density_grid, reference renderer.py:1123-1149):
    in place of the EMA-max, one gradient step of size GRID_LR on the slab
    loss  sum_valid (g - q)^2 / n_valid  +  sum_{c >= 1} 2^(c-1)
    lambda_density sum_valid(c) g_c / n_valid(c)  (q the fresh queries),
    whose gradient JAX takes by autodiff; here it is written out."""
    H, CAS = spec.grid_size, spec.cascades
    sh = H // GRID_UPDATE_SLABS
    x_lo = slab * sh
    xyzs01 = slab_points(spec, slab, state.density_grid.device)
    tmp = []
    for cas in range(CAS):
        bound = min(2 ** cas, spec.grid_bound)
        half = bound / H
        pts = xyzs01 * (bound - half)
        sig = density(params, pts + noise[cas], net_spec, max_level)
        if spec.sdf:
            inv_s = sdf_inv_s(params)
            sig = torch.sigmoid(-sig * inv_s) * inv_s
        tmp.append(sig.reshape(sh, H, H))
    tmp_slab = torch.stack(tmp, dim=0)                      # [CAS, HX, H, H]

    grid = state.density_grid.clone()
    old_slab = grid[:, x_lo:x_lo + sh]
    valid = (old_slab >= 0) & (tmp_slab >= 0)
    if trainable:
        nv = valid.sum().clamp(min=1).float()
        g = torch.where(valid, 2.0 * (old_slab - tmp_slab), 0.0) / nv
        for cas in range(1, CAS):
            nvc = valid[cas].sum().clamp(min=1).float()
            g[cas] = g[cas] + torch.where(
                valid[cas], (2.0 ** (cas - 1)) * lambda_density / nvc, 0.0)
        new_slab = torch.where(valid, old_slab - GRID_LR * g, old_slab)
    else:
        new_slab = torch.where(
            valid, torch.maximum(old_slab * decay, tmp_slab), old_slab)
    grid[:, x_lo:x_lo + sh] = new_slab

    mean_density = grid.clamp(min=0.0).mean()
    thresh = torch.clamp(mean_density, max=spec.density_thresh)
    return RenderState(
        density_grid=grid,
        occ_grid=(grid > thresh).to(torch.uint8),
        mean_density=mean_density,
        iter_density=state.iter_density + 1,
    )


def update_density_grid(params: NeRFField, state: RenderState,
                        generator: torch.Generator, spec: RenderSpec,
                        net_spec: NetworkSpec, max_level: Optional[int] = None,
                        decay: float = 0.95, slab: int = -1,
                        trainable: bool = False,
                        lambda_density: float = 0.0) -> RenderState:
    """slab in [0, 8) refreshes that x-slab; slab=-1 refreshes all eight
    (one logical grid update).  trainable, lambda_density: see
    _update_density_slab."""
    dev = state.density_grid.device
    kw = dict(decay=decay, trainable=trainable,
              lambda_density=lambda_density)
    if slab < 0:
        it0 = state.iter_density
        for s in range(GRID_UPDATE_SLABS):
            state = _update_density_slab(
                params, state, slab_noise(spec, generator, dev), spec,
                net_spec, max_level, s, **kw)
        return replace(state, iter_density=it0 + 1)
    return _update_density_slab(params, state, slab_noise(spec, generator, dev),
                                spec, net_spec, max_level, slab, **kw)


def mark_untrained_grid(state: RenderState, poses: np.ndarray, intrinsics,
                        spec: RenderSpec, aabb: Optional[np.ndarray] = None,
                        cam_near_far: Optional[np.ndarray] = None
                        ) -> RenderState:
    """Mark grid cells never seen by any training camera (or outside the
    AABB) with -1 so they stay unoccupied (reference renderer.py:985-1071).
    Once before training, on the grid's device: the JAX package's numpy
    pass in float32 op for op (the camera rotation summed in its einsum's
    order), so the marks equal it bit for bit; on the card it takes a
    fraction of a second where the host pass took 10-60 s at 1-5
    cascades."""
    H, CAS = spec.grid_size, spec.cascades
    dev = state.density_grid.device
    fx, fy, cx, cy = intrinsics
    # the quotients as numpy's float32 products see them
    ratio_x, ratio_y = float(np.float32(cx / fx)), float(np.float32(cy / fy))
    poses = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    B = poses.shape[0]

    ax = 2.0 * torch.arange(H, dtype=torch.float32, device=dev) / (H - 1) - 1.0
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    world = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    if aabb is None:
        rb = spec.bound
        aabb = np.array([-rb, -rb, -rb, rb, rb, rb], np.float32)
    aabb = torch.as_tensor(np.asarray(aabb, np.float32), device=dev)
    near = (None if cam_near_far is None else torch.as_tensor(
        np.asarray(cam_near_far, np.float32)[:, 0], device=dev))

    grid = state.density_grid.detach().clone()
    for cas in range(CAS):
        bound = min(2 ** cas, spec.grid_bound)
        half = bound / H
        pts = world * (bound - half)
        in_aabb = ((pts >= aabb[:3] - half) & (pts <= aabb[3:] + half)).all(-1)
        seen = torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)
        S = 16
        for head in range(0, B, S):
            P = poses[head:head + S]
            d = pts[None, :, :] - P[:, None, :3, 3]                 # [S, N, 3]
            R = P[:, :3, :3]
            # cam[..., r] = sum_c d[..., c] * R[c, r], summed c = 0, 1, 2
            cam = [(d[..., 0] * R[:, None, 0, r] + d[..., 1] * R[:, None, 1, r])
                   + d[..., 2] * R[:, None, 2, r] for r in range(3)]
            z = -cam[2]                 # camera forward is -z (renderer.py:1044)
            min_near = (spec.min_near if near is None
                        else near[head:head + S, None])
            vis = ((z > min_near)
                   & (cam[0].abs() < ratio_x * z + half * 2)
                   & (cam[1].abs() < ratio_y * z + half * 2))
            seen |= vis.any(dim=0)
        grid[cas].view(-1)[~(seen & in_aabb)] = -1.0
    return replace(state, density_grid=grid)


def sdf_inv_s(params: NeRFField) -> torch.Tensor:
    """The NeuS sharpness 1/s = exp(10 * variance), clipped to [1e-6, 1e6]."""
    return torch.exp(params.variance * 10.0).clamp(1e-6, 1e6)


def neus_alpha_from_sdf(sdf, normal, dirs, dts, inv_s, cos_anneal_ratio):
    """NeuS conversion of an SDF sample and its unit normal to an alpha
    (JAX renderer.neus_alpha_from_sdf): the SDF estimated half a step
    before and after the sample along the ray, through the logistic CDF."""
    true_cos = (dirs * normal).sum(dim=-1)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    est_prev = sdf - iter_cos * dts * 0.5
    est_next = sdf + iter_cos * dts * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    return ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)


def _sdf_alpha(params, x, sdf, dirs, dts, net_spec, epsilon, max_level,
               cos_anneal_ratio):
    """(NeuS alpha, raw FD normal) of the SDF samples sdf at x."""
    raw_normal = finite_diff_normal(params, x, net_spec, epsilon, max_level)
    alpha = neus_alpha_from_sdf(sdf, safe_normalize(raw_normal), dirs, dts,
                                sdf_inv_s(params), cos_anneal_ratio)
    return alpha, raw_normal


def compact_ids(flat_valid: torch.Tensor, P: int) -> torch.Tensor:
    """First P indices of the True entries of flat_valid [M], padded with M
    (an out-of-range id that writes nowhere) - ``jnp.nonzero(size=P,
    fill_value=M)`` without a host sync."""
    M = flat_valid.numel()
    pos = torch.cumsum(flat_valid.to(torch.int64), 0) - 1
    slot = torch.where(flat_valid & (pos < P), pos, torch.full_like(pos, P))
    ids = torch.full((P + 1,), M, dtype=torch.int64, device=flat_valid.device)
    ids.scatter_(0, slot, torch.arange(M, device=flat_valid.device))
    return ids[:P]


def _scatter_pool(values: torch.Tensor, ids: torch.Tensor, M: int):
    """out[ids[i]] = values[i] into zeros [M, ...]; ids == M are dropped
    (written into a spare row that is sliced off, never clamped)."""
    out = values.new_zeros((M + 1,) + values.shape[1:])
    out = out.index_copy(0, ids, values)
    return out[:M]


def render_train(
    params: NeRFField,
    occ_grid: torch.Tensor,
    rays_o: torch.Tensor,            # [N, 3]
    rays_d: torch.Tensor,            # [N, 3]
    bg_color: torch.Tensor,          # [N, 3] or [3]
    u: Optional[torch.Tensor],       # [N, num_fine] sampler noise
    spec: RenderSpec,
    net_spec: NetworkSpec,
    *,
    full_flag: bool = True,
    max_level: Optional[int] = None,
    aabb: Optional[torch.Tensor] = None,
    pool_size: Optional[int] = None,
    cos_anneal_ratio: float = 1.0,
    normal_epsilon: float = 1e-4,
    cam_near_far: Optional[torch.Tensor] = None,
    ind_code: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One training-mode volumetric render (reference renderer.py:676-748).

    cam_near_far [N, 2]: each ray's view near/far (enable_cam_near_far),
    which clamps the aabb's slab.  ind_code [N, ind_dim]: each ray's view's
    per-image code (ind_dim > 0).

    pool_size: valid samples are compacted into a pool of that size before
    the field evaluation, so the field costs O(pool) instead of
    O(rays * samples).  Rays whose valid samples did not fit leave the loss
    (`ray_kept`); `pool_overflow` counts the clipped samples.  In SDF mode
    the samples' alpha is NeuS's from the FD normal at normal_epsilon, and
    `normal` holds the raw normals of the evaluated points (zero at the
    out-of-pool slots, whose taps all clip to one corner)."""
    N = rays_o.shape[0]
    if aabb is None:
        rb = spec.bound
        aabb = torch.tensor([-rb, -rb, -rb, rb, rb, rb], device=rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, spec.min_near)
    if cam_near_far is not None:
        nears = torch.maximum(nears, cam_near_far[:, 0])
        fars = torch.minimum(fars, cam_near_far[:, 1])
    m = sample_rays(
        rays_o, rays_d, occ_grid, nears, fars,
        num_coarse=spec.num_coarse, num_fine=spec.num_fine,
        grid_size=spec.grid_size, cascades=spec.cascades, bound=spec.bound,
        contracted=spec.contract, dt_gamma=spec.dt_gamma,
        max_steps=spec.max_steps, u=u)
    K = spec.num_fine
    pts = m.xyzs.reshape(N * K, 3).detach()
    dirs = safe_normalize(rays_d)

    if pool_size is None:
        dirs_flat = dirs[:, None, :].expand(N, K, 3).reshape(N * K, 3)
        c_flat = (None if ind_code is None else
                  ind_code[:, None, :].expand(N, K, -1).reshape(N * K, -1))
        sigmas, rgbs, speculars, enc_cnt = field_forward(
            params, pts, dirs_flat, net_spec, full_flag, max_level, c_flat)
        if spec.sdf:
            sigmas, normal = _sdf_alpha(
                params, pts, sigmas, dirs_flat, m.dts.reshape(-1), net_spec,
                normal_epsilon, max_level, cos_anneal_ratio)
        sig_nk, rgb_nk = sigmas.reshape(N, K), rgbs.reshape(N, K, 3)
        pp_xyz, pp_valid, pp_spec = pts, m.valid.reshape(-1), speculars
        ray_kept = torch.ones((N,), dtype=torch.bool, device=rays_o.device)
        pool_overflow = torch.zeros((), dtype=torch.int64, device=rays_o.device)
    else:
        P = int(pool_size)
        flat_valid = m.valid.reshape(-1)
        ids = compact_ids(flat_valid, P)                     # [P], N*K = pad
        in_pool = torch.arange(P, device=ids.device) < m.total
        ids_c = ids.clamp(max=N * K - 1)
        sentinel = 3.0 * spec.bound                          # x01 -> 2.0 (oob)
        x_pool = torch.where(in_pool[:, None], pts[ids_c], sentinel)
        d_pool = dirs[ids_c // K]

        c_pool = None if ind_code is None else ind_code[ids_c // K]
        sigmas_p, rgbs_p, spec_p, enc_cnt = field_forward(
            params, x_pool, d_pool, net_spec, full_flag, max_level, c_pool)
        if spec.sdf:
            sigmas_p, normal = _sdf_alpha(
                params, x_pool, sigmas_p, d_pool, m.dts.reshape(-1)[ids_c],
                net_spec, normal_epsilon, max_level, cos_anneal_ratio)
        sigmas_p = torch.where(in_pool, sigmas_p, 0.0)
        rgbs_p = torch.where(in_pool[:, None], rgbs_p, 0.0)
        sig_nk = _scatter_pool(sigmas_p, ids, N * K).reshape(N, K)
        rgb_nk = _scatter_pool(rgbs_p, ids, N * K).reshape(N, K, 3)

        kept_slot = _scatter_pool(torch.ones_like(sigmas_p), ids, N * K)
        dropped = flat_valid & (kept_slot == 0.0)
        ray_kept = ~dropped.reshape(N, K).any(dim=1)
        pool_overflow = (m.total - P).clamp(min=0)
        pp_xyz, pp_valid, pp_spec = x_pool, in_pool, spec_p

    out = composite_rays(sig_nk, rgb_nk, m.ts, m.dts, m.valid,
                         T_thresh=spec.T_thresh, alpha_mode=spec.sdf)
    image = out["image"] + (1.0 - out["weights_sum"][:, None]) * bg_color
    results = dict(
        image=image,
        depth=out["depth"],
        weights_sum=out["weights_sum"],
        weights=out["weights"].reshape(-1),
        xyzs=pp_xyz,
        valid=m.valid.reshape(-1),
        pp_valid=pp_valid,
        num_points=m.total,
        ray_kept=ray_kept,
        pool_overflow=pool_overflow,
        speculars=pp_spec,
        encode_resid=enc_cnt,
    )
    if spec.sdf:
        results["normal"] = normal
    return results


@torch.no_grad()
def render_eval_segment(
    params: NeRFField,
    occ_grid: torch.Tensor,
    rays_o: torch.Tensor,            # [N, 3]
    rays_d: torch.Tensor,            # [N, 3]
    nears: torch.Tensor,             # [N] segment start (advances across calls)
    fars: torch.Tensor,              # [N]
    sample_dt: torch.Tensor,         # [N] fixed sample spacing
    spec: RenderSpec,
    net_spec: NetworkSpec,
    *,
    shading: str = "full",
) -> Dict[str, torch.Tensor]:
    """One segment of the early-exit eval march (reference renderer.py:
    749-802, raymarching.cu:750-832).

    Places spec.num_fine samples at the fixed spacing sample_dt from
    `nears`, composites them with transmittance starting at 1, and reports
    where the march stopped (`t_exit`).  The caller accumulates across
    segments and drops finished rays.  No background here.  In SDF mode
    the alpha is NeuS's with the FD normal at epsilon 1e-4 and the cos
    anneal ratio 1 (7 encodes a sample).

    Only the valid samples go through the field: an exact compaction to
    their count (one host sync).  The JAX package's fixed-size pool with a
    lax.cond dense fallback was a static-shape device workaround and gives
    the same values."""
    N, K = rays_o.shape[0], spec.num_fine
    m = sample_rays(
        rays_o, rays_d, occ_grid, nears, fars,
        num_coarse=spec.num_coarse, num_fine=K, grid_size=spec.grid_size,
        cascades=spec.cascades, bound=spec.bound, contracted=spec.contract,
        dt_gamma=spec.dt_gamma, max_steps=spec.max_steps, sample_dt=sample_dt)
    ids = torch.nonzero(m.valid.reshape(-1))[:, 0]
    sig = torch.zeros((N * K,), device=rays_o.device)
    rgb = torch.zeros((N * K, 3), device=rays_o.device)
    if ids.numel():
        dirs = safe_normalize(rays_d)
        x_v, d_v = m.xyzs.reshape(N * K, 3)[ids], dirs[ids // K]
        sig_v, rgb_v, _, _ = field_forward(params, x_v, d_v, net_spec,
                                           shading != "diffuse")
        if spec.sdf:
            sig_v, _ = _sdf_alpha(params, x_v, sig_v, d_v,
                                  m.dts.reshape(-1)[ids], net_spec, 1e-4,
                                  None, 1.0)
        sig[ids] = sig_v
        rgb[ids] = rgb_v
    out = composite_rays(sig.reshape(N, K), rgb.reshape(N, K, 3), m.ts, m.dts,
                         m.valid, T_thresh=spec.T_thresh, alpha_mode=spec.sdf)
    return {
        "image": out["image"],                 # pre-background contribution
        "depth": out["depth"],
        "weights_sum": out["weights_sum"],     # 1 - T_end within the segment
        "t_exit": m.t_exit,
    }


def eval_spacing(rays_o, rays_d, occ_grid, aabb, spec: RenderSpec,
                 eval_fine: int):
    """(nears, fars, occupied length, per-ray sample spacing) of the eval
    march: the occupied length spread over eval_fine samples, at least the
    schedule's dt_min."""
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, spec.min_near)
    olen = occupied_length(
        rays_o, rays_d, occ_grid, nears, fars, num_coarse=spec.num_coarse,
        grid_size=spec.grid_size, cascades=spec.cascades, bound=spec.bound,
        contracted=spec.contract, dt_gamma=spec.dt_gamma,
        max_steps=spec.max_steps)
    dt_min = 2.0 * math.sqrt(3.0) / spec.max_steps
    return nears, fars, olen, (olen / eval_fine).clamp(min=dt_min)


@torch.no_grad()
def render_frame_queue(
    params: NeRFField,
    occ_grid: torch.Tensor,
    rays_o: torch.Tensor,            # [N, 3] all rays of the frame
    rays_d: torch.Tensor,            # [N, 3]
    aabb: torch.Tensor,              # [6]
    spec: RenderSpec,                # spec.num_fine = samples per segment
    net_spec: NetworkSpec,
    *,
    chunk: int = 8192,
    shading: str = "full",
    eval_fine: int = 128,
) -> Dict[str, torch.Tensor]:
    """Whole-frame early-exit march over a queue of alive rays.

    Per-ray march state (accumulated rgb/depth, transmittance T, current t,
    alive flag) lives in dense [N] tensors on the device.  Each round takes
    the first `chunk` rays of a stable "alive first" order, marches them
    one `spec.num_fine`-sample segment, scatters the accumulators back and
    updates the alive flags; the loop ends when no ray is alive (a host
    sync per round, besides the segment's compaction) or after the safety
    bound of
    ceil(N / chunk) * max(2 * max_steps / num_fine, 2) rounds.  The JAX
    package runs the same loop inside one lax.while_loop.  Returns
    pre-background image/depth/weights_sum and the number of rounds."""
    n, K = rays_o.shape[0], spec.num_fine
    chunk = min(chunk, n)
    nears, fars, olen, spacing = eval_spacing(rays_o, rays_d, occ_grid, aabb,
                                              spec, eval_fine)
    image = torch.zeros((n, 3), device=rays_o.device)
    depth = torch.zeros((n,), device=rays_o.device)
    T = torch.ones((n,), device=rays_o.device)
    tcur = nears.clone()
    alive = olen > 0.0
    max_iters = -(-n // chunk) * max(2 * spec.max_steps // max(K, 1), 2)
    it = 0
    while it < max_iters and bool(alive.any()):
        # stable sort: alive rays first, original order preserved
        order = torch.argsort((~alive).to(torch.uint8), stable=True)
        idx = order[:chunk]
        a_sel = alive[idx]
        fr_sel = fars[idx]
        seg = render_eval_segment(
            params, occ_grid, rays_o[idx], rays_d[idx],
            torch.where(a_sel, tcur[idx], 1.0),
            torch.where(a_sel, fr_sel, 0.0),        # dead: no samples
            spacing[idx], spec, net_spec, shading=shading)
        Ti = T[idx]
        w = torch.where(a_sel, Ti, 0.0)
        image[idx] += w[:, None] * seg["image"]
        depth[idx] += w * seg["depth"]
        Tn = torch.where(a_sel, Ti * (1.0 - seg["weights_sum"]), Ti)
        T[idx] = Tn
        tprev = tcur[idx]
        tn = torch.where(a_sel, seg["t_exit"], tprev)
        tcur[idx] = tn
        alive[idx] = a_sel & (Tn > spec.T_thresh) & (tn <= fr_sel) & (tn > tprev)
        it += 1
    return {"image": image, "depth": depth, "weights_sum": 1.0 - T,
            "iters": it}
