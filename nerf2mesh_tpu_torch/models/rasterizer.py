"""Differentiable triangle rasterizer (port of nerf2mesh_tpu/models/rasterizer.py).

The JAX rasterizer is plain XLA, not a Pallas kernel, so this port is plain
PyTorch.  Same design: a crop of the frame is rasterized at a time; the
triangles overlapping it are compacted to a fixed budget K (in index order,
`overflow` counts the rest); each slot rasterizes an 8x8 fragment block over
its screen bbox; the live fragments are compacted to a budget P
(`frag_overflow` joins `overflow`); the depth resolve is two scatter-mins
(depth key, then the lowest fragment id among the ties); barycentrics, depth
and coverage are recomputed per winning fragment so that autograd gives
d(pixel)/d(clip vertices).

Compactions sort a masked iota, as JAX's live-fragment compaction does:
no host sync and no data-dependent shapes (``torch.nonzero`` would sync
and vary in size); rows a scatter drops go to dump slots spread by row.  Where the JAX function stops gradients this one
detaches, and nowhere else; clamps that JAX writes as jnp.clip/maximum/
minimum are written with torch.maximum/minimum, whose gradient at a tie is
split in half as JAX's is (torch.clamp passes it whole).

Coordinate conventions follow the reference MVP: clip = mvp @ [v, 1];
screen x = (ndc.x+1)/2*W, row y = (ndc.y+1)/2*H; depth = ndc z.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class RasterSpec:
    crop: int = 128            # crop side in pixels
    max_tris: int = 8192       # triangle budget per crop after compaction
    frag: int = 8              # fragment block side: frag x frag superpixels
    soft_px: float = float(np.sqrt(2.0))  # softness radius of edge alpha (px)
    # live-fragment budget: pixel scatters run on this many compacted rows
    max_frags: int = 1 << 20


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, x.new_tensor(c))


def _minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, x.new_tensor(c))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: maximum then minimum (half the gradient at a bound)."""
    return _minimum(_maximum(x, lo), hi)


# The two small fp32 dots below are written out instead of matmuls: TF32
# would round their operands to 10 bits (the JAX package forces
# Precision.HIGHEST for both), and summed in the order XLA's CPU dot sums
# them, so the extrapolated barycentrics of rim fragments (sensitive to an
# ulp of a clip coordinate) round as the JAX package's do.

def transform_clip(verts: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """[V, 3] world -> [V, 4] clip in true fp32: a rounded clip coordinate
    wobbles the rim.  Summed pairwise, (p0 + p1) + (p2 + p3)."""
    v1 = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=-1)
    p = v1[:, None, :] * mvp.to(v1.dtype)[None, :, :]              # [V, 4, 4]
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] in fp32 as a chain of fused multiply-adds
    in k order."""
    out = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        out = torch.addcmul(out, a[..., k], b[..., k])
    return out


# Rows that a resolve scatter must drop go to one of DUMP slots past the
# crop's pixels, spread by row, and dead rows of a gather read spread
# indices (their values are masked): otherwise the scatter's atomics, and
# the gather's backward (an accumulating index_put), all hit one address,
# millions of rows a crop, and serialize on the card.
DUMP = 1024


def take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx] along dim 0 for an index tensor of any shape, as index_select:
    its backward adds with atomics, where advanced indexing's backward sorts
    the indices first (tens of ms a crop on the card)."""
    return torch.index_select(a, 0, idx.reshape(-1)).reshape(
        *idx.shape, *a.shape[1:])


def _spread(n: int, size: int, device) -> torch.Tensor:
    """[n] indices 0, 1, .. wrapped into [0, size)."""
    return torch.arange(n, device=device) % max(size, 1)


def compact_ids(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The indices of the True entries of the 1-D `mask`, ascending, in a
    [size] int64 tensor padded with len(mask) (jnp.nonzero(mask, size=size,
    fill_value=len(mask))); entries past `size` are dropped.  A sort of the
    masked iota, as the JAX package's live-fragment compaction: no host
    sync, and no scatter into one dump slot."""
    n = mask.shape[0]
    iota = torch.arange(n, device=mask.device)
    ids = torch.sort(torch.where(mask, iota, n)).values[:size]
    if size > n:
        ids = torch.cat([ids, ids.new_full((size - n,), n)])
    return ids


def _origin(crop_origin, device) -> Tuple[torch.Tensor, torch.Tensor]:
    o = torch.as_tensor(crop_origin, device=device).to(torch.float32)
    return o[0], o[1]


def rasterize_crop(
    verts_clip: torch.Tensor,     # [V, 4]
    tris: torch.Tensor,           # [F, 3] int
    crop_origin,                  # (y0, x0) in pixels: ints or a [2] tensor
    H: int, W: int,
    spec: RasterSpec = RasterSpec(),
    f_valid=None,                 # faces >= f_valid are padding
) -> Dict[str, torch.Tensor]:
    """Rasterize the [crop x crop] window at crop_origin.

    Returns, per crop pixel: tri_id [C, C] (-1 = empty), bary [C, C, 3]
    perspective-correct, depth [C, C] ndc z, alpha (soft coverage), area
    (exact area sum of front fragments), union (4x4-subsample union), covered
    and strict coverage masks, win_slot (the winner's K slot), and per slot
    the screen coords tri_sx/tri_sy [K, 3]; overflow (triangles past K plus
    fragments past max_frags), n_live and n_overlap as 0-d tensors.
    bary/depth/alpha/area are differentiable w.r.t. verts_clip."""
    Cp, K, B = spec.crop, spec.max_tris, spec.frag
    F = tris.shape[0]
    dev = verts_clip.device
    f32 = torch.float32
    tris = tris.long()

    w = verts_clip[:, 3]
    safe_w = torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)
    ndc = verts_clip[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] + 1.0) * 0.5 * W
    sy = (ndc[:, 1] + 1.0) * 0.5 * H
    sz = ndc[:, 2]

    y0, x0 = _origin(crop_origin, dev)

    # --- triangle setup (dense over all F)
    tx, ty, tw, tz = (take_rows(a, tris) for a in (sx, sy, w, sz))   # [F, 3]
    xmin, xmax = tx.amin(-1), tx.amax(-1)
    ymin, ymax = ty.amin(-1), ty.amax(-1)
    in_front = (tw > 1e-6).all(-1)
    overlaps = (in_front & (xmax >= x0) & (xmin < x0 + Cp)
                & (ymax >= y0) & (ymin < y0 + Cp))
    if f_valid is not None:
        overlaps = overlaps & (torch.arange(F, device=dev) < f_valid)

    # --- compact overlapping triangles to K slots (index order); triangles
    # past the budget are dropped and counted
    n_overlap = overlaps.sum()
    overflow = (n_overlap - K).clamp(min=0)
    slot_idx = compact_ids(overlaps, K)
    valid_tri = slot_idx < F
    sid = torch.where(valid_tri, slot_idx, _spread(K, F, dev))

    ktx, kty, ktw, ktz = (take_rows(a, sid) for a in (tx, ty, tw, tz))  # [K, 3]
    kxmin, kymin, kxmax, kymax = (take_rows(a, sid)
                                  for a in (xmin, ymin, xmax, ymax))

    # --- fragment generation: B x B superpixel block over each tri bbox
    # (stride 1 px when the bbox fits in B, else strided)
    with torch.no_grad():
        bx0 = (kxmin - x0).floor().clamp(0, Cp - 1)
        by0 = (kymin - y0).floor().clamp(0, Cp - 1)
        bx1 = (kxmax - x0).ceil().clamp(1, Cp)
        by1 = (kymax - y0).ceil().clamp(1, Cp)
        stx = ((bx1 - bx0) / B).clamp(min=1.0)
        sty = ((by1 - by0) / B).clamp(min=1.0)
        ii = torch.arange(B, dtype=f32, device=dev)
        px = (bx0[:, None] + ii[None, :] * stx[:, None]).floor()  # [K, B] col
        py = (by0[:, None] + ii[None, :] * sty[:, None]).floor()  # [K, B] row

    cx = (x0 + px[:, None, :] + 0.5).expand(K, B, B)
    cy = (y0 + py[:, :, None] + 0.5).expand(K, B, B)

    # edge functions / screen barycentrics
    x1, x2, x3 = (ktx[:, i, None, None] for i in range(3))
    y1, y2, y3 = (kty[:, i, None, None] for i in range(3))
    det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)            # [K,1,1]
    # sign-preserving clamp away from 0
    det_safe = torch.where(det < 0, -1.0, 1.0) * _maximum(det.abs(), 1e-12)
    l1 = ((x2 - cx) * (y3 - cy) - (x3 - cx) * (y2 - cy)) / det_safe
    l2 = ((x3 - cx) * (y1 - cy) - (x1 - cx) * (y3 - cy)) / det_safe
    l3 = 1.0 - l1 - l2                                             # [K, B, B]

    def edge_dist(l, xa, ya, xb, yb):
        elen = torch.sqrt((xb - xa) ** 2 + (yb - ya) ** 2 + 1e-12)
        return l * det_safe.abs() / elen                           # ~ px

    d1 = edge_dist(l1, x2, y2, x3, y3)
    d2 = edge_dist(l2, x3, y3, x1, y1)
    d3 = edge_dist(l3, x1, y1, x2, y2)
    sdist = torch.minimum(torch.minimum(d1, d2), d3)               # >0 inside
    alpha = torch.sigmoid(sdist * (4.0 / spec.soft_px))

    # fade near-degenerate projections (silhouette slivers) by the inradius
    perim = (torch.sqrt((x2 - x1) ** 2 + (y2 - y1) ** 2 + 1e-12)
             + torch.sqrt((x3 - x2) ** 2 + (y3 - y2) ** 2 + 1e-12)
             + torch.sqrt((x1 - x3) ** 2 + (y1 - y3) ** 2 + 1e-12))
    r_in = det.abs() / _maximum(perim, 1e-12)                      # [K,1,1]
    alpha = alpha * _clip(r_in / (0.25 * spec.soft_px), 0.0, 1.0)
    degen = r_in.detach() < 0.02                                   # [K,1,1]

    # exact half-plane inside test
    strict_in = (l1.detach() >= 0.0) & (l2.detach() >= 0.0) & (
        l3.detach() >= 0.0)

    # rasterize the near-edge band too (half the pixel diagonal)
    inside = sdist > -0.7072
    in_crop = ((px[:, None, :] >= 0) & (px[:, None, :] < Cp)
               & (py[:, :, None] >= 0) & (py[:, :, None] < Cp))
    live = inside & in_crop & valid_tri[:, None, None]

    # perspective-correct barycentrics + depth
    iw1, iw2, iw3 = (1.0 / ktw[:, i, None, None] for i in range(3))
    denom = l1 * iw1 + l2 * iw2 + l3 * iw3
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    b1 = l1 * iw1 / denom
    b2 = l2 * iw2 / denom
    b3 = 1.0 - b1 - b2
    z1, z2, z3 = (ktz[:, i, None, None] for i in range(3))
    depth = l1 * z1 + l2 * z2 + l3 * z3

    # --- resolve: scatter-min of the depth key, then the lowest fragment id
    live_flat = live.reshape(-1)
    pix = (py[:, :, None] * Cp + px[:, None, :]).long().expand(K, B, B)
    NF = K * B * B
    C2 = Cp * Cp
    NP = C2 + DUMP
    dump = C2 + torch.arange(NF, device=dev).reshape(K, B, B) % DUMP
    pix_flat = torch.where(live, pix, dump).reshape(-1)
    depth_det = torch.where(live_flat, depth.detach().reshape(-1), math.inf)
    # strictly-inside fragments win over near-edge outside ones (+4) and
    # degenerate projections only as a last resort (+8)
    outside = ~strict_in.reshape(-1)
    degen_f = degen.expand(K, B, B).reshape(-1)
    depth_key = (depth_det + torch.where(outside, 4.0, 0.0)
                 + torch.where(degen_f, 8.0, 0.0))
    depth_key = torch.where(live_flat, depth_key, math.inf)

    # --- live-fragment compaction to P rows
    P = min(spec.max_frags, NF)
    lid_raw = compact_ids(live_flat, P)
    valid_f = lid_raw < NF
    lid = torch.where(valid_f, lid_raw, _spread(P, NF, dev))
    n_live = live_flat.sum()
    frag_overflow = (n_live - P).clamp(min=0)

    pixc = torch.where(valid_f, pix_flat[lid],
                       C2 + torch.arange(P, device=dev) % DUMP)
    keyc = torch.where(valid_f, depth_key[lid], math.inf)

    zmin = torch.full((NP,), math.inf, dtype=f32, device=dev).scatter_reduce_(
        0, pixc, keyc, "amin")
    frag_wins = keyc <= zmin[pixc] + 1e-9
    cand = torch.where(frag_wins & valid_f, lid, NF)
    win_id = torch.full((NP,), NF, dtype=torch.int64,
                        device=dev).scatter_reduce_(0, pixc, cand, "amin")

    covered_flat = win_id[:C2] < NF
    win_safe = torch.where(covered_flat, win_id[:C2], _spread(C2, NF, dev))

    def resolve(field):
        out = take_rows(field.reshape(-1), win_safe)
        return torch.where(covered_flat, out, 0.0).reshape(Cp, Cp)

    out_tri = torch.where(covered_flat, sid[win_safe // (B * B)],
                          -1).reshape(Cp, Cp)
    covered = covered_flat.reshape(Cp, Cp)

    # --- exact per-fragment pixel coverage: signed per-edge integral of the
    # covered x-interval over the pixel row (convex polygon n box)
    X0 = (x0 + px[:, None, :]).expand(K, B, B)
    Y0 = (y0 + py[:, :, None]).expand(K, B, B)

    def G(u, v):
        # mean of max(lerp(u, v, s), 0) over s in [0, 1]
        du = u - v
        small = du.abs() < 1e-8
        du_safe = torch.where(small, 1.0, du)
        exact = (_maximum(u, 0.0) ** 2 - _maximum(v, 0.0) ** 2) / (
            2.0 * du_safe)
        return torch.where(small, _maximum(0.5 * (u + v), 0.0), exact)

    def edge_area(xa, ya, xb, yb):
        uy1, uy2 = ya - Y0, yb - Y0
        dy = uy2 - uy1
        dy_safe = torch.where(dy.abs() < 1e-12, 1e-12, dy)
        t_at0 = (0.0 - uy1) / dy_safe
        t_at1 = (1.0 - uy1) / dy_safe
        t0 = _clip(torch.where(dy > 0, t_at0, t_at1), 0.0, 1.0)
        t1 = _clip(torch.where(dy > 0, t_at1, t_at0), 0.0, 1.0)
        t1 = torch.maximum(t1, t0)
        xu = xa + t0 * (xb - xa) - X0
        xv = xa + t1 * (xb - xa) - X0
        sy_ = (uy1 + t1 * dy) - (uy1 + t0 * dy)   # signed y-span swept
        return sy_ * (G(xu, xv) - G(xu - 1.0, xv - 1.0))

    frag_area = (edge_area(x1, y1, x2, y2) + edge_area(x2, y2, x3, y3)
                 + edge_area(x3, y3, x1, y1))      # [K, B, B], signed

    # coverage alpha: max over all live fragments; pixel centers strictly
    # inside any triangle are opaque
    g1x = ((y2 - y3) / det_safe).detach().expand(K, B, B)
    g1y = ((x3 - x2) / det_safe).detach().expand(K, B, B)
    g2x = ((y3 - y1) / det_safe).detach().expand(K, B, B)
    g2y = ((x1 - x3) / det_safe).detach().expand(K, B, B)
    vf = valid_f.to(f32)
    strict_ok = (strict_in & ~degen).expand(K, B, B).reshape(-1)
    pc_alpha = take_rows(alpha.reshape(-1), lid) * vf
    pc_strict = strict_ok[lid].to(f32) * vf
    pc_area = take_rows(frag_area.reshape(-1), lid) * vf
    pc_l1 = l1.detach().reshape(-1)[lid] * vf
    pc_l2 = l2.detach().reshape(-1)[lid] * vf
    pc_g = [g.reshape(-1)[lid] * vf for g in (g1x, g1y, g2x, g2y)]
    pc_degen = degen_f[lid].to(f32) * vf

    alpha_img = torch.zeros((NP,), dtype=f32, device=dev).scatter_reduce(
        0, pixc, pc_alpha, "amax")[:C2]
    covered_strict = torch.zeros((NP,), dtype=f32,
                                 device=dev).scatter_reduce_(
        0, pixc, pc_strict, "amax")[:C2]
    alpha_img = torch.maximum(alpha_img, covered_strict)

    # --- 4x4-subsample union coverage (value only)
    with torch.no_grad():
        su = (torch.arange(4, dtype=f32, device=dev) + 0.5) / 4.0 - 0.5
        sux = su.repeat(4)[None, :]                                # [1, 16]
        suy = su.repeat_interleave(4)[None, :]
        l1s = pc_l1[:, None] + pc_g[0][:, None] * sux + pc_g[1][:, None] * suy
        l2s = pc_l2[:, None] + pc_g[2][:, None] * sux + pc_g[3][:, None] * suy
        l3s = 1.0 - l1s - l2s
        m16 = ((l1s >= 0.0) & (l2s >= 0.0) & (l3s >= 0.0)
               & (pc_degen[:, None] < 0.5) & valid_f[:, None]).to(f32)
        union16 = torch.zeros((NP, 16), dtype=f32,
                              device=dev).scatter_reduce_(
            0, pixc[:, None].expand(-1, 16), m16, "amax")[:C2]
        union16_img = union16.mean(-1)

    # exact-area union coverage of the front surface: the majority sign of
    # the depth winners' screen determinants picks the front winding
    det_k = det_safe[:, 0, 0].detach()
    det_win = det_k[win_safe // (B * B)]
    vote = torch.where(covered_flat, torch.sign(det_win), 0.0).sum()
    facing = torch.where(vote >= 0.0, 1.0, -1.0)
    area_c = _maximum(pc_area * facing, 0.0)
    area_img = torch.zeros((NP,), dtype=f32, device=dev).index_add(
        0, pixc, area_c)[:C2]
    area_img = _clip(area_img, 0.0, 1.0)

    win_slot = torch.where(covered_flat, win_safe // (B * B),
                           -1).reshape(Cp, Cp)

    return {
        "tri_id": out_tri,
        "bary": torch.stack([resolve(b1), resolve(b2), resolve(b3)], dim=-1),
        "depth": resolve(depth),
        "alpha": _clip(alpha_img.reshape(Cp, Cp), 0.0, 1.0),
        "area": area_img.reshape(Cp, Cp),
        "union": union16_img.reshape(Cp, Cp),
        "covered": covered,
        "strict": covered_strict.reshape(Cp, Cp) > 0.5,
        "win_slot": win_slot,
        # a dead slot reads face 0, as the JAX package's compaction does
        "tri_sx": torch.where(valid_tri[:, None], ktx, tx[:1]),
        "tri_sy": torch.where(valid_tri[:, None], kty, ty[:1]),
        "overflow": overflow + frag_overflow,
        "n_live": n_live,
        "n_overlap": n_overlap,
    }


def _aa_pairs(rgba, slot, strict, depth, tsx, tsy, y0, x0,
              depth_eps: float) -> torch.Tensor:
    """Antialias deltas for horizontally adjacent pixel pairs: rgba
    [H, W, C]; slot [H, W]; strict [H, W] bool; depth [H, W]; tsx/tsy [K, 3]
    screen coords per triangle slot.  Returns the delta image to add."""
    Hc, Wc = slot.shape
    dev = rgba.device
    sl_p, sl_q = slot[:, :-1], slot[:, 1:]
    st_p, st_q = strict[:, :-1], strict[:, 1:]
    d_p, d_q = depth[:, :-1], depth[:, 1:]

    both = st_p & st_q & (sl_p != sl_q) & ((d_p - d_q).abs() > depth_eps)
    fg_p = (st_p & ~st_q) | (both & (d_p <= d_q))
    fg_q = (st_q & ~st_p) | (both & (d_q < d_p))
    active = fg_p | fg_q

    fgslot = torch.where(fg_p, sl_p, sl_q)
    safe = torch.where(fgslot >= 0, fgslot,
                       _spread(fgslot.numel(), tsx.shape[0], dev).reshape(
                           fgslot.shape)).reshape(-1)
    xs = take_rows(tsx, safe).reshape(Hc, Wc - 1, 3)
    ys = take_rows(tsy, safe).reshape(Hc, Wc - 1, 3)

    cy = y0 + torch.arange(Hc, dtype=torch.float32, device=dev)[:, None] + 0.5
    cxp = x0 + torch.arange(Wc - 1, dtype=torch.float32,
                            device=dev)[None, :] + 0.5

    ya = ys - cy[..., None]
    yb = torch.roll(ya, -1, dims=-1)
    xa, xb = xs, torch.roll(xs, -1, dims=-1)
    crossing = (ya * yb) < 0.0
    denom = ya - yb
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    t = ya / denom
    xc = xa + t * (xb - xa)
    in_seg = crossing & (xc >= cxp[..., None]) & (xc <= cxp[..., None] + 1.0)

    xc_min = torch.where(in_seg, xc, math.inf).amin(-1)
    xc_max = torch.where(in_seg, xc, -math.inf).amax(-1)
    has = in_seg.any(-1)
    xc_sel = torch.where(fg_p, xc_min, xc_max)
    u = _clip(xc_sel - cxp, 0.0, 1.0)
    cov = torch.where(fg_p, u, 1.0 - u)
    cov = torch.where(active & has, cov, 0.5)    # 0.5 -> zero delta

    f = torch.where(fg_p[..., None], rgba[:, :-1], rgba[:, 1:])
    g = torch.where(fg_p[..., None], rgba[:, 1:], rgba[:, :-1])
    w_other = _maximum(cov - 0.5, 0.0)[..., None]
    w_fg = _maximum(0.5 - cov, 0.0)[..., None]
    delta_fg = w_fg * (g - f)
    delta_other = w_other * (f - g)
    dp = torch.where(fg_p[..., None], delta_fg, delta_other)
    dq = torch.where(fg_p[..., None], delta_other, delta_fg)

    zero = torch.zeros_like(rgba[:, :1])
    return torch.cat([dp, zero], dim=1) + torch.cat([zero, dq], dim=1)


def antialias(rgba: torch.Tensor, rast: Dict[str, torch.Tensor],
              crop_origin, depth_eps: float = 0.02) -> torch.Tensor:
    """Analytic edge antialiasing (dr.antialias analog): every horizontally
    or vertically adjacent pixel pair whose strict coverage flips, or whose
    winners differ across a depth gap, is blended by the exact 1-D coverage
    of the nearer triangle's edge between the two pixel centers.  The blend
    weight is differentiable w.r.t. the edge's screen vertices.

    rgba: [C, C, 4+] composited image + alpha at the rast resolution."""
    y0, x0 = _origin(crop_origin, rgba.device)
    slot, strict, depth = rast["win_slot"], rast["strict"], rast["depth"]
    tsx, tsy = rast["tri_sx"], rast["tri_sy"]
    dh = _aa_pairs(rgba, slot, strict, depth, tsx, tsy, y0, x0, depth_eps)
    dv = _aa_pairs(rgba.transpose(0, 1), slot.t(), strict.t(), depth.t(),
                   tsy, tsx, x0, y0, depth_eps).transpose(0, 1)
    return rgba + dh + dv


def interpolate(attrs: torch.Tensor, rast: Dict[str, torch.Tensor],
                tris: torch.Tensor) -> torch.Tensor:
    """Per-pixel attribute interpolation (dr.interpolate analog): attrs
    [V, C] -> [C, C, C'] by the crop's tri_id and perspective-correct
    barycentrics, 0 where not covered; in true fp32 (no TF32): the
    interpolated positions feed the field queries."""
    tri_id = rast["tri_id"]
    corner = tris.long()[tri_id.clamp(min=0).reshape(-1)]           # [P, 3]
    a = take_rows(attrs, corner).reshape(corner.shape[0], 3, -1)
    b = rast["bary"].reshape(-1, 3)
    out = _dot_last(a.transpose(1, 2), b[:, None, :])
    out = torch.where(rast["covered"].reshape(-1, 1), out, 0.0)
    return out.reshape(*tri_id.shape, -1)


@torch.no_grad()
def rasterize_trig_id(verts: torch.Tensor, tris: torch.Tensor,
                      mvp: torch.Tensor, H: int, W: int, crop: int = 256,
                      face_chunk: int = 1 << 18) -> np.ndarray:
    """Full-frame triangle-id buffer by looping crops (visibility culling).
    Returns [H, W] int32 on the host, -1 empty.  Meshes bigger than
    `face_chunk` are rasterized in face chunks with a z-merge across
    chunks (winner = the least depth)."""
    clip = transform_clip(verts, mvp)
    F = int(tris.shape[0])
    K = 1 << int(np.ceil(np.log2(max(min(F, face_chunk), 2))))
    spec = RasterSpec(crop=crop, max_tris=K)
    out = np.full((H, W), -1, np.int32)
    best = np.full((H, W), np.inf, np.float32)
    for f0 in range(0, F, face_chunk):
        sub = tris[f0:min(f0 + face_chunk, F)]
        for y0 in range(0, H, crop):
            for x0 in range(0, W, crop):
                r = rasterize_crop(clip, sub, (y0, x0), H, W, spec)
                tile = r["tri_id"].cpu().numpy()
                d = r["depth"].cpu().numpy()
                cov = tile >= 0
                d = np.where(cov, d, np.inf)
                h = min(crop, H - y0)
                wdt = min(crop, W - x0)
                win = d[:h, :wdt] < best[y0:y0 + h, x0:x0 + wdt]
                sel = win & cov[:h, :wdt]
                region = out[y0:y0 + h, x0:x0 + wdt]
                region[sel] = tile[:h, :wdt][sel] + f0
                best[y0:y0 + h, x0:x0 + wdt][win] = d[:h, :wdt][win]
    return out


def subdivide_for_raster(verts: np.ndarray, tris: np.ndarray,
                         max_edge: float,
                         max_faces: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: midpoint-subdivide triangles until no edge exceeds
    max_edge (world units), so each triangle's screen bbox fits its
    fragment block.  max_faces > 0 is a hard face budget: only the largest
    faces are split when splitting all would bust it, and the loop stops at
    the budget."""
    from ..meshing.meshops import midpoint_subdivide
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int64)
    for _ in range(16):
        e = np.stack([
            np.linalg.norm(verts[tris[:, 0]] - verts[tris[:, 1]], axis=-1),
            np.linalg.norm(verts[tris[:, 1]] - verts[tris[:, 2]], axis=-1),
            np.linalg.norm(verts[tris[:, 2]] - verts[tris[:, 0]], axis=-1),
        ], -1).max(-1)
        big = e > max_edge
        n_big = int(big.sum())
        if n_big == 0:
            break
        if max_faces > 0:
            n_budget = max(max_faces - len(tris), 0) // 3
            if n_budget == 0:
                print(f"[subdivide_for_raster] face budget {max_faces} "
                      f"reached with {n_big} faces still over max_edge="
                      f"{max_edge:.4g}; stopping (strided fragment blocks "
                      f"cover the remainder)")
                break
            if n_big > n_budget:
                order = np.argsort(-e)[:n_budget]
                big = np.zeros(len(tris), bool)
                big[order] = True
        verts, tris = midpoint_subdivide(verts, tris, big)
        tris = tris.astype(np.int64)
    return verts.astype(np.float32), tris.astype(np.int32)
