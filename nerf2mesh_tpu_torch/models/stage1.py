"""Stage 1: mesh refinement through differentiable rasterization (port of
nerf2mesh_tpu/models/stage1.py).

The stage-0 mesh is loaded (``load_stage1_mesh``; ``mesh_{cas}_updated.ply``
first, the topology a refine or the surface snap wrote), vertices get
learnable offsets, and each training step renders one random crop through
the rasterizer (models/rasterizer.py), queries the field at the
interpolated surface points (detached: the photometric vertex gradient comes
only through the rasterizer's coverage and barycentrics, as in the
reference), and composites.  Per-face errors drive ``refine_and_decimate``.
Mesh topology is host numpy; the device buffers are bucket-padded
(``pad_stage1_buffers``) as the JAX package pads them, so a stage-1
checkpoint's [Vp, 3] offsets load on both sides.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.contraction import contract
from .network import NetworkSpec, density, field_forward, rgb as field_rgb
from .rasterizer import (RasterSpec, take_rows, antialias, interpolate,
                         rasterize_crop, subdivide_for_raster, transform_clip)


@dataclass
class Stage1Mesh:
    """Host-side mesh topology (rebuilt on refine)."""
    vertices: np.ndarray          # [V, 3] float32 (base positions)
    triangles: np.ndarray         # [F, 3] int32
    v_cumsum: np.ndarray          # [cascades+1]
    f_cumsum: np.ndarray
    edges: np.ndarray = None            # [E, 2] unique edges
    face_pairs: np.ndarray = None       # [P, 2] adjacent face ids
    vert_degree: np.ndarray = None      # [V]

    def __post_init__(self):
        self.build_adjacency()

    def build_adjacency(self):
        t = self.triangles.astype(np.int64)
        e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        fid = np.tile(np.arange(len(t)), 3)
        e_sorted = np.sort(e, axis=1)
        key = e_sorted[:, 0] * (len(self.vertices) + 1) + e_sorted[:, 1]
        order = np.argsort(key, kind="stable")
        key_s, fid_s, e_s = key[order], fid[order], e_sorted[order]
        uniq_mask = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        self.edges = e_s[uniq_mask].astype(np.int32)
        pair_mask = ~uniq_mask
        self.face_pairs = np.stack(
            [fid_s[np.nonzero(pair_mask)[0] - 1], fid_s[pair_mask]], -1
        ).astype(np.int32)
        deg = np.bincount(self.edges.reshape(-1), minlength=len(self.vertices))
        self.vert_degree = np.maximum(deg, 1).astype(np.float32)

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_faces(self) -> int:
        return len(self.triangles)


def camera_min_depth(poses: np.ndarray, v_lo: np.ndarray, v_hi: np.ndarray,
                     floor: float = 0.1) -> float:
    """Conservative minimum camera-space depth of any mesh point over the
    views: the distance from each camera to the mesh AABB times 0.7."""
    cams = np.asarray(poses)[:, :3, 3]
    d = np.maximum(np.maximum(v_lo[None] - cams, 0.0), cams - v_hi[None])
    return max(float(np.linalg.norm(d, axis=-1).min()) * 0.7, floor)


def load_stage1_mesh(workspace: str, cascades: int, mesh_path: str = "",
                     use_updated: bool = True,
                     max_screen_edge: float = 0.0,
                     poses: Optional[np.ndarray] = None,
                     max_faces: int = 0,
                     face_budget: int = 0) -> Stage1Mesh:
    """Load the cascade meshes from <workspace>/mesh_stage0/, preferring
    mesh_{cas}_updated.ply (refined or snapped topology, byte-stable across
    reloads).  A base cascade-0 mesh over face_budget is decimated to it;
    base meshes are subdivided so no edge exceeds max_screen_edge times
    the least camera depth (the fragment block bound), within max_faces."""
    from ..meshing import meshops
    from ..meshing.io import read_ply

    verts, tris = [], []
    v_cumsum, f_cumsum = [0], [0]
    for cas in range(cascades):
        base = os.path.join(workspace, "mesh_stage0")
        upd = os.path.join(base, f"mesh_{cas}_updated.ply")
        is_updated = False
        if mesh_path:
            p = mesh_path
        elif use_updated and os.path.exists(upd):
            p, is_updated = upd, True
        else:
            p = os.path.join(base, f"mesh_{cas}.ply")
        v, f = read_ply(p)
        if (face_budget > 0 and cas == 0 and not is_updated
                and len(f) > face_budget):
            print(f"[load_stage1_mesh] decimating cascade 0 to the "
                  f"screen-resolution face budget: {len(f)} -> {face_budget}")
            v, f = meshops.decimate_mesh(v, f, target=face_budget)
        if max_screen_edge > 0 and not is_updated:
            max_edge = max_screen_edge
            if poses is not None and len(v) > 0:
                max_edge = max_screen_edge * camera_min_depth(
                    poses, v.min(0), v.max(0))
            v, f = subdivide_for_raster(v, f, max_edge, max_faces=max_faces)
        verts.append(v)
        tris.append(f + v_cumsum[-1])
        v_cumsum.append(v_cumsum[-1] + len(v))
        f_cumsum.append(f_cumsum[-1] + len(f))
    return Stage1Mesh(
        vertices=np.concatenate(verts).astype(np.float32),
        triangles=np.concatenate(tris).astype(np.int32),
        v_cumsum=np.asarray(v_cumsum), f_cumsum=np.asarray(f_cumsum))


@torch.no_grad()
def snap_to_apparent_surface(params, verts: np.ndarray, tris: np.ndarray,
                             net_spec: NetworkSpec, band: float,
                             n_samples: int = 32, chunk: int = 4096,
                             passes: int = 1, sigma_fn=None,
                             device=None) -> np.ndarray:
    """Move vertices onto the field's apparent surface: the volume-render
    expected crossing along each vertex normal, probed at n_samples points
    over +-band (normals oriented by the lower density outside); vertices
    whose probe gathers < 0.3 opacity stay put.  passes > 1 repeat with a
    3x narrower band around the updated positions."""
    if sigma_fn is None:
        def sigma_fn(params, x):
            return density(params, x, net_spec)
    if device is None:
        device = next(params.parameters()).device

    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int64)
    fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    nrm = np.zeros_like(v)
    for k in range(3):
        np.add.at(nrm, t[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)

    def probe(vc, nc, b):
        offs = torch.linspace(b, -b, n_samples, device=device)
        dt = 2.0 * b / n_samples
        flip = (sigma_fn(params, vc + b * nc) > sigma_fn(params, vc - b * nc))
        n_o = torch.where(flip[:, None], -nc, nc)
        pts = vc[:, None, :] + offs[None, :, None] * n_o[:, None, :]
        sig = sigma_fn(params, pts.reshape(-1, 3)).reshape(-1, n_samples)
        alpha = 1.0 - torch.exp(-sig.clamp(min=0.0) * dt)
        T = torch.cumprod(1.0 - alpha + 1e-7, dim=-1)
        T = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], dim=-1)
        w = T * alpha
        wsum = w.sum(-1)
        et = (w * offs[None, :]).sum(-1) / wsum.clamp(min=1e-6)
        new_v = torch.where((wsum > 0.3)[:, None], vc + et[:, None] * n_o, vc)
        return new_v, wsum

    out = np.array(v)
    nrm_t = torch.from_numpy(nrm).to(device)
    for p in range(max(int(passes), 1)):
        b = band / (3.0 ** p)
        cur = np.array(out)
        cur_t = torch.from_numpy(cur).to(device)
        moved = 0
        for c0 in range(0, len(v), chunk):
            nv, ws = probe(cur_t[c0:c0 + chunk], nrm_t[c0:c0 + chunk], b)
            out[c0:c0 + len(nv)] = nv.cpu().numpy()
            moved += int((ws > 0.3).sum())
        d = np.linalg.norm(out - cur, axis=-1)
        print(f"[snap_to_apparent_surface] pass {p + 1}/{passes}: moved "
              f"{moved}/{len(v)} vertices, |d| mean {d.mean():.5f} "
              f"p90 {np.percentile(d, 90):.5f} (band {b:.4f})")
    d = np.linalg.norm(out - v, axis=-1)
    print(f"[snap_to_apparent_surface] total |d| mean {d.mean():.5f} "
          f"p90 {np.percentile(d, 90):.5f}")
    return out


def _bucket(n: int, min_b: int = 1024, cap: int = 0) -> int:
    """Next power-of-two size bucket (>= min_b); cap > 0 clamps."""
    b = max(min_b, 1 << int(np.ceil(np.log2(max(n, 1)))))
    if cap > 0:
        b = min(max(b, n), max(cap, n))
    return max(b, n)


def pad_stage1_buffers(mesh: Stage1Mesh, min_b: int = 1024,
                       face_cap: int = 1 << 18,
                       min_f: int = 0) -> Dict[str, np.ndarray]:
    """Pad the mesh buffers to power-of-two buckets, as the JAX package
    does (its compiled step reuses shapes across refines; here the padding
    keeps stage-1 checkpoints' [Vp, 3] offsets loadable both ways).  Pad
    vertices sit at 0, pad faces reference the last pad vertex and are
    masked out of the raster (f_valid), pad edges and pairs self-reference
    pad slots and are masked out of the losses.  `counts` = [v_real,
    f_real, e_real, p_real, v_inner]."""
    V, F = mesh.num_vertices, mesh.num_faces
    E, P = len(mesh.edges), len(mesh.face_pairs)
    Vp = _bucket(max(V, min_f // 2), min_b)
    Fp = _bucket(max(F, min_f), min_b, cap=max(face_cap, F))
    Ep = _bucket(max(E, min_f * 3 // 2), min_b)
    Pp = _bucket(max(P, min_f * 3 // 2), min_b)

    verts = np.zeros((Vp, 3), np.float32)
    verts[:V] = mesh.vertices
    tris = np.full((Fp, 3), Vp - 1, np.int32)
    tris[:F] = mesh.triangles
    edges = np.full((Ep, 2), Vp - 1, np.int32)
    edges[:E] = mesh.edges
    pairs = np.full((Pp, 2), Fp - 1, np.int32)
    pairs[:P] = mesh.face_pairs
    deg = np.ones((Vp,), np.float32)
    deg[:V] = mesh.vert_degree
    counts = np.asarray([V, F, E, P, int(mesh.v_cumsum[1])], np.int32)
    return dict(vertices=verts, triangles=tris, edges=edges,
                face_pairs=pairs, vert_degree=deg, counts=counts)


def render_stage1_crop(
    params,                        # NeRFField
    offsets: torch.Tensor,         # [V, 3] learnable
    mesh_v: torch.Tensor,          # [V, 3]
    mesh_f: torch.Tensor,          # [F, 3]
    mvp: torch.Tensor,             # [4, 4]
    crop_origin,                   # (y0, x0)
    dirs: torch.Tensor,            # [Cs, Cs, 3] per-pixel view dirs
    bg_color: torch.Tensor,        # [Cs, Cs, 3]
    net_spec: NetworkSpec,
    raster_spec: RasterSpec,
    H: int, W: int,
    *,
    shading: str = "full",
    contracted: bool = False,
    enable_offset_nerf_grad: bool = False,
    pos_gradient_boost: float = 1.0,
    ssaa: int = 1,
    alpha_mode: str = "aa",
    f_valid=None,
    shell_k: int = 1,
    shell_h: float = 0.02,
    ind_code: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One differentiable crop render.  With ssaa > 1 the crop is
    rasterized at ssaa x the resolution (dirs and bg_color given at that
    resolution) and average-pooled; trig_id stays at the raster resolution.
    shell_k > 1 composites shell_k field samples along the view ray in a
    shell_h-wide shell around the surface, one field pass per layer, with
    the field's transmittance weights detached.  enable_offset_nerf_grad
    keeps the surface points in the graph, so the offsets also take the
    gradient of the field query (on the splat path only through the MLPs'
    raw x input: the encode detaches its positions, as JAX's does).
    ind_code [1, ind_dim]: the view's per-image code (None: code 0)."""
    Cp = raster_spec.crop
    s = max(int(ssaa), 1)
    if s > 1:
        raster_spec = replace(raster_spec, crop=Cp * s,
                              max_frags=raster_spec.max_frags * s * s)
        crop_origin = (int(crop_origin[0]) * s, int(crop_origin[1]) * s)
        H, W = H * s, W * s
    Cs = Cp * s
    verts = mesh_v + offsets
    clip = transform_clip(verts, mvp)
    if pos_gradient_boost != 1.0:
        b = pos_gradient_boost
        clip = clip * b + (clip * (1.0 - b)).detach()

    rast = rasterize_crop(clip, mesh_f, crop_origin, H, W, raster_spec,
                          f_valid=f_valid)

    xyzs = interpolate(verts, rast, mesh_f)                     # [Cs, Cs, 3]
    if contracted:
        xyzs = contract(xyzs)
    if not enable_offset_nerf_grad:
        xyzs = xyzs.detach()

    d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    flat_x = xyzs.reshape(-1, 3)
    flat_d = d.reshape(-1, 3)
    if shell_k > 1 and shading in ("full", "diffuse"):
        K = int(shell_k)
        P = flat_x.shape[0]
        offs = np.linspace(-0.5 * shell_h, 0.5 * shell_h, K,
                           dtype=np.float32)
        dt = shell_h / K
        dev = flat_x.device
        T = torch.ones((P,), device=dev)
        acc = torch.zeros((P, 3), device=dev)
        wsum = torch.zeros((P,), device=dev)
        acc_u = torch.zeros((P, 3), device=dev)
        for off in offs:
            pts = flat_x + float(off) * flat_d
            sig, col, _, _ = field_forward(params, pts, flat_d, net_spec,
                                           shading == "full", c=ind_code)
            a = 1.0 - torch.exp(-sig.clamp(min=0.0) * dt)
            w = (T * a).detach()
            acc = acc + w[:, None] * col
            wsum = wsum + w
            T = T * (1.0 - a + 1e-7).detach()
            acc_u = acc_u + col * (1.0 / K)
        wsum = wsum[:, None]
        mean_c = acc / wsum.clamp(min=1e-6)
        colors = torch.where(wsum > 0.05, mean_c, acc_u)
    else:
        colors, _ = field_rgb(params, flat_x, flat_d, net_spec, shading,
                              c=ind_code)
    rgbs = colors.reshape(Cs, Cs, 3)
    rgbs = torch.where(rast["covered"][..., None], rgbs, 0.0)

    if alpha_mode == "area":
        # value: the 4x4-subsample union; gradient: the analytic area
        a_sum = rast["area"][..., None]
        alpha = a_sum + (rast["union"][..., None] - a_sum).detach()
    elif alpha_mode in ("aa", "hard"):
        alpha = rast["strict"].float()[..., None]
    elif alpha_mode == "soft":
        alpha = rast["alpha"][..., None]
    else:
        raise ValueError(f"unknown alpha_mode {alpha_mode!r}")
    image = alpha * rgbs + (1.0 - alpha) * bg_color
    image_w = alpha * rgbs + (1.0 - alpha)
    depth = alpha[..., 0] * rast["depth"]
    if alpha_mode == "aa":
        rgba = antialias(torch.cat([image, alpha, image_w], dim=-1), rast,
                         crop_origin)
        image, alpha, image_w = rgba[..., :3], rgba[..., 3:4], rgba[..., 4:]
    weights_sum = alpha[..., 0]

    if s > 1:
        image = image.reshape(Cp, s, Cp, s, 3).mean(dim=(1, 3))
        image_w = image_w.reshape(Cp, s, Cp, s, 3).mean(dim=(1, 3))
        depth = depth.reshape(Cp, s, Cp, s).mean(dim=(1, 3))
        weights_sum = weights_sum.reshape(Cp, s, Cp, s).mean(dim=(1, 3))

    return {
        "image": image,
        "image_white": image_w,
        "depth": depth,
        "weights_sum": weights_sum,
        "trig_id": rast["tri_id"],
        "overflow": rast["overflow"],
        "n_live": rast["n_live"],
        "n_overlap": rast["n_overlap"],
    }


# ---------------- mesh regularizers ----------------------------------------

def _masked_mean(x: torch.Tensor, n_real, size: int) -> torch.Tensor:
    """Mean over the first n_real entries of a length-`size` vector."""
    if n_real is None:
        return x.mean()
    n = torch.as_tensor(n_real, device=x.device)
    m = (torch.arange(size, device=x.device) < n).to(x.dtype)
    return (x * m).sum() / n.to(x.dtype).clamp(min=1.0)


def laplacian_loss(verts, edges, degree, v_real=None, e_real=None):
    """Uniform laplacian smoothing: mean || v - mean(neighbors) ||."""
    edges = edges.long()
    E = edges.shape[0]
    if e_real is None:
        w = torch.ones((E, 1), dtype=verts.dtype, device=verts.device)
    else:
        w = (torch.arange(E, device=verts.device)
             < torch.as_tensor(e_real, device=verts.device))[:, None].to(
            verts.dtype)
    acc = torch.zeros_like(verts)
    acc = acc.index_add(0, edges[:, 0], take_rows(verts, edges[:, 1]) * w)
    acc = acc.index_add(0, edges[:, 1], take_rows(verts, edges[:, 0]) * w)
    lap = verts - acc / degree[:, None]
    return _masked_mean(torch.sqrt((lap * lap).sum(-1) + 1e-12), v_real,
                        verts.shape[0])


def normal_consistency_loss(verts, tris, face_pairs, p_real=None):
    """1 - |cos| between adjacent face normals."""
    tris, face_pairs = tris.long(), face_pairs.long()
    v0, v1, v2 = (take_rows(verts, tris[:, k]) for k in range(3))
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-20)
    cos = (take_rows(n, face_pairs[:, 0]) * take_rows(n, face_pairs[:, 1])).sum(-1)
    return _masked_mean(1.0 - cos.abs(), p_real, face_pairs.shape[0])


def edge_length_loss(verts, edges, e_real=None):
    """Mean squared edge length."""
    edges = edges.long()
    d = take_rows(verts, edges[:, 0]) - take_rows(verts, edges[:, 1])
    return _masked_mean((d * d).sum(-1), e_real, edges.shape[0])


def offsets_loss(offsets, v_inner, bound: float, v_real=None):
    """L2 on the offsets, 0.1x for outer-cascade vertices; entries past
    v_real are padding."""
    V = offsets.shape[0]
    sq = (offsets ** 2).sum(-1)
    if v_real is None and isinstance(v_inner, int):
        loss = sq[:v_inner].mean()
        if V > v_inner:
            loss = loss + 0.1 * sq[v_inner:].mean()
        return loss
    dev = offsets.device
    iota = torch.arange(V, device=dev)
    vi = torch.as_tensor(v_inner, device=dev)
    vr = torch.as_tensor(V if v_real is None else v_real, device=dev)
    in_m = (iota < vi).to(sq.dtype)
    out_m = ((iota >= vi) & (iota < vr)).to(sq.dtype)
    loss = (sq * in_m).sum() / vi.to(sq.dtype).clamp(min=1.0)
    n_out = (vr - vi).to(sq.dtype).clamp(min=1.0)
    return loss + 0.1 * (sq * out_m).sum() / n_out


# ---------------- adaptive refinement ---------------------------------------

def refine_and_decimate(mesh: Stage1Mesh, offsets: np.ndarray,
                        errors: np.ndarray, counts: np.ndarray, cfg,
                        workspace: Optional[str],
                        max_faces: int = 0) -> Stage1Mesh:
    """Percentile-driven decimate (error < p50) / subdivide (error > p90)
    of the inner mesh within the face budget (retrying with a smaller
    subdivide set, then without the remesh, then decimating back); writes
    mesh_{cas}_updated.ply under <workspace>/mesh_stage0 (nothing when
    workspace is None: a data-parallel rank other than 0) and returns the
    rebuilt topology."""
    from ..meshing import meshops
    from ..meshing.io import write_ply

    v = (mesh.vertices + np.asarray(offsets)).astype(np.float32)
    f = mesh.triangles

    cnt_mask = counts > 0
    err = errors.copy()
    err[cnt_mask] = err[cnt_mask] / counts[cnt_mask]

    f1 = mesh.f_cumsum[1]
    err = err[:f1]
    cnt_mask = cnt_mask[:f1]

    budget = max_faces if max_faces > 0 else (1 << 18)
    n_outer = mesh.f_cumsum[-1] - mesh.f_cumsum[1]

    if cfg.sdf or not cnt_mask.any():
        mask = np.ones_like(err)
        sub_ids_sorted = np.empty((0,), np.int64)
    else:
        thresh_refine = np.percentile(err[cnt_mask], 90)
        thresh_decimate = np.percentile(err[cnt_mask], 50)
        mask = np.zeros_like(err)
        mask[(err > thresh_refine) & cnt_mask] = 2
        mask[(err < thresh_decimate) & cnt_mask] = 1
        sub_ids = np.where(mask == 2)[0]
        sub_ids_sorted = sub_ids[np.argsort(err[sub_ids])[::-1]]

    out_dir = None
    if workspace is not None:
        out_dir = os.path.join(workspace, "mesh_stage0")
        os.makedirs(out_dir, exist_ok=True)

    cascades = len(mesh.v_cumsum) - 1
    verts, tris = [], []
    v_cumsum, f_cumsum = [0], [0]
    for cas in range(cascades):
        cv = v[mesh.v_cumsum[cas]:mesh.v_cumsum[cas + 1]]
        cf = (f[mesh.f_cumsum[cas]:mesh.f_cumsum[cas + 1]]
              - mesh.v_cumsum[cas])
        if cas == 0:
            inner_budget = max(budget - int(n_outer), 1024)
            if budget - int(n_outer) < 1024:
                print(f"[refine_and_decimate] outer cascades use "
                      f"{int(n_outer)} of the {budget} face budget; flooring "
                      f"the inner budget at 1024")
            freed = int(cfg.refine_decimate_ratio * (mask == 1).sum())
            allowed0 = max(int((inner_budget * 0.97 - len(cf) + freed) // 3),
                           0)
            attempts = [(allowed0, cfg.refine_remesh_size),
                        (allowed0 // 4, cfg.refine_remesh_size),
                        (allowed0 // 4, 0.0), (0, 0.0)]
            cv0, cf0 = cv, cf
            for allowed, remesh_size in attempts:
                m = mask.copy()
                if len(sub_ids_sorted) > allowed:
                    m[sub_ids_sorted] = 0
                    m[sub_ids_sorted[:allowed]] = 2
                cv, cf = meshops.decimate_and_refine_mesh(
                    cv0, cf0, m, decimate_ratio=cfg.refine_decimate_ratio,
                    refine_size=cfg.refine_size,
                    refine_remesh_size=remesh_size)
                if len(cf) <= inner_budget:
                    if (allowed, remesh_size) != attempts[0]:
                        print(f"[refine_and_decimate] fit the budget with "
                              f"subdiv={allowed} remesh={remesh_size} "
                              f"({len(cf)}/{inner_budget} faces)")
                    break
            if len(cf) > inner_budget:
                print(f"[refine_and_decimate] {len(cf)} inner faces exceed "
                      f"the raster budget {inner_budget}; decimating back")
                cv, cf = meshops.decimate_mesh(
                    cv, cf, target=int(inner_budget * 0.95))
        if out_dir is not None:
            write_ply(os.path.join(out_dir, f"mesh_{cas}_updated.ply"), cv,
                      cf)
        verts.append(cv)
        tris.append(cf + v_cumsum[-1])
        v_cumsum.append(v_cumsum[-1] + len(cv))
        f_cumsum.append(f_cumsum[-1] + len(cf))

    return Stage1Mesh(
        vertices=np.concatenate(verts).astype(np.float32),
        triangles=np.concatenate(tris).astype(np.int32),
        v_cumsum=np.asarray(v_cumsum), f_cumsum=np.asarray(f_cumsum))
