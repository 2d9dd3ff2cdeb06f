"""Mesh exports (port of nerf2mesh_tpu/meshing/export.py).

``export_stage0_mesh``: chunked density query of the live field on the
marching grid, masked by the trained density grid -> marching tetrahedra
(host; in SDF mode the SDF's zero level, unmasked) -> visibility culling
against the training cameras (the rasterizer's triangle ids per view) ->
clean -> decimate -> mesh_0.ply.  At bound > 1 the outer cascades follow
(reference renderer.py:546-672): each cascade c >= 1 marches its own
density grid at min(env_reso, grid_size), carves the centre the inner
cascades cover, scales to its bound, drops what lies outside the ray box,
cleans, decimates to half the target, culls, and writes mesh_{c}.ply; a
cascade with nothing left writes no file, as in the JAX package.  In SDF
mode the contracted field's zero level at grid bound 2, carved and
uncontracted, is mesh_1.ply.  A failure of any step, the cull included,
fails the export.

``export_stage1_package``: per cascade, unwrap UVs, bake the diffuse and
specular-feature textures by rasterizing in UV space and querying the
field's geo_feat at the interpolated world positions, inpaint chart borders,
downscale by ssaa, and write OBJ + MTL + JPEGs and the specular MLP as
mlp.json for renderer.html.  Under contraction the unwrap and the bake take
the contracted positions.

Both return the wall seconds of their stages.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from ..ops.contraction import contract_np, uncontract_np
from . import meshops
from .io import write_obj, write_ply
from .marching_cubes import marching_cubes


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def _query_density_grid(trainer, resolution: int, bound: float = 1.0,
                        chunk: int = 2 ** 17) -> np.ndarray:
    """Density of the LIVE weights (the reference marches the model's
    current parameters, not the EMA) on a resolution^3 grid over
    [-bound, bound]^3, in chunks of 2^17 points built on the device."""
    from ..models.network import density
    dev = trainer.device
    ax = torch.from_numpy(np.linspace(-1, 1, resolution,
                                      dtype=np.float32)).to(dev)
    n = resolution ** 3
    out = torch.empty(n, dtype=torch.float32, device=dev)
    r2 = resolution * resolution
    for head in range(0, n, chunk):
        idx = torch.arange(head, min(head + chunk, n), device=dev)
        pts = torch.stack([ax[idx // r2], ax[(idx // resolution) % resolution],
                           ax[idx % resolution]], dim=-1) * bound
        out[head:head + len(idx)] = density(trainer.params, pts,
                                            trainer.net_spec)
    return np.nan_to_num(out.cpu().numpy().reshape(
        resolution, resolution, resolution), nan=0.0)


def mark_unseen_triangles(verts: np.ndarray, tris: np.ndarray,
                          mvps: np.ndarray, H: int, W: int,
                          frag_px: int = 8, device="cpu") -> np.ndarray:
    """Faces no camera rasterizes (reference renderer.py:946-981): True =
    unseen.  Faces whose projected bbox exceeds the fragment block in some
    view are midpoint-subdivided first (children map back to parents), so
    the strided fragment grid cannot let occluded faces win."""
    from ..models.rasterizer import rasterize_trig_id
    from .meshops import midpoint_subdivide

    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int64)
    parent = np.arange(len(f))
    mvps = np.asarray(mvps, np.float32)

    def face_bbox_px(v, f):
        big = np.zeros(len(f), np.float32)
        vh = np.concatenate([v, np.ones_like(v[:, :1])], axis=1)
        for mvp in mvps:
            clip = vh @ mvp.T
            w = clip[:, 3]
            ok = w > 1e-6
            sx = np.where(ok, (clip[:, 0] / np.where(ok, w, 1)) * 0.5 * W, 0)
            sy = np.where(ok, (clip[:, 1] / np.where(ok, w, 1)) * 0.5 * H, 0)
            fx, fy = sx[f], sy[f]
            ext = np.maximum(fx.max(1) - fx.min(1), fy.max(1) - fy.min(1))
            big = np.maximum(big, np.where(ok[f].all(1), ext, 0.0))
        return big

    for _ in range(6):
        split = face_bbox_px(v, f) > frag_px
        if not split.any():
            break
        v, f, par2 = midpoint_subdivide(v, f, split, return_parents=True)
        parent = parent[par2]

    seen = np.zeros(len(tris), bool)
    vt = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    ft = torch.from_numpy(np.ascontiguousarray(f)).to(device)
    for mvp in mvps:
        tid = rasterize_trig_id(vt, ft, torch.from_numpy(mvp).to(device), H, W)
        ids = np.unique(tid)
        seen[parent[ids[ids >= 0]]] = True
    return ~seen


def export_stage0_mesh(trainer, out_dir: str, resolution: int = 512,
                       decimate_target: int = 300000,
                       dataset=None) -> Dict[str, float]:
    """The inner mesh in [-1, 1]^3 -> <out_dir>/mesh_0.ply, and at bound > 1
    the outer cascades' mesh_{c}.ply; culled against dataset's cameras when
    it is given and cfg.mesh_visibility_culling.  Returns the wall seconds
    of: density, mcubes, cull, clean_decimate (the inner mesh) and, at
    bound > 1, outer."""
    cfg = trainer.cfg
    os.makedirs(out_dir, exist_ok=True)
    dev = trainer.device
    secs: Dict[str, float] = {}
    density_thresh = min(float(trainer.render.mean_density),
                         cfg.density_thresh)

    t0 = time.perf_counter()
    sigmas = _query_density_grid(trainer, resolution, bound=1.0)
    _sync(dev)
    secs["density"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if cfg.sdf:
        verts, tris = marching_cubes(-sigmas, 0.0)
    else:
        # mask untrained/unoccupied space by the density grid, dilated by
        # one cell (a surface crossing an unoccupied cell would punch a
        # hole)
        grid = trainer.render.density_grid[0].cpu().numpy()
        keep = grid > density_thresh
        d = keep.copy()
        for ax in (0, 1, 2):
            d |= np.roll(keep, 1, ax) | np.roll(keep, -1, ax)
        reps = int(np.ceil(resolution / grid.shape[0]))
        mask = np.repeat(np.repeat(np.repeat(d, reps, 0), reps, 1), reps,
                         2)[:resolution, :resolution, :resolution]
        verts, tris = marching_cubes(sigmas * mask, density_thresh)
    verts = verts / (resolution - 1.0) * 2 - 1
    secs["mcubes"] = time.perf_counter() - t0
    n_mc = len(tris)

    t0 = time.perf_counter()
    if dataset is not None and cfg.mesh_visibility_culling and len(tris) > 0:
        vis_mask = mark_unseen_triangles(verts, tris, dataset.mvps,
                                         dataset.H, dataset.W, device=dev)
        verts, tris = meshops.remove_masked_trigs(
            verts, tris, vis_mask, dilation=cfg.visibility_mask_dilation)
    _sync(dev)
    secs["cull"] = time.perf_counter() - t0
    n_cull = len(tris)

    t0 = time.perf_counter()
    verts, tris = meshops.clean_mesh(verts, tris, min_f=cfg.clean_min_f,
                                     min_d=cfg.clean_min_d)
    if decimate_target > 0 and len(tris) > decimate_target:
        verts, tris = meshops.decimate_mesh(verts, tris, decimate_target)
    secs["clean_decimate"] = time.perf_counter() - t0

    write_ply(os.path.join(out_dir, "mesh_0.ply"), verts, tris)
    trainer.log(f"[INFO] exported mesh_0.ply: v={verts.shape} f={tris.shape} "
                f"(marched {n_mc} faces, {n_cull} after the cull)")

    if trainer.render_spec.grid_bound > 1:
        t0 = time.perf_counter()
        _export_outer_cascades(trainer, out_dir, resolution, decimate_target,
                               dataset, density_thresh)
        secs["outer"] = time.perf_counter() - t0
    return secs


def _export_outer_cascades(trainer, out_dir: str, resolution: int,
                           decimate_target: int, dataset,
                           density_thresh: float) -> None:
    """mesh_{c}.ply of the cascades c >= 1 (JAX export.py:362-442)."""
    cfg, rspec = trainer.cfg, trainer.render_spec
    dec = decimate_target // 2
    if cfg.sdf:
        # the contracted field's zero level, its centre carved
        sig = _query_density_grid(trainer, resolution, bound=2.0)
        v_out, t_out = marching_cubes(-sig, 0.0)
        v_out = v_out / (resolution - 1.0) * 2 - 1
        v_out, t_out = meshops.remove_selected_verts(
            v_out, t_out, meshops.select_inside_box(0.5))
        v_out = v_out * (2.0 - 2.0 / resolution)
        v_out, t_out = meshops.clean_mesh(
            v_out, t_out, min_f=cfg.clean_min_f, min_d=cfg.clean_min_d)
        if dec > 0 and len(t_out) > dec * 2:
            v_out, t_out = meshops.decimate_mesh(v_out, t_out, dec * 2)
        v_out = uncontract_np(v_out)
        v_out, t_out = meshops.remove_selected_verts(
            v_out, t_out, meshops.select_outside_box(trainer._aabb))
        if len(t_out) > 0:
            write_ply(os.path.join(out_dir, "mesh_1.ply"), v_out, t_out)
            trainer.log(f"[INFO] exported mesh_1.ply: v={v_out.shape} "
                        f"f={t_out.shape}")
        return
    grid_all = trainer.render.density_grid.cpu().numpy()
    for cas in range(1, rspec.cascades):
        occ = np.nan_to_num(np.array(grid_all[cas], np.float32), nan=0.0)
        # the grid's own resolution at most: env_reso above it is ignored,
        # as in the JAX package
        reso = min(cfg.env_reso, int(occ.shape[0]))
        bound = min(2 ** cas, rspec.grid_bound)
        half = bound / reso
        if reso != occ.shape[0]:
            from scipy.ndimage import zoom
            occ = np.nan_to_num(zoom(occ, reso / occ.shape[0], order=1),
                                nan=0.0)
        v_out, t_out = marching_cubes(occ, density_thresh)
        if len(t_out) == 0:
            continue
        v_out = v_out / (reso - 1.0) * 2 - 1
        v_out, t_out = meshops.remove_selected_verts(
            v_out, t_out, meshops.select_inside_box(0.45))
        if len(v_out) == 0:
            continue
        v_out = v_out * (bound - half)
        aabb = trainer._aabb.copy()
        aabb[:3] += half
        aabb[3:] -= half
        v_out, t_out = meshops.remove_selected_verts(
            v_out, t_out, meshops.select_outside_box(aabb))
        v_out, t_out = meshops.clean_mesh(
            v_out, t_out, min_f=cfg.clean_min_f, min_d=cfg.clean_min_d)
        if len(t_out) == 0:
            continue
        if dec > 0 and len(t_out) > dec:
            v_out, t_out = meshops.decimate_mesh(v_out, t_out, dec)
        if dataset is not None and cfg.mesh_visibility_culling:
            vis_mask = mark_unseen_triangles(v_out, t_out, dataset.mvps,
                                             dataset.H, dataset.W,
                                             device=trainer.device)
            v_out, t_out = meshops.remove_masked_trigs(
                v_out, t_out, vis_mask, dilation=cfg.visibility_mask_dilation)
        write_ply(os.path.join(out_dir, f"mesh_{cas}.ply"), v_out, t_out)
        trainer.log(f"[INFO] exported mesh_{cas}.ply: v={v_out.shape} "
                    f"f={t_out.shape}")


def _grow(mask: torch.Tensor, n: int, dilate: bool) -> torch.Tensor:
    """n iterations of binary dilation (dilate) or erosion of a [H, W] bool
    mask by the 4-neighbour cross, outside the image counting as False:
    scipy.ndimage.binary_dilation / binary_erosion(mask, iterations=n)."""
    m = mask
    for _ in range(n):
        p = torch.nn.functional.pad(m[None, None].float(), (1, 1, 1, 1))[0, 0]
        nb = [p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]]
        if dilate:
            m = m | (torch.stack(nb).amax(0) > 0)
        else:
            m = m & (torch.stack(nb).amin(0) > 0)
    return m


def _tile_faces(vt: np.ndarray, ft: np.ndarray, h: int, w: int, tile: int):
    """(y0, x0, face ids ascending) of every bake tile that some UV
    triangle's pixel bbox (one pixel of margin) reaches; the rasterizer
    makes its own exact overlap test."""
    px, py = vt[ft][..., 0] * w, vt[ft][..., 1] * h                 # [F, 3]
    c0 = np.floor((px.min(1) - 1) / tile).astype(np.int64)
    c1 = np.floor((px.max(1) + 1) / tile).astype(np.int64)
    r0 = np.floor((py.min(1) - 1) / tile).astype(np.int64)
    r1 = np.floor((py.max(1) + 1) / tile).astype(np.int64)
    for r in range(-(-h // tile)):
        row = np.nonzero((r0 <= r) & (r1 >= r))[0]
        for c in range(-(-w // tile)):
            faces = row[(c0[row] <= c) & (c1[row] >= c)]
            if len(faces):
                yield r * tile, c * tile, faces


@torch.no_grad()
def export_stage1_package(trainer, out_dir: str, h0: int = 2048,
                          w0: int = 2048) -> Dict[str, float]:
    """Stage-1 web export (reference renderer.py:297-468).  Returns the
    wall seconds of: unwrap, bake, inpaint, jpeg (downscale + writes)."""
    from scipy.spatial import cKDTree

    from ..data.jpeg import resize_bilinear, save_jpeg
    from ..models.network import density, geo_feat
    from ..models.rasterizer import RasterSpec, interpolate, rasterize_crop
    from ..ops.contraction import contract
    from .uvatlas import unwrap_uv

    cfg = trainer.cfg
    nspec = trainer.net_spec
    params = trainer.params
    mesh = trainer.stage1_mesh
    dev = trainer.device
    os.makedirs(out_dir, exist_ok=True)
    secs = {"unwrap": 0.0, "bake": 0.0, "inpaint": 0.0, "jpeg": 0.0}

    ssaa = max(int(cfg.ssaa), 1)
    # the offsets are bucket-padded: the real vertices lead
    offs = trainer.vertices_offsets.detach()[:mesh.num_vertices].cpu().numpy()
    v_all = mesh.vertices + offs
    f_all = mesh.triangles
    cascades = len(mesh.v_cumsum) - 1
    shell_k = max(int(cfg.s1_shell), 1)
    n_feat = 3 + nspec.specular_dim

    def feat_shell(pts, nrms):
        """The thin-shell composite of geo_feat along the outward normal
        (outside -> inside), as the stage-1 render composites along the
        view ray."""
        n = nrms / torch.linalg.norm(nrms, dim=-1, keepdim=True).clamp(
            min=1e-9)
        offs_ = np.linspace(0.5 * cfg.s1_shell_h, -0.5 * cfg.s1_shell_h,
                            shell_k, dtype=np.float32)
        dt = cfg.s1_shell_h / shell_k
        P = pts.shape[0]
        T = torch.ones((P,), device=dev)
        acc = torch.zeros((P, n_feat), device=dev)
        wsum = torch.zeros((P,), device=dev)
        acc_u = torch.zeros((P, n_feat), device=dev)
        for off in offs_:
            p = pts + float(off) * n
            sig = density(params, p, nspec)
            gf = geo_feat(params, p, nspec)
            a = 1.0 - torch.exp(-sig.clamp(min=0.0) * dt)
            w = T * a
            acc = acc + w[:, None] * gf
            wsum = wsum + w
            T = T * (1.0 - a + 1e-7)
            acc_u = acc_u + gf * (1.0 / shell_k)
        wsum = wsum[:, None]
        return torch.where(wsum > 0.05, acc / wsum.clamp(min=1e-6), acc_u)

    cur_h, cur_w = h0, w0
    for cas in range(cascades):
        v = v_all[mesh.v_cumsum[cas]:mesh.v_cumsum[cas + 1]]
        f = (f_all[mesh.f_cumsum[cas]:mesh.f_cumsum[cas + 1]]
             - mesh.v_cumsum[cas])

        t0 = time.perf_counter()
        vmapping, ft, vt = unwrap_uv(contract_np(v) if cfg.contract else v, f)
        secs["unwrap"] += time.perf_counter() - t0
        trainer.log(f"[INFO] unwrap cas {cas}: charts over v={len(v)} "
                    f"f={len(f)} -> uvv={len(vt)}")

        t0 = time.perf_counter()
        h, w = cur_h * ssaa, cur_w * ssaa
        # clip coords in uv space: x = u*2-1, row y = v*2-1 (w=1, z=0.5)
        clip = np.concatenate([
            vt[:, :1] * 2 - 1, vt[:, 1:2] * 2 - 1,
            np.full((len(vt), 1), 0.5, np.float32),
            np.ones((len(vt), 1), np.float32)], -1).astype(np.float32)
        world_attr = torch.from_numpy(
            np.ascontiguousarray(v[vmapping], np.float32)).to(dev)
        clip_t = torch.from_numpy(clip).to(dev)
        ft_t = torch.from_numpy(ft.astype(np.int64)).to(dev)
        nrm_attr = None
        if shell_k > 1:
            fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
            vn = np.zeros_like(v)
            for k in range(3):
                np.add.at(vn, f[:, k], fn)
            vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True),
                             1e-12)
            nrm_attr = torch.from_numpy(
                np.ascontiguousarray(vn[vmapping], np.float32)).to(dev)

        def query(pts, nrms):
            if shell_k > 1:
                return feat_shell(pts, nrms)[:, :6]
            return geo_feat(params, pts, nspec)[:, :6]

        tile = 256
        feats = torch.zeros((h * w, 6), dtype=torch.float32, device=dev)
        mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
        # an uncovered pixel of a covered tile holds the field at the
        # origin (its interpolated position and normal are 0), as the
        # reference's bake writes whole tiles
        origin = query(torch.zeros((1, 3), device=dev),
                       torch.zeros((1, 3), device=dev))[0]
        pending = []          # (flat pixel ids, points, normals) to query

        def flush():
            ids = torch.cat([p[0] for p in pending])
            pts = torch.cat([p[1] for p in pending])
            nrms = torch.cat([p[2] for p in pending])
            feats[ids] = query(pts, nrms)
            pending.clear()

        for y0, x0, faces in _tile_faces(vt, ft, h, w, tile):
            # only the tile's own faces, in index order: the same winners
            # as a rasterization of all faces, with a budget K a tile needs
            sub = ft_t[torch.from_numpy(faces).to(dev)]
            spec = RasterSpec(crop=tile, frag=8, max_tris=1 << int(
                np.ceil(np.log2(max(len(faces), 2)))))
            r = rasterize_crop(clip_t, sub, (y0, x0), h, w, spec)
            th, tw = min(tile, h - y0), min(tile, w - x0)
            cov = r["covered"][:th, :tw]
            iy, ix = torch.nonzero(cov, as_tuple=True)
            if len(iy) == 0:
                continue
            rows = (y0 + torch.arange(th, device=dev))[:, None] * w
            feats[(rows + x0 + torch.arange(tw, device=dev)).reshape(-1)] = \
                origin
            mask[y0:y0 + th, x0:x0 + tw] = cov
            # the field runs on the covered pixels of many tiles at once
            pix = iy * tile + ix
            pts = interpolate(world_attr, r, sub).reshape(-1, 3)[pix]
            if cfg.contract:
                pts = contract(pts)
            nrm = (interpolate(nrm_attr, r, sub).reshape(-1, 3)[pix]
                   if shell_k > 1 else pts)
            pending.append(((y0 + iy) * w + x0 + ix, pts, nrm))
            if sum(len(p[0]) for p in pending) >= 1 << 20:
                flush()
        if pending:
            flush()
        feats = feats.reshape(h, w, 6)
        # the inpaint's regions (renderer.py:378-394): 32 pixels outside the
        # charts, and the charts' 3-pixel rim
        inpaint_region = (_grow(mask, 32, True) & ~mask).cpu().numpy()
        search_region = (mask & ~_grow(mask, 3, False)).cpu().numpy()
        feats = (feats.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        mask = mask.cpu().numpy()
        secs["bake"] += time.perf_counter() - t0

        # KNN inpaint around the charts
        t0 = time.perf_counter()
        if mask.any() and (~mask).any():
            s_coords = np.stack(np.nonzero(search_region), -1)
            i_coords = np.stack(np.nonzero(inpaint_region), -1)
            if len(s_coords) and len(i_coords):
                _, idx = cKDTree(s_coords).query(i_coords, k=1)
                feats[tuple(i_coords.T)] = feats[tuple(s_coords[idx].T)]
        secs["inpaint"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        f0, f1 = feats[..., :3], feats[..., 3:6]
        if ssaa > 1:
            f0 = resize_bilinear(f0, cur_w, cur_h)
            f1 = resize_bilinear(f1, cur_w, cur_h)
        save_jpeg(os.path.join(out_dir, f"feat0_{cas}.jpg"), f0, quality=95)
        save_jpeg(os.path.join(out_dir, f"feat1_{cas}.jpg"), f1, quality=95)
        secs["jpeg"] += time.perf_counter() - t0

        write_obj(os.path.join(out_dir, f"mesh_{cas}.obj"), v, f,
                  vts=vt, fts=ft, mtl_name=f"mesh_{cas}.mtl",
                  tex_name=f"feat0_{cas}.jpg")
        trainer.log(f"[INFO] wrote mesh_{cas}.obj + textures "
                    f"({cur_w}x{cur_h})")
        if not cfg.sdf and cur_h > 2048 and cur_w > 2048:
            cur_h //= 2
            cur_w //= 2

    write_mlp_json([layer.w for layer in params.specular_net],
                   trainer.render_spec.grid_bound, cascades, out_dir)
    trainer.log("[INFO] wrote mlp.json")
    return secs


def write_mlp_json(specular_net, bound: float, cascades: int,
                   out_dir: str) -> str:
    """The specular MLP's layer weights ([in, out] each) -> mlp.json with
    keys ``net.{l}.weight`` ([in][out] lists), ``bound`` and ``cascade``:
    the contract renderer.html reads (tests/test_export_contract.py
    emulates the viewer against it)."""
    mlp = {f"net.{l}.weight": np.asarray(
        w.detach().cpu() if torch.is_tensor(w) else w).tolist()
        for l, w in enumerate(specular_net)}
    mlp["bound"] = bound
    mlp["cascade"] = cascades
    path = os.path.join(out_dir, "mlp.json")
    with open(path, "w") as fp:
        json.dump(mlp, fp, indent=2)
    return path
