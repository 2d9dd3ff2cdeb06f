"""Procedural synthetic scene (port of nerf2mesh_tpu/data/synthetic.py).

``render_synthetic_frames`` draws the same cameras and ray-traces the same
uint8 RGBA frames as the JAX package's ``generate_synthetic_dataset`` (of
``SphereScene``, the default, or ``HardScene``, the hard proxy scene), but
returns them in memory, so a run needs neither disk nor Pillow;
``generate_synthetic_dataset`` writes them as a nerf-synthetic directory
(transforms_{split}.json + PNGs, written by Pillow where it is importable,
else by the port's codec, data/png.py).  ``generate_colmap_dataset`` writes
the JAX package's COLMAP-format scene (sparse/0/*.bin + images/*.png, the
spheres inside a textured environment sphere), with the same draws; its
options write the frames as JPEG instead and add depths/*.npy maps for
depth supervision.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from .jpeg import save_jpeg
from .png import write_image
from .rays import orbit_pose


@dataclass
class SphereScene:
    """A few diffuse spheres; analytic ray-traced ground truth."""
    centers: np.ndarray = field(default_factory=lambda: np.array(
        [[0.0, 0.0, 0.0], [0.35, 0.25, 0.3], [-0.4, -0.1, 0.25]], np.float32))
    radii: np.ndarray = field(default_factory=lambda: np.array(
        [0.42, 0.22, 0.18], np.float32))
    colors: np.ndarray = field(default_factory=lambda: np.array(
        [[0.85, 0.25, 0.2], [0.2, 0.6, 0.9], [0.9, 0.8, 0.2]], np.float32))
    light_dir: np.ndarray = field(default_factory=lambda: np.array(
        [0.5, 0.8, 0.3], np.float32))

    env_radius: float = 0.0   # >0: enclose the scene in a textured sphere

    def trace(self, rays_o: np.ndarray, rays_d: np.ndarray,
              return_t: bool = False) -> Tuple[np.ndarray, ...]:
        """Returns rgb [N,3] in [0,1] and alpha [N]; with return_t also the
        hit distance along the normalized direction [N] (inf on a miss)."""
        N = rays_o.shape[0]
        d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        best_t = np.full(N, np.inf, np.float32)
        rgb = np.zeros((N, 3), np.float32)
        alpha = np.zeros(N, np.float32)
        L = self.light_dir / np.linalg.norm(self.light_dir)
        for c, r, col in zip(self.centers, self.radii, self.colors):
            oc = rays_o - c
            b = np.sum(oc * d, -1)
            cc = np.sum(oc * oc, -1) - r * r
            disc = b * b - cc
            hit = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0))
            hit &= (t > 0) & (t < best_t)
            if not hit.any():
                continue
            p = rays_o[hit] + t[hit, None] * d[hit]
            n = (p - c) / r
            lam = np.clip(n @ L, 0, 1) * 0.8 + 0.2
            rgb[hit] = col[None, :] * lam[:, None]
            alpha[hit] = 1.0
            best_t[hit] = t[hit]
        if self.env_radius > 0:
            # background: the inside of an enclosing sphere with a smooth
            # pattern (colmap-style captures have geometry on every ray)
            miss = ~np.isfinite(best_t)
            if miss.any():
                b = np.sum(rays_o[miss] * d[miss], -1)
                cc = np.sum(rays_o[miss] ** 2, -1) - self.env_radius ** 2
                t = -b + np.sqrt(np.maximum(b * b - cc, 0))
                p = rays_o[miss] + t[:, None] * d[miss]
                n = p / self.env_radius
                rgb[miss] = 0.5 + 0.35 * np.stack([
                    np.sin(3 * n[:, 0]) * np.cos(2 * n[:, 1]),
                    np.sin(4 * n[:, 1]),
                    np.cos(3 * n[:, 2])], -1)
                alpha[miss] = 1.0
                if return_t:
                    best_t[miss] = t
        if return_t:
            return rgb, alpha, best_t
        return rgb, alpha

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        """Analytic signed distance to the union of the spheres (the JAX
        SphereScene.sdf): a mesh's distance to the true surface."""
        d = np.full(pts.shape[0], np.inf, np.float32)
        for c, r in zip(self.centers, self.radii):
            d = np.minimum(d, np.linalg.norm(pts - c, axis=-1) - r)
        return d


@dataclass
class HardScene:
    """Lego-proxy benchmark scene: textured boxes, thin rods, and glossy
    (view-dependent) materials, raytraced analytically.

    A copy of the JAX package's HardScene, held equal to it by
    tests/test_torch_hardscene.py.  A procedural stand-in for the
    nerf-synthetic lego scene, which ships with neither package:
    high-frequency checker textures stress the fine hash levels,
    0.015-radius rods stress thin-structure sampling, and Blinn-Phong
    speculars exercise the view-dependent head.  Quality numbers on it are
    labeled 'hard-proxy', never compared 1:1 with published lego.
    """
    light_dir: np.ndarray = field(default_factory=lambda: np.array(
        [0.4, 0.9, 0.35], np.float32))
    seed: int = 7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # boxes: (center, half-extent, yaw, base color, gloss)
        self.boxes = [
            (np.array([0.0, -0.42, 0.0]), np.array([0.58, 0.06, 0.58]),
             0.0, np.array([0.55, 0.52, 0.5]), 0.15),          # base plate
            (np.array([-0.22, -0.18, 0.1]), np.array([0.2, 0.18, 0.26]),
             0.4, np.array([0.8, 0.25, 0.15]), 0.5),
            (np.array([0.26, -0.24, -0.14]), np.array([0.16, 0.12, 0.2]),
             -0.3, np.array([0.95, 0.75, 0.1]), 0.7),
            (np.array([0.18, 0.02, 0.22]), np.array([0.12, 0.14, 0.1]),
             0.9, np.array([0.2, 0.45, 0.85]), 0.9),
        ]
        # thin rods: (base, axis unit, length, radius, color)
        self.rods = []
        for i in range(6):
            a = rng.normal(size=3)
            a[1] = abs(a[1]) + 1.2
            a /= np.linalg.norm(a)
            base = np.array([rng.uniform(-0.4, 0.4), -0.36,
                             rng.uniform(-0.4, 0.4)])
            self.rods.append((base.astype(np.float32), a.astype(np.float32),
                              rng.uniform(0.35, 0.7), 0.015,
                              np.array([0.15, 0.8, 0.4], np.float32)))
        # one glossy sphere
        self.sph = (np.array([-0.05, 0.18, -0.2], np.float32), 0.14,
                    np.array([0.9, 0.9, 0.95], np.float32))

    @staticmethod
    def _rot(yaw):
        c, s = np.cos(yaw), np.sin(yaw)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    def _albedo(self, p, base, kind):
        """High-frequency procedural texture (stresses fine hash levels)."""
        if kind == 0:   # checker at 24 cells/unit
            par = np.floor(p * 24.0).astype(np.int64).sum(-1) % 2
            return base * (0.45 + 0.55 * par)[:, None]
        if kind == 1:   # stripes + noise-ish modulation
            m = 0.5 + 0.5 * np.sin(40.0 * p[:, 0] + 17.0 * p[:, 2])
            return base * (0.5 + 0.5 * m)[:, None]
        return np.broadcast_to(base, p.shape).copy()

    def trace(self, rays_o: np.ndarray, rays_d: np.ndarray):
        N = rays_o.shape[0]
        d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        best_t = np.full(N, np.inf, np.float32)
        nrm = np.zeros((N, 3), np.float32)
        alb = np.zeros((N, 3), np.float32)
        gloss = np.zeros(N, np.float32)
        tex = np.zeros(N, np.int64)

        def consider(t, hit, n, base, g, kind):
            upd = hit & (t > 1e-3) & (t < best_t)
            if not upd.any():
                return
            best_t[upd] = t[upd]
            nrm[upd] = n[upd]
            alb[upd] = np.broadcast_to(base, (N, 3))[upd]
            gloss[upd] = g
            tex[upd] = kind

        for k, (c, h, yaw, col, g) in enumerate(self.boxes):
            R = self._rot(yaw)
            ol = (rays_o - c) @ R
            dl = d @ R
            dl = np.where(np.abs(dl) < 1e-9, 1e-9, dl)
            t0 = (-h - ol) / dl
            t1 = (h - ol) / dl
            tmin = np.minimum(t0, t1).max(-1)
            tmax = np.maximum(t0, t1).min(-1)
            hit = (tmax > tmin) & (tmax > 0)
            te = np.where(tmin > 0, tmin, tmax)
            pl = ol + te[:, None] * dl
            ax = np.argmax(np.abs(pl) / h, -1)
            n_l = np.zeros((N, 3), np.float32)
            n_l[np.arange(N), ax] = np.sign(pl[np.arange(N), ax])
            consider(te, hit, n_l @ R.T, col, g, k % 2)

        for base, axis, ln, r, col in self.rods:
            oc = rays_o - base
            dpa = d - (d @ axis)[:, None] * axis
            opa = oc - (oc @ axis)[:, None] * axis
            a = np.sum(dpa * dpa, -1)
            b = np.sum(dpa * opa, -1)
            cq = np.sum(opa * opa, -1) - r * r
            disc = b * b - a * cq
            hit = (disc > 0) & (a > 1e-12)
            t = (-b - np.sqrt(np.maximum(disc, 0))) / np.maximum(a, 1e-12)
            s = (rays_o + t[:, None] * d - base) @ axis
            hit &= (s > 0) & (s < ln)
            p = rays_o + t[:, None] * d
            n = p - base - s[:, None] * axis
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
            consider(t, hit, n, col, 0.3, 2)

        c, r, col = self.sph
        oc = rays_o - c
        b = np.sum(oc * d, -1)
        cc = np.sum(oc * oc, -1) - r * r
        disc = b * b - cc
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        p = rays_o + t[:, None] * d
        n = (p - c) / r
        consider(t, hit, n, col, 1.0, 2)

        alpha = np.isfinite(best_t).astype(np.float32)
        rgb = np.zeros((N, 3), np.float32)
        m = alpha > 0
        if m.any():
            p = rays_o[m] + best_t[m, None] * d[m]
            a = np.zeros((m.sum(), 3), np.float32)
            for kind in (0, 1, 2):
                km = tex[m] == kind
                if km.any():
                    a[km] = self._albedo(p[km], 1.0, kind) * alb[m][km] \
                        if kind < 2 else alb[m][km]
            L = self.light_dir / np.linalg.norm(self.light_dir)
            nn = nrm[m]
            lam = np.clip(nn @ L, 0, 1)
            # Blinn-Phong specular: genuinely view-dependent
            hvec = L[None] - d[m]
            hvec /= np.maximum(np.linalg.norm(hvec, axis=-1, keepdims=True),
                               1e-9)
            spec = gloss[m] * np.clip(np.sum(nn * hvec, -1), 0, 1) ** 32
            rgb[m] = np.clip(a * (0.25 + 0.75 * lam)[:, None]
                             + spec[:, None], 0, 1)
        return rgb, alpha

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        dmin = np.full(pts.shape[0], np.inf, np.float32)
        for c, h, yaw, _, _ in self.boxes:
            q = np.abs((pts - c) @ self._rot(yaw)) - h
            outside = np.linalg.norm(np.maximum(q, 0), axis=-1)
            inside = np.minimum(q.max(-1), 0)
            dmin = np.minimum(dmin, outside + inside)
        for base, axis, ln, r, _ in self.rods:
            oc = pts - base
            s = np.clip(oc @ axis, 0, ln)
            dmin = np.minimum(
                dmin, np.linalg.norm(oc - s[:, None] * axis, axis=-1) - r)
        c, r, _ = self.sph
        dmin = np.minimum(dmin, np.linalg.norm(pts - c, axis=-1) - r)
        return dmin


def _camera_rays(pose: np.ndarray, H: int, W: int, fl: float,
                 dx: float = 0.5, dy: float = 0.5):
    """Pixel rays with subpixel offset (dx, dy) from the pixel's top-left
    corner (0.5, 0.5 = pixel center)."""
    j, i = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    x = (i.reshape(-1) + dx - W / 2) / fl
    y = -(j.reshape(-1) + dy - H / 2) / fl
    dirs = np.stack([x, y, -np.ones_like(x)], -1).astype(np.float32)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    return rays_o, rays_d


def render_synthetic_frames(
    scene: SphereScene | HardScene | None = None,
    H: int = 128,
    W: int = 128,
    n_train: int = 32,
    n_val: int = 4,
    n_test: int = 8,
    fovx_deg: float = 45.0,
    radius: float = 2.8,
    seed: int = 0,
    ssaa: int = 1,
) -> Dict[str, dict]:
    """{split: {"camera_angle_x": float, "images": [n, H, W, 4] uint8,
    "poses": [n, 4, 4] float32}} - the frames generate_synthetic_dataset
    writes, with the same camera draws from the same seed."""
    scene = scene or SphereScene()
    rng = np.random.default_rng(seed)
    camera_angle_x = float(np.deg2rad(fovx_deg))
    fl = W / (2 * np.tan(camera_angle_x / 2))
    out = {}
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        images, poses = [], []
        for k in range(n):
            if split == "train":
                theta = np.arccos(rng.uniform(0.05, 0.95))
                phi = rng.uniform(0, 2 * np.pi)
            elif split == "val":
                theta = np.pi / 3
                phi = 2 * np.pi * k / n
            else:
                theta = np.pi / 2.4
                phi = 2 * np.pi * (k + 0.5) / n
            pose = orbit_pose(theta, phi, radius)
            s = max(int(ssaa), 1)
            acc_pm = np.zeros((H * W, 3), np.float32)   # premultiplied rgb
            acc_a = np.zeros((H * W,), np.float32)
            for ay in range(s):
                for ax in range(s):
                    rays_o, rays_d = _camera_rays(
                        pose, H, W, fl, dx=(ax + 0.5) / s, dy=(ay + 0.5) / s)
                    rgb_s, a_s = scene.trace(rays_o, rays_d)
                    acc_pm += rgb_s * a_s[:, None]
                    acc_a += a_s
            alpha = acc_a / (s * s)
            rgb = acc_pm / (s * s) / np.maximum(alpha[:, None], 1e-8)
            rgb = np.where(alpha[:, None] > 0, rgb, 0.0)
            img = np.concatenate([rgb, alpha[:, None]], -1).reshape(H, W, 4)
            images.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
            poses.append(pose)
        out[split] = {
            "camera_angle_x": camera_angle_x,
            "images": np.stack(images) if images else np.zeros((0, H, W, 4), np.uint8),
            "poses": np.stack(poses) if poses else np.zeros((0, 4, 4), np.float32),
        }
    return out


def generate_synthetic_dataset(root: str,
                               scene: SphereScene | HardScene | None = None,
                               **kw) -> str:
    """Write a nerf-synthetic-format dataset under `root` (see
    render_synthetic_frames for the keywords). Returns root."""
    os.makedirs(root, exist_ok=True)
    for split, fr in render_synthetic_frames(scene, **kw).items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for k, (img, pose) in enumerate(zip(fr["images"], fr["poses"])):
            fname = f"./{split}/r_{k}"
            write_image(os.path.join(root, fname[2:] + ".png"), img)
            frames.append({"file_path": fname,
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fr["camera_angle_x"],
                       "frames": frames}, f)
    return root


# the DTU reader's axis rectification (data/dtu.py): final rotation =
# _DTU_ROWS @ R_cv @ _DTU_COLS, final position = _DTU_ROWS @ center
_DTU_ROWS = np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float64)
_DTU_COLS = np.diag([1.0, -1.0, -1.0])


def generate_dtu_dataset(root: str,
                         scene: SphereScene | HardScene | None = None,
                         H: int = 64, W: int = 64, n_views: int = 16,
                         **kw) -> str:
    """Write a DTU-format dataset (cameras_sphere.npz, image/%03d.png RGB,
    mask/%03d.png the alpha) of the train views render_synthetic_frames
    draws (its keywords in kw).  The world matrices K[R|t] invert the DTU
    reader's decomposition and rectification, so data/dtu.py loads the
    poses and intrinsics that the blender reader gives for the same frames
    (scale matrices are the identity).  Returns root."""
    fr = render_synthetic_frames(scene, H=H, W=W, n_train=n_views, n_val=0,
                                 n_test=0, **kw)["train"]
    fl = W / (2 * np.tan(fr["camera_angle_x"] / 2))
    K = np.array([[fl, 0, W / 2], [0, fl, H / 2], [0, 0, 1]])
    os.makedirs(os.path.join(root, "image"), exist_ok=True)
    os.makedirs(os.path.join(root, "mask"), exist_ok=True)
    cams = {}
    for i, (img, pose) in enumerate(zip(fr["images"], fr["poses"])):
        pose = np.asarray(pose, np.float64)
        r_c2w = _DTU_ROWS.T @ pose[:3, :3] @ _DTU_COLS
        center = _DTU_ROWS.T @ pose[:3, 3]
        world = np.eye(4)
        world[:3] = K @ np.concatenate(
            [r_c2w.T, -(r_c2w.T @ center)[:, None]], 1)
        cams[f"world_mat_{i}"], cams[f"scale_mat_{i}"] = world, np.eye(4)
        write_image(os.path.join(root, "image", f"{i:03d}.png"),
                    np.ascontiguousarray(img[..., :3]))
        write_image(os.path.join(root, "mask", f"{i:03d}.png"),
                    np.ascontiguousarray(img[..., 3]))
    np.savez(os.path.join(root, "cameras_sphere.npz"), **cams)
    return root


def generate_colmap_dataset(
    root: str,
    scene: SphereScene | None = None,
    H: int = 96,
    W: int = 96,
    n_images: int = 20,
    radius: float = 2.8,
    n_points: int = 2000,
    seed: int = 0,
    image_format: str = "png",
    jpeg_quality: int = 95,
    jpeg_subsampling: str = "4:2:0",
    depth_size: Tuple[int, int] | None = None,
    depth_affine: Tuple[float, float] = (1.0, 0.0),
    depth_outliers: float = 0.0,
) -> str:
    """Write a synthetic COLMAP-format dataset (sparse/0/{cameras,images,
    points3D}.bin + images/frame_*.png) rendered from the analytic scene,
    the one the JAX package's generate_colmap_dataset writes from the same
    seed: one PINHOLE camera with a 45-degree field of view, n_images
    cameras on a sphere of `radius` looking at the origin, and n_points
    sparse points on the spheres and the environment sphere (1-based ids,
    each with its track of the images it projects into).  Returns root.

    image_format "jpeg" writes the frames as images/frame_*.jpg (their
    names in images.bin) at jpeg_quality and jpeg_subsampling (data/jpeg.py
    save_jpeg).  depth_size (h, w) writes depths/frame_*.npy: each view's
    analytic z-depth at that size (the same camera, pixel centres), mapped
    by depth_affine (a, c) to a * z + c, with a share depth_outliers of its
    pixels replaced by uniform draws over the map's range (from a generator
    seeded seed + 1); each view then lists only the sparse points it sees
    (no point behind a surface).  With the defaults the output is the JAX
    generator's."""
    from .colmap_utils import (Camera, Image, Point3D, rotmat2qvec,
                               write_cameras_binary, write_images_binary,
                               write_points3d_binary)

    # colmap-style captures have real background geometry on every ray
    scene = scene or SphereScene(env_radius=radius * 2.0)
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "sparse", "0"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    if image_format not in ("png", "jpeg"):
        raise ValueError(f"image_format {image_format!r}: png or jpeg")
    if depth_size is not None:
        os.makedirs(os.path.join(root, "depths"), exist_ok=True)
        drng = np.random.default_rng(seed + 1)

    fl = W / (2 * np.tan(np.deg2rad(45) / 2))
    cams = {1: Camera(1, "PINHOLE", W, H,
                      np.array([fl, fl, W / 2, H / 2], np.float64))}

    # sparse points on the spheres and on the background (pts_aabb and the
    # per-view near/far derive from them)
    pts = []
    n_obj = (2 * n_points // 3) // len(scene.radii)
    for c, r in zip(scene.centers, scene.radii):
        d = rng.normal(size=(n_obj, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts.append(c + r * d)
    if scene.env_radius > 0:
        d = rng.normal(size=(n_points - n_obj * len(scene.radii), 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts.append(d * scene.env_radius)
    pts3d = np.concatenate(pts)

    images = {}
    points = {}
    tracks = {i: [] for i in range(len(pts3d))}
    for k in range(n_images):
        theta = np.arccos(rng.uniform(0.05, 0.95))
        phi = rng.uniform(0, 2 * np.pi)
        center = np.array([radius * np.sin(theta) * np.sin(phi),
                           radius * np.cos(theta),
                           radius * np.sin(theta) * np.cos(phi)])
        # CV convention: +z forward (towards the origin), x right, y down
        fwd = -center / np.linalg.norm(center)
        upw = np.array([0.0, 1, 0])
        right = np.cross(fwd, upw)
        right /= np.linalg.norm(right) + 1e-9
        ydown = np.cross(fwd, right)
        R_c2w = np.stack([right, ydown, fwd], axis=-1)
        Rw2c = R_c2w.T
        t = -Rw2c @ center

        # CV rays: dir_cam = [(i - cx) / f, (j - cy) / f, 1]
        jj, ii = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                             indexing="ij")
        dirs_cam = np.stack([(ii - W / 2) / fl, (jj - H / 2) / fl,
                             np.ones_like(ii)], -1).reshape(-1, 3)
        dirs_w = dirs_cam @ R_c2w.T
        rays_o = np.broadcast_to(center, dirs_w.shape)
        rgb, alpha = scene.trace(rays_o.astype(np.float32),
                                 dirs_w.astype(np.float32))
        img = (np.clip(rgb.reshape(H, W, 3), 0, 1) * 255).astype(np.uint8)
        if image_format == "jpeg":
            name = f"frame_{k:04d}.jpg"
            save_jpeg(os.path.join(root, "images", name), img, jpeg_quality,
                      jpeg_subsampling)
        else:
            name = f"frame_{k:04d}.png"
            write_image(os.path.join(root, "images", name), img)
        if depth_size is not None:
            hd, wd = depth_size
            fd = fl * wd / W
            jd, id_ = np.meshgrid(np.arange(hd) + 0.5, np.arange(wd) + 0.5,
                                  indexing="ij")
            dc = np.stack([(id_ - wd / 2) / fd, (jd - hd / 2) / fd,
                           np.ones_like(id_)], -1).reshape(-1, 3)
            _, _, t_hit = scene.trace(
                np.broadcast_to(center, dc.shape).astype(np.float32),
                (dc @ R_c2w.T).astype(np.float32), return_t=True)
            z = t_hit / np.linalg.norm(dc, axis=-1)       # along the axis
            dmap = (depth_affine[0] * z + depth_affine[1]).reshape(hd, wd)
            bad = drng.random(dmap.shape) < depth_outliers
            dmap[bad] = drng.uniform(dmap.min(), dmap.max(), int(bad.sum()))
            np.save(os.path.join(root, "depths", f"frame_{k:04d}.npy"),
                    dmap.astype(np.float32))

        # the sparse points this view sees: its xys and the points' tracks
        pc = (pts3d @ Rw2c.T) + t
        vis = pc[:, 2] > 0.1
        uv = np.stack([pc[:, 0] / pc[:, 2] * fl + W / 2,
                       pc[:, 1] / pc[:, 2] * fl + H / 2], -1)
        vis &= (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        if depth_size is not None:
            # a capture with depth maps lists only the points the view
            # sees (none behind a surface), as a reconstruction would
            ids = np.nonzero(vis)[0]
            to = pts3d[ids] - center
            dist = np.linalg.norm(to, axis=-1)
            _, _, t_hit = scene.trace(
                np.broadcast_to(center, to.shape).astype(np.float32),
                to.astype(np.float32), return_t=True)
            vis[ids[t_hit < dist * (1 - 1e-3)]] = False
        vis_ids = np.nonzero(vis)[0]
        xys = uv[vis_ids]
        p3d_ids = vis_ids + 1   # colmap ids are 1-based
        for j, pid in enumerate(vis_ids):
            tracks[pid].append((k + 1, j))
        images[k + 1] = Image(
            k + 1, rotmat2qvec(Rw2c), t, 1, name,
            xys, p3d_ids.astype(np.int64))

    for i, p in enumerate(pts3d):
        tr = tracks[i] or [(1, 0)]
        points[i + 1] = Point3D(
            i + 1, p, np.array([128, 128, 128]), 0.5,
            np.array([a for a, _ in tr]), np.array([b for _, b in tr]))

    sp = os.path.join(root, "sparse", "0")
    write_cameras_binary(cams, os.path.join(sp, "cameras.bin"))
    write_images_binary(images, os.path.join(sp, "images.bin"))
    write_points3d_binary(points, os.path.join(sp, "points3D.bin"))
    return root
