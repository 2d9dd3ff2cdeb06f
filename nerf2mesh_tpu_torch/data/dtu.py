"""DTU / IDR-format dataset provider (port of nerf2mesh_tpu/data/dtu.py).

``cameras_sphere.npz`` holds world_mat_i (K[R|t]) and scale_mat_i (the
normalization); P = (world_mat @ scale_mat)[:3, :4] is decomposed into K,
R and the camera center, the poses get the axis rectification of the
reference (dtu_provider.py:109-112), and ``mask/*.png`` becomes the alpha
channel.  Val is every 8th view, train the rest, all every view, and test
the 11-pose slerp between two views (no images).  With ``--downscale`` the
RGBA frames are resized as Pillow's default BICUBIC does (premultiplied by
alpha, data/resize.py), as the JAX reader does through Pillow.  Images are
read with Pillow where it imports, else with the port's PNG codec.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..config import Config
from .png import read_image
from .provider import Dataset
from .rays import make_projection, nerf_matrix_to_ngp, slerp
from .resize import resize_bicubic


def decompose_projection(P: np.ndarray):
    """(intrinsic [fx, fy, cx, cy], cam2world pose [4, 4]) of a 3x4
    projection: cv2.decomposeProjectionMatrix's K and R by an RQ
    decomposition (through a flipped QR) with K's diagonal made positive,
    and the camera center solving M c = -p4."""
    M = P[:3, :3]
    q, r = np.linalg.qr(np.flipud(M).T)
    K = np.flipud(r.T)[:, ::-1]
    R = np.flipud(q.T)
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1
    K = K * signs[None, :]
    R = R * signs[:, None]
    if np.linalg.det(R) < 0:
        R = -R
    t = np.linalg.lstsq(-M, P[:3, 3], rcond=None)[0]
    K = K / K[2, 2]
    intrinsic = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = t
    return intrinsic, pose


def load_dtu_dataset(cfg: Config, split: str = "train",
                     n_test: int = 10) -> Dataset:
    """Load one split (train, val, test, or all for any other name) of a
    DTU directory: cameras_sphere.npz, image/*.png, mask/*.png."""
    root = cfg.path
    scale = 1.0 if cfg.scale == -1 else cfg.scale
    downscale = cfg.downscale
    cams = np.load(os.path.join(root, "cameras_sphere.npz"))
    image_paths = sorted(glob.glob(os.path.join(root, "image", "*.png")))
    mask_paths = sorted(glob.glob(os.path.join(root, "mask", "*.png")))
    if not image_paths:
        raise FileNotFoundError(f"no image/*.png under {root}")

    intrinsics, poses = [], []
    for i in range(len(image_paths)):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        intr, pose = decompose_projection(P)
        intrinsics.append(intr / downscale)
        poses.append(nerf_matrix_to_ngp(pose, scale=scale, offset=cfg.offset))
    intrinsics = np.stack(intrinsics).astype(np.float32)
    poses = np.stack(poses).astype(np.float64)
    # the reference's axis rectification (dtu_provider.py:109-112)
    poses[:, :3, 1:3] *= -1
    poses = poses[:, [1, 0, 2, 3], :]
    poses[:, 2] *= -1
    poses = poses.astype(np.float32)

    images = None
    if split == "test":
        rng = np.random.default_rng(0)
        fs = rng.choice(len(poses), min(2, len(poses)), replace=False)
        p0, p1 = poses[fs[0]], poses[fs[-1]]
        traj = []
        for i in range(n_test + 1):
            ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = slerp(p0[:3, :3], p1[:3, :3], ratio)
            pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
            traj.append(pose)
        img0 = read_image(image_paths[0])
        H, W = img0.shape[0] // downscale, img0.shape[1] // downscale
        poses = np.stack(traj)
        intrinsics = np.tile(intrinsics[:1], (len(poses), 1))
    else:
        ids = np.arange(len(image_paths))
        val_ids = ids[::8]
        sel = (np.setdiff1d(ids, val_ids) if split == "train"
               else val_ids if split == "val" else ids)
        poses, intrinsics = poses[sel], intrinsics[sel]
        H = W = None
        imgs = []
        for i in sel:
            img = read_image(image_paths[i])[..., :3]
            if H is None:
                H, W = img.shape[0] // downscale, img.shape[1] // downscale
            if i < len(mask_paths):
                m = read_image(mask_paths[i])
                if m.ndim == 3:
                    m = m[..., 0]
                img = np.concatenate([img, m[..., None]], -1)
            if img.shape[0] != H or img.shape[1] != W:
                img = resize_bicubic(img, W, H)
            imgs.append(img.astype(np.uint8))
        images = np.stack(imgs)

    projections = np.stack([make_projection(H, W, float(i[1]), cfg.min_near)
                            for i in intrinsics])
    mvps = np.einsum("nij,njk->nik", projections,
                     np.linalg.inv(poses)).astype(np.float32)
    return Dataset(poses=poses, images=images, intrinsics=intrinsics, H=H,
                   W=W, projection=projections[0], mvps=mvps,
                   training=split in ("train", "all", "trainval"))
