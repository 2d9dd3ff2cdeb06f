"""COLMAP dataset provider (port of nerf2mesh_tpu/data/colmap.py; reference
nerf/colmap_provider.py).

``load_colmap_dataset`` reads a COLMAP sparse model (colmap_sparse/0,
sparse/0 or colmap/) and its images (images_{downscale}/, else images/):
per-image intrinsics of the SIMPLE_RADIAL, SIMPLE_PINHOLE, PINHOLE and
OPENCV models scaled by downscale; cam2world = inv([R|t]); the poses
centred on the camera centres (--enable_cam_center) or the sparse points'
mean, with the mean up axis turned to +z; the axis rectification; the
auto-scale of --scale -1; the sparse points' box ``pts_aabb``; each view's
near/far from the depths of the sparse points it sees; every 8th image as
the val split; the test trajectory (``camera_traj`` circle, else a slerp
through 5 views); a mask/ folder as alpha; per-image MVPs.  Every array is
the JAX reader's, bit for bit (tests/test_torch_colmap.py).

Depth supervision (colmap_provider.py:229-327): under
--enable_sparse_depth each view keeps the (row, col) pixels of the sparse
points it sees, their depths and the weights 2 exp(-(err / mean err)^2);
under --enable_dense_depth each view's depths/<name>.npy map is resized to
the frames' size (cv2's INTER_LINEAR, data/resize.py) and mapped by the
affine that a RANSAC line fit (data/ransac.py, in place of sklearn's)
finds from the map to the sparse depths at those pixels.

Images are read with Pillow where it is importable, else with the port's
PNG codec (data/png.py) and JPEG decoder (data/jpeg.py); a frame whose size
differs from the camera's after downscale is resized with Pillow's default
BICUBIC filter (data/resize.py), as JAX's reader does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import Config
from .png import read_image
from .provider import Dataset
from .ransac import ransac_line
from .rays import make_projection, slerp
from .resize import resize_bicubic, resize_linear


def rotmat_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-10:
        return rotmat_between(a + np.random.uniform(-1e-2, 1e-2, 3), b)
    s = np.linalg.norm(v)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k * ((1 - c) / (s ** 2 + 1e-10))


def center_poses(poses: np.ndarray, pts3d: Optional[np.ndarray],
                 enable_cam_center: bool):
    """Move the centre (camera centres' or the points' mean) to the origin
    and turn the mean up axis to +z (colmap_provider.py:30-54)."""
    if pts3d is None or enable_cam_center:
        center = poses[:, :3, 3].mean(0)
    else:
        center = pts3d.mean(0)
    up = poses[:, :3, 1].mean(0)
    up = up / (np.linalg.norm(up) + 1e-10)
    R = np.pad(rotmat_between(up, np.array([0.0, 0, 1])), [(0, 1), (0, 1)])
    R[-1, -1] = 1
    poses = poses.copy()
    poses[:, :3, 3] -= center
    poses = R @ poses
    if pts3d is not None:
        pts3d = (pts3d - center) @ R[:3, :3].T
    return poses, pts3d


def fit_dense_depth(dd: np.ndarray, xy: np.ndarray, depth: np.ndarray,
                    weight: np.ndarray, rng: np.random.Generator):
    """(scale, bias) mapping a dense map dd [H, W] to the sparse depths at
    their pixels xy [R, 2] (row, col): the RANSAC line, or when its slope
    is negative the line through the two heaviest points, or failing that
    a scale alone (JAX colmap.py:204-216)."""
    X = dd[tuple(xy.T)].astype(np.float64)
    Y = np.asarray(depth, np.float64)
    s, b = ransac_line(X, Y, weight, rng)
    if s < 0:
        order = np.argsort(weight)[::-1]
        x0, y0 = X[order[0]], Y[order[0]]
        x1, y1 = X[order[1]], Y[order[1]]
        s = (y0 - y1) / max(x0 - x1, 1e-9)
        b = y0 - x0 * s
        if s < 0:
            s, b = y0 / max(x0, 1e-9), 0.0
    return float(s), float(b)


def _test_trajectory(cfg: Config, poses: np.ndarray, n_test: int):
    traj = []
    if cfg.camera_traj == "circle":
        radius, theta = 0.1, np.deg2rad(80)
        for i in range(100):
            phi = np.deg2rad(i / 100 * 360)
            center = np.array([radius * np.sin(theta) * np.sin(phi),
                               radius * np.sin(theta) * np.cos(phi),
                               radius * np.cos(theta)])
            fwd = center / (np.linalg.norm(center) + 1e-10)
            up = np.array([0.0, 0, 1])
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right) + 1e-10
            up = np.cross(right, fwd)
            pose = np.eye(4)
            pose[:3, :3] = np.stack([right, up, fwd], -1)
            pose[:3, 3] = center
            traj.append(pose)
    else:
        rng = np.random.default_rng(0)
        fs = rng.choice(len(poses), min(5, len(poses)), replace=False)
        p0 = poses[fs[0]]
        for j in range(1, len(fs)):
            p1 = poses[fs[j]]
            for i in range(n_test + 1):
                ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
                pose = np.eye(4)
                pose[:3, :3] = slerp(p0[:3, :3], p1[:3, :3], ratio)
                pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
                traj.append(pose)
            p0 = p1
    return np.stack(traj)


def load_colmap_dataset(cfg: Config, split: str = "train",
                        n_test: int = 24) -> Dataset:
    """One split (train, val, all or test) of a COLMAP capture."""
    from .colmap_utils import (read_cameras_binary, read_images_binary,
                               read_points3d_binary)

    root = cfg.path
    downscale = cfg.downscale
    training = split in ("train", "all", "trainval")

    colmap_path = None
    for cand in ("colmap_sparse/0", "sparse/0", "colmap"):
        p = os.path.join(root, cand)
        if os.path.exists(p):
            colmap_path = p
            break
    if colmap_path is None:
        raise FileNotFoundError(f"no colmap sparse model under {root}")

    camdata = read_cameras_binary(os.path.join(colmap_path, "cameras.bin"))
    first_cam = camdata[sorted(camdata.keys())[0]]
    H = int(round(first_cam.height / downscale))
    W = int(round(first_cam.width / downscale))

    imdata = read_images_binary(os.path.join(colmap_path, "images.bin"))
    imkeys = np.array(sorted(imdata.keys()))

    img_names = [os.path.basename(imdata[k].name) for k in imkeys]
    img_folder = os.path.join(root, f"images_{downscale}")
    if not os.path.exists(img_folder):
        img_folder = os.path.join(root, "images")
    img_paths = np.array([os.path.join(img_folder, n) for n in img_names])
    exist = np.array([os.path.exists(p) for p in img_paths])
    imkeys, img_paths = imkeys[exist], img_paths[exist]

    mask_folder = os.path.join(root, "mask")
    mask_paths = None
    if os.path.exists(mask_folder):
        mask_paths = np.array([
            os.path.join(mask_folder,
                         os.path.splitext(os.path.basename(p))[0] + ".png")
            for p in img_paths])

    # intrinsics per image (colmap_provider.py:166-181)
    intr = []
    for k in imkeys:
        cam = camdata[imdata[k].camera_id]
        if cam.model in ("SIMPLE_RADIAL", "SIMPLE_PINHOLE"):
            fl_x = fl_y = cam.params[0] / downscale
            cx, cy = cam.params[1] / downscale, cam.params[2] / downscale
        elif cam.model in ("PINHOLE", "OPENCV"):
            fl_x, fl_y = cam.params[0] / downscale, cam.params[1] / downscale
            cx, cy = cam.params[2] / downscale, cam.params[3] / downscale
        else:
            raise ValueError(f"unsupported camera model {cam.model}")
        intr.append([fl_x, fl_y, cx, cy])
    intrinsics = np.asarray(intr, np.float32)                 # [N, 4]

    # cam2world
    poses = []
    for k in imkeys:
        P = np.eye(4)
        P[:3, :3] = imdata[k].qvec2rotmat()
        P[:3, 3] = imdata[k].tvec
        poses.append(P)
    poses = np.linalg.inv(np.stack(poses))

    ptsdata = read_points3d_binary(os.path.join(colmap_path, "points3D.bin"))
    ptskeys = np.array(sorted(ptsdata.keys()))
    pts3d = np.array([ptsdata[k].xyz for k in ptskeys])
    ptserr = np.array([ptsdata[k].error for k in ptskeys])
    mean_ptserr = float(np.mean(ptserr)) if len(ptserr) else 1.0

    poses, pts3d = center_poses(poses, pts3d, cfg.enable_cam_center)

    # rectify the axis convention (colmap_provider.py:206-211)
    poses[:, :3, 1:3] *= -1
    poses = poses[:, [1, 0, 2, 3], :]
    poses[:, 2] *= -1
    pts3d = pts3d[:, [1, 0, 2]]
    pts3d[:, 2] *= -1

    scale = cfg.scale
    if scale == -1:
        scale = 1.0 / np.linalg.norm(poses[:, :3, 3], axis=-1).min()
    poses[:, :3, 3] *= scale
    pts3d = pts3d * scale

    pts_aabb = np.concatenate([pts3d.min(0), pts3d.max(0)]).astype(np.float32)

    # per-view near/far from the depths of the sparse points each view sees
    # (colmap_provider.py:229-270), and the depth supervision; the points'
    # ids are 1-based and ids not in the model map to the pad row
    # len(ptskeys)
    cam_near_far = sparse_depth = dense_depth = None
    if split != "test":
        rng = np.random.default_rng(cfg.seed)
        sd_list, dd_list = [], []
        key_to_id = np.full(int(ptskeys.max()) + 1 if len(ptskeys) else 1,
                            len(ptskeys), np.int64)
        key_to_id[ptskeys] = np.arange(len(ptskeys))
        cam_near_far = []
        for i, k in enumerate(imkeys):
            xys = imdata[k].xys
            xys = np.stack([xys[:, 1], xys[:, 0]], -1)    # (row, col)
            pids = imdata[k].point3D_ids
            m = (pids != -1) & (xys[:, 0] >= 0) & (xys[:, 0] < first_cam.height) \
                & (xys[:, 1] >= 0) & (xys[:, 1] < first_cam.width)
            ids = key_to_id[pids[m]]
            pts = pts3d[ids]
            P = poses[i]
            depth = (P[:3, 3] - pts) @ P[:3, 2]
            cam_near_far.append([float(depth.min()), float(depth.max())]
                                if len(depth) else [cfg.min_near, 1000.0])
            if not (cfg.enable_sparse_depth or cfg.enable_dense_depth):
                continue
            xy = np.round(xys[m] / downscale).astype(np.int32)
            xy[:, 0] = xy[:, 0].clip(0, H - 1)
            xy[:, 1] = xy[:, 1].clip(0, W - 1)
            weight = 2 * np.exp(-(ptserr[ids] / mean_ptserr) ** 2)
            if cfg.enable_sparse_depth:
                sd_list.append((xy, depth.astype(np.float32),
                                weight.astype(np.float32)))
            if cfg.enable_dense_depth:
                dpath = os.path.join(
                    root, "depths",
                    os.path.splitext(os.path.basename(imdata[k].name))[0]
                    + ".npy")
                if not os.path.exists(dpath):
                    raise RuntimeError(
                        f"{dpath}: dense depth missing; run "
                        "scripts/extract_depth.py")
                dd = resize_linear(np.load(dpath), W, H)
                s_, b_ = fit_dense_depth(dd, xy, depth, weight, rng)
                dd_list.append((dd * s_ + b_).astype(np.float32))
        cam_near_far = np.asarray(cam_near_far, np.float32)
        if cfg.enable_sparse_depth:
            sparse_depth = sd_list
        if cfg.enable_dense_depth:
            dense_depth = np.stack(dd_list)

    images = None
    if split == "test":
        poses = _test_trajectory(cfg, poses, n_test)
        intrinsics = np.tile(intrinsics[:1], (len(poses), 1))
    else:
        all_ids = np.arange(len(img_paths))
        val_ids = all_ids[::8]
        if split == "train":
            sel = np.array([i for i in all_ids if i not in val_ids])
        elif split == "val":
            sel = val_ids
        else:
            sel = all_ids
        poses = poses[sel]
        intrinsics = intrinsics[sel]
        img_paths = img_paths[sel]
        if mask_paths is not None:
            mask_paths = mask_paths[sel]
        if cam_near_far is not None:
            cam_near_far = cam_near_far[sel]
        if sparse_depth is not None:
            sparse_depth = [sparse_depth[i] for i in sel]
        if dense_depth is not None:
            dense_depth = dense_depth[sel]

        imgs = []
        for i, p in enumerate(img_paths):
            img = read_image(p)
            if img.ndim == 2:
                img = img[..., None].repeat(3, -1)
            if mask_paths is not None and os.path.exists(mask_paths[i]):
                mask = read_image(mask_paths[i])
                if mask.ndim == 2:
                    mask = mask[..., None]
                img = np.concatenate([img[..., :3], mask[..., :1]], -1)
            if img.shape[0] != H or img.shape[1] != W:
                img = resize_bicubic(img, W, H)
            imgs.append(img.astype(np.uint8))
        images = np.stack(imgs)

    # per-image projections and MVPs (colmap_provider.py:482-494)
    projections = np.stack([
        make_projection(H, W, float(i[1]), cfg.min_near) for i in intrinsics])
    mvps = np.einsum("nij,njk->nik",
                     projections, np.linalg.inv(poses)).astype(np.float32)

    return Dataset(
        poses=poses.astype(np.float32), images=images,
        intrinsics=intrinsics, H=H, W=W,
        projection=projections[0], mvps=mvps,
        training=training, cam_near_far=cam_near_far,
        pts_aabb=pts_aabb, pts3d=pts3d, sparse_depth=sparse_depth,
        dense_depth=dense_depth)
