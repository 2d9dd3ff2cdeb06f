"""NeRF-synthetic / blender dataset provider (port of nerf2mesh_tpu/data/provider.py).

The dataset is host numpy, materialized once; the trainer moves it to the
device and samples rays there.  ``load_nerf_dataset`` reads a blender-format
directory (its PNGs with Pillow where it is importable, else with the
port's codec, data/png.py) with the keys JAX's reader takes: ``fl_x`` /
``fl_y`` or ``camera_angle_x`` / ``camera_angle_y``, ``cx`` / ``cy``,
``h`` / ``w``, and a ``mask`` directory beside ``images/`` paths as alpha;
the splits train, val, test, trainval (train + val) and all (every
transforms_*.json); ``downscale`` divides the json's size and focal
lengths, and a frame of another size is resized to it with cv2's
INTER_AREA filter (data/resize.py), as JAX's reader does where cv2
imports.  A directory with a single ``transforms.json`` (what
colmap2nerf.py writes) is read in the reference's "colmap" mode: train is
every frame but the first, val the first, trainval and all every frame,
and test the 11-pose slerp between two frames (no images).
``dataset_from_frames`` builds the identical Dataset from in-memory frames
(data/synthetic.py).  The COLMAP reader is data/colmap.py, the DTU reader
data/dtu.py.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import Config
from .png import read_image
from .rays import make_mvps, make_projection, nerf_matrix_to_ngp, slerp
from .resize import resize_area


@dataclass
class Dataset:
    """In-memory dataset; all arrays are host numpy."""
    poses: np.ndarray                 # [B, 4, 4] cam2world, float32
    images: Optional[np.ndarray]      # [B, H, W, C] uint8
    intrinsics: np.ndarray            # [4] fx fy cx cy, or [B, 4] a view
    H: int
    W: int
    projection: np.ndarray            # [4, 4]
    mvps: np.ndarray                  # [B, 4, 4]
    training: bool
    cam_near_far: Optional[np.ndarray] = None   # [B, 2] or None
    pts_aabb: Optional[np.ndarray] = None       # [6] colmap: sparse-point box
    pts3d: Optional[np.ndarray] = None          # [P, 3] colmap: sparse points
    # colmap depth supervision: a view's (pixel (row, col) [R, 2] int32,
    # depth [R], weight [R]), or the views' fitted maps [B, H, W]
    sparse_depth: Optional[list] = None
    dense_depth: Optional[np.ndarray] = None

    @property
    def num_frames(self) -> int:
        return self.poses.shape[0]

    def intrinsics_for(self, i: int) -> np.ndarray:
        intr = np.asarray(self.intrinsics)
        return intr[i] if intr.ndim == 2 else intr

    @property
    def has_gt(self) -> bool:
        return self.images is not None


def _intrinsics(transform: dict, H: int, W: int, downscale: int = 1):
    """(fl_x, fl_y, cx, cy) from a transforms json at the downscaled size
    (H, W), resolved as JAX's reader does
    (nerf2mesh_tpu/data/provider.py:171-184)."""
    if "fl_x" in transform or "fl_y" in transform:
        fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
        fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
    elif "camera_angle_x" in transform or "camera_angle_y" in transform:
        fl_x = (W / (2 * np.tan(transform["camera_angle_x"] / 2))
                if "camera_angle_x" in transform else None)
        fl_y = (H / (2 * np.tan(transform["camera_angle_y"] / 2))
                if "camera_angle_y" in transform else None)
        fl_x = fl_x if fl_x is not None else fl_y
        fl_y = fl_y if fl_y is not None else fl_x
    else:
        raise RuntimeError("no focal length in transforms json")
    cx = transform["cx"] / downscale if "cx" in transform else W / 2.0
    cy = transform["cy"] / downscale if "cy" in transform else H / 2.0
    return fl_x, fl_y, cx, cy


def _finish(cfg: Config, poses: np.ndarray, images: Optional[np.ndarray],
            transform: dict, split: str, H: int, W: int,
            downscale: int = 1) -> Dataset:
    """Shared tail of the constructors (intrinsics + MVPs); poses are
    already in the scene's frame (nerf_matrix_to_ngp)."""
    poses_arr = np.asarray(poses, np.float32)
    fl_x, fl_y, cx, cy = _intrinsics(transform, H, W, downscale)
    intrinsics = np.array([fl_x, fl_y, cx, cy], np.float32)
    projection = make_projection(H, W, fl_y, cfg.min_near)
    return Dataset(
        poses=poses_arr, images=images, intrinsics=intrinsics, H=H, W=W,
        projection=projection, mvps=make_mvps(projection, poses_arr),
        training=split in ("train", "all", "trainval"))


def _to_ngp(cfg: Config, pose) -> np.ndarray:
    scale = 1.0 if cfg.scale == -1 else cfg.scale
    return nerf_matrix_to_ngp(np.array(pose, np.float32), scale, cfg.offset)


def _slerp_trajectory(cfg: Config, frames: list, n_test: int) -> np.ndarray:
    """The single transforms.json's test path: n_test + 1 poses from one
    frame to another (both drawn by default_rng(0)), eased by a sine (JAX
    provider.py:118-128)."""
    rng = np.random.default_rng(0)
    f0, f1 = rng.choice(len(frames), 2, replace=False)
    p0 = _to_ngp(cfg, frames[f0]["transform_matrix"])
    p1 = _to_ngp(cfg, frames[f1]["transform_matrix"])
    poses = []
    for i in range(n_test + 1):
        ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = slerp(p0[:3, :3], p1[:3, :3], ratio)
        pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
        poses.append(pose)
    return np.stack(poses)


def _read_transforms(root: str, split: str) -> dict:
    """The split's transforms json; trainval is train + val, all every
    transforms_*.json in name order (JAX provider.py:87-106)."""
    def read(name):
        path = os.path.join(root, name)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} not found")
        with open(path) as f:
            return json.load(f)
    if split == "all":
        paths = sorted(glob.glob(os.path.join(root, "transforms_*.json")))
        transform = read(os.path.basename(paths[0]))
        for p in paths[1:]:
            transform["frames"].extend(read(os.path.basename(p))["frames"])
    elif split == "trainval":
        transform = read("transforms_train.json")
        transform["frames"].extend(read("transforms_val.json")["frames"])
    else:
        transform = read(f"transforms_{split}.json")
    return transform


def load_nerf_dataset(cfg: Config, split: str = "train",
                      n_test: int = 10) -> Dataset:
    """Load one split of a nerf-synthetic / blender directory, or of a
    single transforms.json (see the module docstring)."""
    root = cfg.path
    downscale = cfg.downscale
    single = os.path.exists(os.path.join(root, "transforms.json"))
    if single:
        with open(os.path.join(root, "transforms.json")) as f:
            transform = json.load(f)
    elif os.path.exists(os.path.join(root, "transforms_train.json")):
        transform = _read_transforms(root, split)
    else:
        raise FileNotFoundError(f"no transforms*.json under {root}")
    H = int(transform["h"]) // downscale if "h" in transform else None
    W = int(transform["w"]) // downscale if "w" in transform else None
    frames = transform["frames"]
    if single and split == "test":
        poses = _slerp_trajectory(cfg, frames, n_test)
        if H is None:
            img = read_image(os.path.join(root, frames[0]["file_path"]))
            H, W = img.shape[0] // downscale, img.shape[1] // downscale
        return _finish(cfg, poses, None, transform, split, H, W, downscale)
    if single and split == "train":
        frames = frames[1:]
    elif single and split == "val":
        frames = frames[:1]
    poses, images = [], []
    for fr in frames:
        f_path = os.path.join(root, fr["file_path"])
        if not single and "." not in os.path.basename(f_path):
            f_path += ".png"
        if not os.path.exists(f_path):
            continue
        img = read_image(f_path)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if H is None:
            H, W = img.shape[0] // downscale, img.shape[1] // downscale
        m_path = f_path.replace("images", "mask")     # a mask dir as alpha
        if m_path != f_path and os.path.exists(m_path):
            mask = read_image(m_path)
            if mask.ndim == 2:
                mask = mask[..., None]
            img = np.concatenate([img[..., :3], mask[..., :1]], axis=-1)
        if img.shape[0] != H or img.shape[1] != W:
            img = resize_area(img, W, H)
        poses.append(_to_ngp(cfg, fr["transform_matrix"]))
        images.append(img)
    images = np.stack(images).astype(np.uint8)
    return _finish(cfg, np.stack(poses), images, transform, split,
                   images.shape[1], images.shape[2], downscale)


def dataset_from_frames(cfg: Config, frames: dict, split: str = "train") -> Dataset:
    """The Dataset load_nerf_dataset would build from the directory that
    generate_synthetic_dataset writes; frames = render_synthetic_frames()."""
    fr = frames[split]
    images = np.stack(fr["images"]).astype(np.uint8)
    return _finish(cfg, np.stack([_to_ngp(cfg, p) for p in fr["poses"]]),
                   images, {"camera_angle_x": fr["camera_angle_x"]}, split,
                   images.shape[1], images.shape[2])
