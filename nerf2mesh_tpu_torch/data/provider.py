"""NeRF-synthetic / blender dataset provider (port of nerf2mesh_tpu/data/provider.py).

The dataset is host numpy, materialized once; the trainer moves it to the
device and samples rays there.  ``load_nerf_dataset`` reads a blender-format
directory (its PNGs with Pillow where it is importable, else with the
port's codec, data/png.py); ``dataset_from_frames`` builds the identical
Dataset from in-memory frames (data/synthetic.py).  The colmap / dtu
formats are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import Config
from .png import read_image
from .rays import make_mvps, make_projection, nerf_matrix_to_ngp


@dataclass
class Dataset:
    """In-memory dataset; all arrays are host numpy."""
    poses: np.ndarray                 # [B, 4, 4] cam2world, float32
    images: Optional[np.ndarray]      # [B, H, W, C] uint8
    intrinsics: np.ndarray            # [4] fx fy cx cy
    H: int
    W: int
    projection: np.ndarray            # [4, 4]
    mvps: np.ndarray                  # [B, 4, 4]
    training: bool
    cam_near_far: Optional[np.ndarray] = None   # [B, 2] or None

    @property
    def num_frames(self) -> int:
        return self.poses.shape[0]

    def intrinsics_for(self, i: int) -> np.ndarray:
        intr = np.asarray(self.intrinsics)
        return intr[i] if intr.ndim == 2 else intr

    @property
    def has_gt(self) -> bool:
        return self.images is not None


def _finish(cfg: Config, poses: List[np.ndarray], images: List[np.ndarray],
            camera_angle_x: float, split: str) -> Dataset:
    """Shared tail of both constructors (blender intrinsics + MVPs)."""
    scale = 1.0 if cfg.scale == -1 else cfg.scale
    poses_arr = np.stack([nerf_matrix_to_ngp(p, scale, cfg.offset)
                          for p in poses]).astype(np.float32)
    images_arr = np.stack(images).astype(np.uint8)
    H, W = images_arr.shape[1], images_arr.shape[2]
    fl = W / (2 * np.tan(camera_angle_x / 2))
    intrinsics = np.array([fl, fl, W / 2.0, H / 2.0], np.float32)
    projection = make_projection(H, W, fl, cfg.min_near)
    return Dataset(
        poses=poses_arr, images=images_arr, intrinsics=intrinsics, H=H, W=W,
        projection=projection, mvps=make_mvps(projection, poses_arr),
        training=split in ("train", "all", "trainval"))


def load_nerf_dataset(cfg: Config, split: str = "train") -> Dataset:
    """Load one split of a nerf-synthetic / blender directory."""
    root = cfg.path
    if cfg.downscale != 1:
        raise NotImplementedError("downscale is not ported yet (ROADMAP A11)")
    path = os.path.join(root, f"transforms_{split}.json")
    if not os.path.exists(path):
        raise NotImplementedError(
            f"{path} not found: only the blender split-file format is ported "
            "(colmap/dtu and the trainval/all splits: ROADMAP A11)")
    with open(path) as f:
        transform = json.load(f)
    if "camera_angle_x" not in transform or "fl_x" in transform:
        raise NotImplementedError("only camera_angle_x intrinsics are ported")
    poses, images = [], []
    for fr in transform["frames"]:
        f_path = os.path.join(root, fr["file_path"])
        if "." not in os.path.basename(f_path):
            f_path += ".png"
        if not os.path.exists(f_path):
            continue
        img = read_image(f_path)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        poses.append(np.array(fr["transform_matrix"], np.float32))
        images.append(img)
    return _finish(cfg, poses, images, transform["camera_angle_x"], split)


def dataset_from_frames(cfg: Config, frames: dict, split: str = "train") -> Dataset:
    """The Dataset load_nerf_dataset would build from the directory that
    generate_synthetic_dataset writes; frames = render_synthetic_frames()."""
    fr = frames[split]
    return _finish(cfg, list(fr["poses"]), list(fr["images"]),
                   fr["camera_angle_x"], split)
