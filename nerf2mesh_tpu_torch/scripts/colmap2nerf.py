#!/usr/bin/env python3
"""Convert a COLMAP reconstruction (or a video or an image folder) to the
single transforms.json that the port's blender reader takes (the port's
counterpart of scripts/colmap2nerf.py).

Steps (the first two optional):
  --video <mp4>   extract frames into images/ with ffmpeg at --video_fps;
  --run_colmap    run colmap's feature extractor, matcher, mapper and bundle
                  adjuster on images/ (also when no sparse model exists);
  always          read the binary sparse model (data/colmap_utils.py) and
                  write transforms.json: each frame's sharpness (the
                  variance of the grey image's 3x3 Laplacian, as
                  cv2.Laplacian gives it), the poses in the NeRF convention,
                  centred and with the mean up vector turned to +z.

The ffmpeg and colmap steps need those programs on PATH.

    python -m nerf2mesh_tpu_torch.scripts.colmap2nerf --path <scene dir>
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np


def read_frame(path: str) -> np.ndarray:
    """An image as uint8 [H, W, C] (JPEG by its extension, else PNG)."""
    from nerf2mesh_tpu_torch.data.jpeg import read_jpeg
    from nerf2mesh_tpu_torch.data.png import read_image
    if path.lower().endswith((".jpg", ".jpeg")):
        return read_jpeg(path)
    return read_image(path)


def grey(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(BGR -> GRAY) of an RGB(A) or grey uint8 image: OpenCV's
    15-bit fixed-point weights, rounded."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.int64)
    y = rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


def laplacian(g: np.ndarray) -> np.ndarray:
    """cv2.Laplacian(g, CV_64F) (ksize 1: the 4-neighbour kernel) with
    OpenCV's default border, reflect-101."""
    p = np.pad(g.astype(np.float64), 1, mode="reflect")
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * p[1:-1, 1:-1])


def sharpness(path: str) -> float:
    """The variance of the frame's Laplacian; 100 for a frame that cannot be
    read (the reference's value when it cannot score one)."""
    try:
        img = read_frame(path)
    except (OSError, ValueError, NotImplementedError):
        return 100.0
    return float(laplacian(grey(img)).var())


def run(cmd):
    print("[run]", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path", required=True,
                   help="scene dir (contains images/)")
    p.add_argument("--video", default="", help="input video to extract "
                   "frames from")
    p.add_argument("--video_fps", type=int, default=3)
    p.add_argument("--run_colmap", action="store_true")
    p.add_argument("--matcher", default="sequential",
                   choices=["sequential", "exhaustive"])
    p.add_argument("--aabb_scale", type=int, default=4)
    args = p.parse_args(argv)

    images = os.path.join(args.path, "images")
    if args.video:
        os.makedirs(images, exist_ok=True)
        run(["ffmpeg", "-i", args.video, "-vf", f"fps={args.video_fps}",
             os.path.join(images, "%04d.jpg")])

    sparse = None
    for cand in ("colmap_sparse/0", "sparse/0", "colmap"):
        c = os.path.join(args.path, cand)
        if os.path.exists(c):
            sparse = c
            break

    if args.run_colmap or sparse is None:
        if shutil.which("colmap") is None:
            sys.exit("[ERROR] colmap binary not found on PATH")
        db = os.path.join(args.path, "colmap.db")
        sparse = os.path.join(args.path, "sparse")
        os.makedirs(sparse, exist_ok=True)
        run(["colmap", "feature_extractor", "--database_path", db,
             "--image_path", images,
             "--ImageReader.camera_model", "SIMPLE_PINHOLE",
             "--ImageReader.single_camera", "1"])
        run(["colmap", f"{args.matcher}_matcher", "--database_path", db])
        run(["colmap", "mapper", "--database_path", db,
             "--image_path", images, "--output_path", sparse])
        run(["colmap", "bundle_adjuster", "--input_path",
             os.path.join(sparse, "0"), "--output_path",
             os.path.join(sparse, "0"),
             "--BundleAdjustment.refine_principal_point", "1"])
        sparse = os.path.join(sparse, "0")

    from nerf2mesh_tpu_torch.data.colmap_utils import (read_cameras_binary,
                                                       read_images_binary)

    cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    ims = read_images_binary(os.path.join(sparse, "images.bin"))
    cam = cams[sorted(cams.keys())[0]]
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        fl_x = fl_y = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fl_x, fl_y = cam.params[0], cam.params[1]
        cx, cy = cam.params[2], cam.params[3]

    frames, c2ws = [], []
    for k in sorted(ims.keys()):
        im = ims[k]
        w2c = np.eye(4)
        w2c[:3, :3] = im.qvec2rotmat()
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1        # colmap (y down, z forward) -> NeRF
        c2ws.append(c2w)
        fpath = os.path.join("images", os.path.basename(im.name))
        frames.append({
            "file_path": fpath,
            "sharpness": sharpness(os.path.join(args.path, fpath)),
            "transform_matrix": c2w,
        })

    # centre the scene and turn the mean up vector to +z (reference
    # colmap2nerf.py:293-321)
    c2ws = np.stack(c2ws)
    center = c2ws[:, :3, 3].mean(0)
    up = c2ws[:, :3, 1].mean(0)
    up /= np.linalg.norm(up)
    v = np.cross(up, [0, 0, 1])
    c = float(np.dot(up, [0, 0, 1]))
    s = np.linalg.norm(v)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    R = np.eye(3) + K + K @ K * ((1 - c) / (s ** 2 + 1e-10))
    T = np.eye(4)
    T[:3, :3] = R
    for f in frames:
        m = np.array(f["transform_matrix"])
        m[:3, 3] -= center
        f["transform_matrix"] = (T @ m).tolist()

    out = {
        "camera_angle_x": 2 * math.atan(cam.width / (2 * fl_x)),
        "camera_angle_y": 2 * math.atan(cam.height / (2 * fl_y)),
        "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
        "w": cam.width, "h": cam.height,
        "aabb_scale": args.aabb_scale,
        "frames": frames,
    }
    with open(os.path.join(args.path, "transforms.json"), "w") as fp:
        json.dump(out, fp, indent=2)
    print(f"[done] wrote {len(frames)} frames to transforms.json")


if __name__ == "__main__":
    main()
