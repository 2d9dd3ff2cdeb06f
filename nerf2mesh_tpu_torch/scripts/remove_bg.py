#!/usr/bin/env python3
"""Background masks: images/ -> mask/ (the port's counterpart of
scripts/remove_bg.py).

Ports the numpy border-statistics mask: the distance of each pixel from
the median colour of the image's border, thresholded (a studio capture
with a roughly uniform background).  The JAX script's segmentation-model
path (rembg/carvekit) is not ported: it needs model weights that the
repository does not hold.

    python -m nerf2mesh_tpu_torch.scripts.remove_bg <scene dir>
"""

import argparse
import glob
import os

import numpy as np

from nerf2mesh_tpu_torch.data.png import read_image, write_image


def simple_mask(img: np.ndarray) -> np.ndarray:
    """uint8 mask (0 or 255) of the pixels far from the border colour."""
    f = img.astype(np.float32)
    border = np.concatenate([
        f[0].reshape(-1, 3), f[-1].reshape(-1, 3),
        f[:, 0].reshape(-1, 3), f[:, -1].reshape(-1, 3)])
    bg = np.median(border, axis=0)
    dist = np.linalg.norm(f - bg, axis=-1)
    thr = max(30.0, dist.mean() * 0.5)
    return (dist > thr).astype(np.uint8) * 255


def rgb(img: np.ndarray) -> np.ndarray:
    """Pillow's convert("RGB") of a grey, RGB or RGBA uint8 image."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path", help="scene dir containing images/")
    args = p.parse_args(argv)

    src = os.path.join(args.path, "images")
    dst = os.path.join(args.path, "mask")
    os.makedirs(dst, exist_ok=True)
    files = sorted(sum((glob.glob(os.path.join(src, e))
                        for e in ("*.jpg", "*.png", "*.jpeg")), []))
    for f in files:
        img = read_image(f)
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        write_image(os.path.join(dst, name), simple_mask(rgb(img)))
    print(f"[done] wrote {len(files)} masks to {dst}")


if __name__ == "__main__":
    main()
