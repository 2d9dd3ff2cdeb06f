#!/usr/bin/env python3
"""Build an image pyramid: images/ -> images_{k}/ at 1/k scale (the port's
counterpart of scripts/downscale.py).

Resizes with cv2's INTER_AREA filter in numpy (data/resize.py), the
port's area filter, where the JAX script takes Pillow's LANCZOS; PNG and
JPEG frames are read with the port's decoders and written with its
codecs (PNGs through Pillow where it imports).

    python -m nerf2mesh_tpu_torch.scripts.downscale <scene dir> [--downscale 2 4 8]
"""

import argparse
import glob
import os

from nerf2mesh_tpu_torch.data.jpeg import save_jpeg
from nerf2mesh_tpu_torch.data.png import read_image, write_image
from nerf2mesh_tpu_torch.data.resize import resize_area

JPEG = (".jpg", ".jpeg")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path", help="scene dir containing images/")
    p.add_argument("--downscale", type=int, nargs="+", default=[2, 4, 8])
    args = p.parse_args(argv)

    src = os.path.join(args.path, "images")
    files = sorted(sum((glob.glob(os.path.join(src, e))
                        for e in ("*.jpg", "*.png", "*.jpeg", "*.JPG")), []))
    for k in args.downscale:
        dst = os.path.join(args.path, f"images_{k}")
        os.makedirs(dst, exist_ok=True)
        for f in files:
            jpeg = f.lower().endswith(JPEG)
            img = read_image(f)
            img = resize_area(img, img.shape[1] // k, img.shape[0] // k)
            out = os.path.join(dst, os.path.basename(f))
            if jpeg:
                save_jpeg(out, img)
            else:
                write_image(out, img)
        print(f"[done] images_{k}: {len(files)} images")


if __name__ == "__main__":
    main()
