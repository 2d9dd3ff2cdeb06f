"""read_image's fixed cost, parent against change in one process: the
parent checkout's nerf2mesh_tpu_torch is imported under another name
beside this checkout's, and rounds alternate which goes first, so both
meet the same host, file cache and load.

    python3 workspace/port/read_ab.py <parent checkout> [--rounds N]

Per round and side: the mean read_image time a file over the TGA and the
small (non-512) JPEG 2000 fixtures, and the mean read alone (the parent's
buffered open().read(), the change's png.read_bytes).  Prints the medians,
the quartiles of each side's rounds and the rounds the change won."""
import argparse
import glob
import importlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("parent")
ap.add_argument("--rounds", type=int, default=15)
args = ap.parse_args()
here = os.getcwd()
tmp = tempfile.mkdtemp(prefix="read_ab_")
shutil.copytree(os.path.join(args.parent, "nerf2mesh_tpu_torch"),
                os.path.join(tmp, "n2m_parent"),
                ignore=shutil.ignore_patterns("build", "fixtures"))
sys.path[:0] = [here, tmp]
sides = {}
for name, pkg in (("parent", "n2m_parent"), ("change", "nerf2mesh_tpu_torch")):
    png = importlib.import_module(pkg + ".data.png")
    read = getattr(png, "read_bytes", None) or (
        lambda f: open(f, "rb").read())
    sides[name] = (png.read_image, read)
fx = os.path.join(here, "nerf2mesh_tpu_torch", "fixtures", "formats")
sets = {"tga": sorted(glob.glob(fx + "/tga/*")),
        "j2k": [f for f in sorted(glob.glob(fx + "/jpeg2000/*"))
                if "512" not in f]}
for name, (ri, _) in sides.items():          # builds each side's decoders
    for files in sets.values():
        for f in files:
            ri(f)


def per_file(fn, files):
    t = time.perf_counter()
    for f in files:
        fn(f)
    return (time.perf_counter() - t) / len(files) * 1e6


res = {(s, k, w): [] for s in sides for k in sets for w in ("image", "read")}
for r in range(args.rounds):
    order = list(sides) if r % 2 == 0 else list(sides)[::-1]
    for s in order:
        ri, rd = sides[s]
        for k, files in sets.items():
            res[(s, k, "image")].append(per_file(ri, files))
            res[(s, k, "read")].append(per_file(rd, files))
for k in sets:
    for w in ("image", "read"):
        p, c = (np.array(res[(s, k, w)]) for s in ("parent", "change"))
        q = {s: np.percentile(v, [25, 50, 75]).round(1).tolist()
             for s, v in (("parent", p), ("change", c))}
        print(f"{k} {w}: us a file, quartiles (25, 50, 75) {q}; the change "
              f"faster in {int((c < p).sum())} of {len(p)} rounds",
              flush=True)
shutil.rmtree(tmp, ignore_errors=True)
