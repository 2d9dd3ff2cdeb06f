"""Save and load walls of the bench-width training state as an Orbax .ocp
and as a pickle, with the .ocp reader's two choices varied: the arrays
decoded on a thread pool or one after another, and the data file mapped
with MAP_POPULATE, mapped plainly, or read into memory.

    python3 workspace/port/ocp_walls.py [--reps 3] [--cpu]

A Trainer at chip_smoke's bench configuration gets random parameters,
EMA weights and Adam moments (what a trained state compresses like);
each load goes into a fresh Trainer, as a resume does, and each reader
variant's load is timed beside a pickle load, in turns.  Prints one line
a measurement and a last line ``OCP_WALLS {json}`` of the medians.
"""

import argparse
import dataclasses
import json
import mmap
import os
import shutil
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, REPO)

import chip_smoke as cs                                        # noqa: E402
from nerf2mesh_tpu_torch.utils import ocdbt, orbax, zstd       # noqa: E402
from nerf2mesh_tpu_torch.utils.trainer import Trainer          # noqa: E402


class Serial:
    """A stand-in for ThreadPoolExecutor that maps in the calling thread."""

    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def map(self, fn, it):
        return map(fn, it)


def plain_map(path):
    if os.path.getsize(path) == 0:
        return np.empty(0, np.uint8)
    return np.memmap(path, np.uint8, mode="r")


def read_file(path):
    return np.fromfile(path, np.uint8)


def populate_map(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        mm = mmap.mmap(fd, 0, flags=mmap.MAP_SHARED | mmap.MAP_POPULATE,
                       prot=mmap.PROT_READ)
    finally:
        os.close(fd)
    return np.frombuffer(mm, np.uint8)


VARIANTS = {"threads+populate": (ThreadPoolExecutor, populate_map),
            "threads+memmap": (ThreadPoolExecutor, plain_map),
            "threads+read": (ThreadPoolExecutor, read_file),
            "serial+populate": (Serial, populate_map),
            "serial+memmap": (Serial, plain_map),
            "serial+read": (Serial, read_file)}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(dev, fn):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cpu" if args.cpu else "cuda")
    zstd._load()
    cfg = cs.bench_config(ckpt_backend="orbax")
    tmp = tempfile.mkdtemp(prefix="n2m_ocp_walls_")
    chosen = orbax.ThreadPoolExecutor, ocdbt._map
    try:
        t = Trainer(cfg, device=dev, workspace=os.path.join(tmp, "o"))
        g = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for k, p in t.params.named_parameters():
                p.normal_(generator=g)
                t.ema_params[k].normal_(generator=g)
                t.optimizer.state[p] = {
                    "step": torch.tensor(100.0),
                    "exp_avg": torch.randn(p.shape, generator=g, device=dev),
                    "exp_avg_sq": torch.rand(p.shape, generator=g,
                                             device=dev)}
        rows = {"save ocp": [], "save pickle": [], "load pickle": []}
        rows.update({f"load {v}": [] for v in VARIANTS})
        for rep in range(args.reps):
            t.cfg = dataclasses.replace(cfg, ckpt_backend="orbax")
            t.workspace = os.path.join(tmp, "o")
            ocp, s = timed(dev, t.save_checkpoint)
            rows["save ocp"].append(s)
            t.cfg = dataclasses.replace(cfg, ckpt_backend="pickle")
            t.workspace = os.path.join(tmp, "p")
            pk, s = timed(dev, t.save_checkpoint)
            rows["save pickle"].append(s)
            for name, (pool, mapper) in VARIANTS.items():
                orbax.ThreadPoolExecutor, ocdbt._map = pool, mapper
                f = Trainer(cfg, device=dev, workspace=os.path.join(tmp, "o"))
                ok, s = timed(dev, lambda: f.load_checkpoint(ocp))
                assert ok and f.step == t.step
                rows[f"load {name}"].append(s)
                del f
                f = Trainer(dataclasses.replace(cfg, ckpt_backend="pickle"),
                            device=dev, workspace=os.path.join(tmp, "p"))
                ok, s = timed(dev, lambda: f.load_checkpoint(pk))
                rows["load pickle"].append(s)
                del f
            print(f"rep {rep}: " + ", ".join(
                f"{k} {v[-1]:.3f} s" for k, v in rows.items()), flush=True)
        med = {k: statistics.median(v) for k, v in rows.items()}
        name = (torch.cuda.get_device_name(0) if dev.type == "cuda"
                else "cpu")
        print("OCP_WALLS " + json.dumps({"device": name, "reps": args.reps,
                                         "cpus": os.cpu_count(),
                                         "median_s": med}))
    finally:
        orbax.ThreadPoolExecutor, ocdbt._map = chosen
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
