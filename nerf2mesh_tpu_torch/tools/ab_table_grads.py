"""A/B timing of the table-gradient kernels K3 (``inwin_bwd``) and K6
(``winsort_bwd``) of one checkout, on inputs beyond chip_smoke's, and a
profiled window of exact winsort training (chip_smoke's phase 6).

    python3 nerf2mesh_tpu_torch/tools/ab_table_grads.py [--tree DIR] [--out FILE]

DIR is the root of a checkout (default: the one that holds this file). Its
package and its ``chip_smoke.py`` are imported, so one script times two
commits: run it once per checkout in the order a, b, b, a, one after
another on one card. Needs a CUDA card; imports only torch, numpy and the checkout.

Inputs, at the full block512 table (16 levels, 2^19 rows a level, finest
resolution 2048) and 2^18 points each:

  uniform     uniform in the unit cube (chip_smoke's K5/K6 input);
  half_shell  half on a sphere shell (radius 0.3, normal noise 0.01), half
              uniform (chip_smoke's K2/K3 input);
  shell       all on that shell, as the samples of a trained surface are;
  clusters    16 tight clusters (normal noise 0.002): a few blocks of each
              coarse winsort level hold most points, so K6's blocks for
              those windows each walk a run of thousands of points while
              most others have nothing to do;

and chip_smoke's small inputs: K3's hot spot (2048 points inside one
level-0 lattice cell) and K6's long run (2048 points inside one level-15
block and 2048 uniform). K3 runs on the morton-sorted points at levels 0-8,
K6 on the window-sorted points at levels 7-15. Every result is checked
against its plain version (atol 1e-5 + rtol 1e-4 of each entry's summed
|terms|); "tol_share" is the largest error over that tolerance. Times are
the mean of 20 back-to-back calls between two CUDA events. For K6 the
longest run of a window and the share of windows that hold a point are
logged per input.

The training window: a Trainer at chip_smoke's bench configuration with
``winsort_fine=True, stochastic_fine=False`` trains 64 steps (ms/step over
the last 32), then 8 more steps under torch.profiler: wall, device busy
time, idle share, kernel count, and the device time of K5 and K6 a step.

Prints one line a measurement and, last, one JSON object; ``--out`` also
appends that object to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_POINTS = 2 ** 18
K3_LEVELS = tuple(range(9))
K6_LEVELS = tuple(range(7, 16))
TRAIN_STEPS = 64
PROFILE_STEPS = 8
ATOL, RTOL = 1e-5, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn over `reps` back-to-back runs between two CUDA
    events, after a warm-up run."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check(kernel, plain, g, args):
    """(max |kernel - plain|, largest error over its tolerance) for g and
    |g|; raises when an entry is out of tolerance."""
    mag = plain(g.abs(), *args)
    tol = ATOL + RTOL * mag
    err = (kernel(g, *args) - plain(g, *args)).abs()
    err_abs = (kernel(g.abs(), *args) - mag).abs()
    share = max(float((err / tol).max()), float((err_abs / tol).max()))
    if share > 1.0:
        raise AssertionError(f"{kernel.__name__} out of tolerance: {share}")
    return float(err.max()), share


def point_sets(rng, n):
    d = rng.normal(size=(n, 3))
    shell = 0.5 + 0.3 * d / np.linalg.norm(d, axis=1, keepdims=True) \
        + rng.normal(0, 0.01, (n, 3))
    centres = rng.uniform(0.2, 0.8, (16, 3))
    sets = {
        "uniform": rng.uniform(0, 1, (n, 3)),
        "half_shell": np.concatenate([shell[:n // 2],
                                      rng.uniform(0, 1, (n - n // 2, 3))]),
        "shell": shell,
        "clusters": centres[rng.integers(0, 16, n)]
        + rng.normal(0, 0.002, (n, 3)),
    }
    return {k: np.clip(v, 0, 1).astype(np.float32) for k, v in sets.items()}


def k3_case(se, spec, dev, pts, rng):
    x = torch.from_numpy(pts).to(dev)
    x = x[se.morton_perm(x)[0]].contiguous()
    metas = [se.tile_meta(x.reshape(-1, se.TILE, 3), spec, l) for l in K3_LEVELS]
    bases = torch.stack([m[0] for m in metas]).contiguous()
    rows = torch.stack([m[1] for m in metas]).contiguous()
    g = torch.from_numpy(rng.normal(size=(x.shape[0], len(K3_LEVELS), 3))
                         .astype(np.float32)).to(dev)
    args = (x, bases, rows, spec, K3_LEVELS, spec.table_size)
    err, share = check(se.inwin_bwd, se.inwin_bwd_plain, g, args)
    return dict(points=x.shape[0], ms=cuda_time_ms(lambda: se.inwin_bwd(g, *args)),
                max_abs_err=err, tol_share=share)


def k6_case(se, spec, dev, pts, rng):
    xc = torch.from_numpy(pts).to(dev)
    oob = torch.zeros(xc.shape[0], dtype=torch.bool, device=dev)
    metas = [se.winsort_meta(xc, oob, spec, l) for l in K6_LEVELS]
    perm = torch.stack([m[0] for m in metas]).to(torch.int32).contiguous()
    wins = torch.stack([m[1] for m in metas]).contiguous()
    slots = torch.stack([m[2] for m in metas]).contiguous()
    g = torch.from_numpy(rng.normal(size=(xc.shape[0], len(K6_LEVELS), 3))
                         .astype(np.float32)).to(dev)
    args = (xc, perm, wins, slots, spec, K6_LEVELS, spec.table_size)
    err, share = check(se.winsort_bwd, se.winsort_bwd_plain, g, args)
    longest, occupied = 0, []
    for k, l in enumerate(K6_LEVELS):
        _, counts = torch.unique_consecutive(wins[k], return_counts=True)
        longest = max(longest, int(counts.max()))
        occupied.append(len(counts) / (int(spec.level_sizes[l]) // 512))
    return dict(points=xc.shape[0],
                ms=cuda_time_ms(lambda: se.winsort_bwd(g, *args)),
                max_abs_err=err, tol_share=share, longest_run=longest,
                occupied_windows=float(np.mean(occupied)))


def hot_spot(spec, rng):
    s0 = spec.level_scale32(0)
    return ((7 + rng.uniform(0.01, 0.99, (2048, 3)) - spec.shift) / s0
            ).astype(np.float32)


def long_run(spec, rng):
    s = np.float32(spec.level_scale32(15))
    return np.concatenate([(8 * 100 + rng.uniform(0.01, 7.99, (2048, 3))
                            - spec.shift) / s,
                           rng.uniform(0, 1, (2048, 3))]).astype(np.float32)


def profile_steps(fn, steps):
    """(wall, device busy, kernels, K5 and K6 device time and launches),
    each over `steps` (steps or frames), of fn under torch.profiler; None
    when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    if not kern or busy <= 0:
        return None

    def named(s):
        return [e.time_range.elapsed_us() / 1e3 for e in kern if s in e.name]
    fwd, bwd = named("winsort_fwd_kernel"), named("winsort_bwd_kernel")
    return dict(wall_ms=wall / steps, busy_ms=busy / steps,
                idle_share=1 - busy / wall, kernels=len(kern) / steps,
                winsort_fwd_ms=sum(fwd) / steps, winsort_bwd_ms=sum(bwd) / steps,
                winsort_fwd_launches=len(fwd) / steps,
                winsort_bwd_launches=len(bwd) / steps)


def winsort_training(cs, dev):
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    cfg = cs.bench_config(winsort_fine=True, stochastic_fine=False)
    ds, _ = cs.scene(cfg)
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    losses, _, _, _, ms_step, rays_s, _ = cs.train_window(
        trainer, ds, TRAIN_STEPS, TRAIN_STEPS // 2)
    prof = profile_steps(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                         PROFILE_STEPS)
    return dict(ms_step=ms_step, rays_s=rays_s, loss_first=losses[0],
                loss_last=losses[-1], profiled=prof)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout to time")
    ap.add_argument("--out", help="append the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("ab_table_grads: no CUDA device")
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import nerf2mesh_tpu_torch
    from nerf2mesh_tpu_torch.kernels import build as kbuild
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec
    pkg = os.path.dirname(nerf2mesh_tpu_torch.__file__)
    if not pkg.startswith(tree):
        raise RuntimeError(f"imported {pkg}, not the package under {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log(f"[ab] tree {tree}; {card}; torch {torch.__version__}")
    t0 = time.perf_counter()
    kbuild.load()
    log(f"[ab] kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda", 0)
    spec = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=19,
                        desired_resolution=2048, layout="block512")
    rng = np.random.default_rng(0)
    sets = point_sets(rng, N_POINTS)
    res = dict(tree=tree, card=card, k3={}, k6={})
    for name, pts in [*sets.items(), ("hot_spot", hot_spot(spec, rng))]:
        res["k3"][name] = r = k3_case(se, spec, dev, pts, rng)
        log(f"[ab] K3 {name}: {r}")
    for name, pts in [*sets.items(), ("long_run", long_run(spec, rng))]:
        res["k6"][name] = r = k6_case(se, spec, dev, pts, rng)
        log(f"[ab] K6 {name}: {r}")
    res["winsort_training"] = r = winsort_training(cs, dev)
    log(f"[ab] winsort training: {r}")
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
