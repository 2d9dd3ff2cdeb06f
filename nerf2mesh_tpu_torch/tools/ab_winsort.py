"""A/B timing of K5 (``winsort_fwd``) of one checkout, on chip_smoke's inputs
and beyond, at the sizes of an eval frame's march rounds, and in profiled
windows of exact winsort training and eval (chip_smoke's phase 6).

    python3 nerf2mesh_tpu_torch/tools/ab_winsort.py [--tree DIR] [--out FILE]

DIR is the root of a checkout (default: the one that holds this file). Its
package and its ``chip_smoke.py`` are imported, so one script times two
commits: run it once per checkout in the order a, b, b, a, one after
another on one card. Needs a CUDA card; imports only torch, numpy, the
checkout and ``ab_table_grads.py`` beside this file (its point sets and
helpers).

Inputs, at the full block512 table (16 levels, 2^19 rows a level, finest
resolution 2048) and winsort levels 7-15:

  uniform, half_shell, shell, clusters   2^18 points each, as in
              ab_table_grads.py (clusters: 16 tight clusters);
  long_run    2^15 points inside one level-15 block and 2^18 - 2^15
              uniform: one window's run of 256 tiles;
  small       4096 uniform points;
  eval_median, eval_largest   the median and the largest of K5's calls in
              one 256x256 eval frame of the trainer below (the points of
              its march rounds, padded to a multiple of 128); the sizes of
              all of them are logged.

Every result is checked against the checkout's ``winsort_fwd_plain`` (atol
1e-5). Times are the mean of 20 back-to-back calls between two CUDA events.

What follows K5: ``splat_encode`` at the winsort routing (levels 7-15
winsort, 0-6 K2) on the uniform 2^18 points, profiled call by call
(torch.profiler, 5 calls each): forward alone, for the device time of the
kernels that run after K5 in it (the residual, K2 and the assembly); and
forward and backward, for K6's device time and that of every kernel but
K5 and K6, with the ten kernel names that take most of it. The same inputs
in both checkouts, so a change in K5's caching that slows the kernels after
it shows there.

The training window: a Trainer at chip_smoke's bench configuration with
``winsort_fine=True, stochastic_fine=False`` trains 64 steps (ms/step over
the last 32), then one eval frame of val view 0 is rendered with K5's calls
recorded, then 8 more steps and one more frame run under torch.profiler
(``ab_table_grads.profile_steps``): wall, device busy time, idle share,
kernel count, and K5's and K6's device time and launches a step and a
frame.

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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ab_table_grads as abt  # noqa: E402

N_POINTS = 2 ** 18
LEVELS = tuple(range(7, 16))
TRAIN_STEPS = 64
PROFILE_STEPS = 8
ATOL = 1e-5


def long_run(spec, rng):
    s = np.float32(spec.level_scale32(15))
    run = (8 * 100 + rng.uniform(0.01, 7.99, (2 ** 15, 3)) - spec.shift) / s
    return np.concatenate([run, rng.uniform(0, 1, (N_POINTS - 2 ** 15, 3))]
                          ).astype(np.float32)


def meta(se, spec, pts, dev):
    x = torch.from_numpy(pts).to(dev)
    xc = x.clamp(0, 1).contiguous()
    oob = ((x < 0) | (x > 1)).any(-1)
    metas = [se.winsort_meta(xc, oob, spec, l) for l in LEVELS]
    return (xc, torch.stack([m[0] for m in metas]).to(torch.int32).contiguous(),
            torch.stack([m[1] for m in metas]).contiguous(),
            torch.stack([m[2] for m in metas]).contiguous())


@torch.no_grad()
def case(se, args):
    """args = winsort_fwd's arguments: checked, then timed."""
    err = float((se.winsort_fwd(*args) - se.winsort_fwd_plain(*args))
                .abs().max())
    if not err <= ATOL:
        raise AssertionError(f"K5 out of tolerance: {err}")
    return dict(points=args[1].shape[0], levels=len(args[-1]),
                ms=abt.cuda_time_ms(lambda: se.winsort_fwd(*args)),
                max_abs_err=err)


def eval_calls(se, trainer, val):
    """K5's arguments in one eval frame of val view 0, in call order."""
    calls = []
    real = se.winsort_fwd

    def recording(*a):
        calls.append(a)
        return real(*a)

    se.winsort_fwd = recording
    try:
        trainer.render_image(val.poses[0], val.intrinsics_for(0), val.H, val.W)
    finally:
        se.winsort_fwd = real
    torch.cuda.synchronize()
    return calls


def device_kernels(fn):
    """(name, device ms) of each kernel fn launches, in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in kern]


def following(se, spec, table, pts, dev, calls=5):
    """Device time of what runs after K5 in splat_encode (see the module's
    docstring), a call, over `calls` profiled calls."""
    x = torch.from_numpy(pts).to(dev)
    tab = table.clone().requires_grad_(True)

    def enc():
        return se.splat_encode(tab, x, spec, gather_levels=LEVELS,
                               winsort_levels=LEVELS)[0]

    def fwd():
        with torch.no_grad():
            enc()

    def fwd_bwd():
        enc().sum().backward()
        tab.grad = None

    fwd()
    fwd_bwd()
    res = dict(k5_ms=[], fwd_after_k5_ms=[], k6_ms=[], fwd_bwd_other_ms=[])
    names = {}
    for _ in range(calls):
        ks = device_kernels(fwd)
        i = [j for j, (n, _) in enumerate(ks) if "winsort_fwd_kernel" in n]
        if len(i) != 1:
            raise AssertionError(f"{len(i)} K5 launches in one forward")
        res["k5_ms"].append(ks[i[0]][1])
        res["fwd_after_k5_ms"].append(sum(t for _, t in ks[i[0] + 1:]))
        ks = device_kernels(fwd_bwd)
        k5 = sum(t for n, t in ks if "winsort_fwd_kernel" in n)
        k6 = sum(t for n, t in ks if "winsort_bwd_kernel" in n)
        res["k6_ms"].append(k6)
        res["fwd_bwd_other_ms"].append(sum(t for _, t in ks) - k5 - k6)
        for n, t in ks:
            if "winsort_" not in n:
                names[n[:80]] = names.get(n[:80], 0.0) + t / calls
    res["fwd_bwd_top"] = dict(sorted(names.items(), key=lambda kv: -kv[1])[:10])
    return res


def winsort_run(cs, se, dev, res):
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    cfg = cs.bench_config(winsort_fine=True, stochastic_fine=False)
    ds, val = cs.scene(cfg)
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    losses, _, _, _, ms_step, rays_s, _ = cs.train_window(
        trainer, ds, TRAIN_STEPS, TRAIN_STEPS // 2)
    calls = eval_calls(se, trainer, val)
    sizes = sorted(a[1].shape[0] for a in calls)
    by_size = sorted(calls, key=lambda a: a[1].shape[0])
    hist = np.histogram(sizes, bins=[0] + [2 ** e for e in range(10, 19)])
    abt.log(f"[ab] eval frame: {len(sizes)} K5 calls, points {sizes}; "
            f"histogram (upper edges {hist[1][1:].tolist()}): "
            f"{hist[0].tolist()}")
    res["k5"]["eval_median"] = r = case(se, by_size[len(by_size) // 2])
    abt.log(f"[ab] K5 eval_median: {r}")
    res["k5"]["eval_largest"] = r = case(se, by_size[-1])
    abt.log(f"[ab] K5 eval_largest: {r}")
    res["training"] = dict(
        ms_step=ms_step, rays_s=rays_s, loss_first=losses[0],
        loss_last=losses[-1], eval_k5_points=sizes,
        steps=abt.profile_steps(
            lambda: trainer.train_steps(ds, PROFILE_STEPS), PROFILE_STEPS),
        frame=abt.profile_steps(lambda: trainer.render_image(
            val.poses[0], val.intrinsics_for(0), val.H, val.W), 1))
    abt.log(f"[ab] winsort training and eval: {res['training']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout to time")
    ap.add_argument("--out", help="append the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        abt.log("ab_winsort: no CUDA device")
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
    abt.log(f"[ab] tree {tree}; {card}; torch {torch.__version__}")
    t0 = time.perf_counter()
    kbuild.load()
    abt.log(f"[ab] kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda", 0)
    spec = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=19,
                        desired_resolution=2048, layout="block512")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    sets = abt.point_sets(rng, N_POINTS)
    sets["long_run"] = long_run(spec, rng)
    sets["small"] = rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    res = dict(tree=tree, card=card, k5={})
    for name, pts in sets.items():
        res["k5"][name] = r = case(se, (table, *meta(se, spec, pts, dev),
                                        spec, LEVELS))
        abt.log(f"[ab] K5 {name}: {r}")
    res["after_k5"] = following(se, spec, table, sets["uniform"], dev)
    abt.log(f"[ab] after K5 (uniform): {res['after_k5']}")
    winsort_run(cs, se, dev, res)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
