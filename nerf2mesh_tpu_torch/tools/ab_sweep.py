"""A/B timing of the ref-layout encode of one checkout: K4 (``sweep_fwd``)
and the ref table gradient (``sweep_bwd(..., need_dx=False)``: kernel K4b,
or plain PyTorch in a checkout that predates it), and a profiled window of
ref training.

    python3 nerf2mesh_tpu_torch/tools/ab_sweep.py [--tree DIR] [--out FILE]

DIR is the root of a checkout (default: the one that holds this file). Its
package and its ``chip_smoke.py`` are imported, so one script times two
commits: run it once per checkout in the order a, b, b, a, one after
another on one card. Needs a CUDA card; imports only torch, numpy, the
checkout and ``ab_table_grads.py`` beside this file (its point sets and
helpers).

Inputs, at the ref slice's table (16 levels at resolutions 16..2048,
levels 0-1 dense, 2-15 hashed at 2^14 rows; chip_smoke ``ref_spec``):

  uniform, half_shell, shell, clusters   2^18 points each, as in
              ab_table_grads.py (clusters: 16 tight clusters, normal noise
              0.002, so the coarse levels' rows take thousands of adds);
  hot_spot    2048 points inside one level-0 lattice cell;
  small       4096 uniform points (a late eval march round).

Every result is checked against the checkout's plain versions: K4 atol
1e-5, K4b atol 1e-5 + rtol 1e-4 of each entry's summed |terms|
("tol_share" is the largest error over that tolerance). "bwd_same_bits"
and "plain_same_bits" say whether two calls of the table gradient (its
kernel, its plain version) on the same inputs gave the same bits: both
add with atomics on the card. Times are the mean
of 20 back-to-back calls between two CUDA events. In a checkout with K4b,
"scratch_reduce" times the second pass of the flush that K4b does not use
(per-chunk partials in a scratch [chunks, total, 3], summed in chunk
order): torch.sum over the chunks of K4b's launch on 2^18 points.

The training window: a Trainer at chip_smoke's bench configuration with
``grid_layout="ref", log2_hashmap_size=14`` (chip_smoke phase 7's table, on
the in-memory scene) trains 64 steps (ms/step over the last 32), then 8
more steps under torch.profiler: wall, device busy time, idle share,
kernel count, and the device time of K4 and K4b a step.

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
TRAIN_STEPS = 64
PROFILE_STEPS = 8
ATOL, RTOL = 1e-5, 1e-4


def hot_spot(spec, rng):
    s0 = spec.level_scale32(0)
    return ((7 + rng.uniform(0.01, 0.99, (2048, 3)) - spec.shift) / s0
            ).astype(np.float32)


def case(pe, spec, table, pts, rng):
    dev = table.device
    x = torch.from_numpy(pts).to(dev)
    N, L = x.shape[0], spec.num_levels
    out = pe.sweep_fwd(table, x, spec)
    err4 = float((out - pe.sweep_fwd_plain(table, x, spec)).abs().max())
    if not err4 <= ATOL:
        raise AssertionError(f"K4 out of tolerance: {err4}")
    g = torch.from_numpy(rng.normal(size=(N, L * 3)).astype(np.float32)).to(dev)

    def k4b(gg, xx):
        return pe.sweep_bwd(table, xx, gg, spec, need_dx=False)[0]

    res = dict(points=N, fwd_ms=abt.cuda_time_ms(
        lambda: pe.sweep_fwd(table, x, spec)), fwd_max_abs_err=err4,
        bwd_ms=abt.cuda_time_ms(lambda: k4b(g, x)),
        bwd_same_bits=torch.equal(k4b(g, x), k4b(g, x)))
    plain = getattr(pe, "sweep_bwd_plain", None)
    if plain is not None:          # a checkout with K4b: check it

        def bwd_plain(gg, xx):
            return plain(table, xx, gg, spec, need_dx=False)[0]
        err, share = abt.check(k4b, bwd_plain, g, (x,))
        res.update(bwd_max_abs_err=err, tol_share=share,
                   plain_same_bits=torch.equal(bwd_plain(g, x),
                                               bwd_plain(g, x)))
    return res


def scratch_reduce_ms(spec, dev, chunks):
    """Time of the second pass that a K4b flushing per-chunk partials into
    a scratch [chunks, total, 3] would add: the sum over chunks, in chunk
    order, into the gradient."""
    scratch = torch.ones((chunks, spec.table_size, 3), device=dev)
    dtable = torch.empty((spec.table_size, 3), device=dev)
    return abt.cuda_time_ms(lambda: torch.sum(scratch, 0, out=dtable))


def profile_steps(fn, steps):
    """(wall, device busy, kernels, K4 and K4b device time), each a step,
    of fn under torch.profiler; None when the profiler sees no device
    time."""
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
        return sum(e.time_range.elapsed_us() for e in kern if s in e.name) / 1e3
    return dict(wall_ms=wall / steps, busy_ms=busy / steps,
                idle_share=1 - busy / wall, kernels=len(kern) / steps,
                sweep_fwd_ms=named("sweep_fwd_kernel") / steps,
                sweep_bwd_ms=named("sweep_bwd_kernel") / steps)


def ref_training(cs, dev):
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    cfg = cs.bench_config(grid_layout="ref", log2_hashmap_size=14)
    ds, _ = cs.scene(cfg)
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    losses, _, _, _, ms_step, rays_s, launches = cs.train_window(
        trainer, ds, TRAIN_STEPS, TRAIN_STEPS // 2)
    prof = profile_steps(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                         PROFILE_STEPS)
    return dict(ms_step=ms_step, rays_s=rays_s, loss_first=losses[0],
                loss_last=losses[-1], launches=launches, profiled=prof)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout to time")
    ap.add_argument("--out", help="append the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_sweep: no CUDA device", flush=True)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import nerf2mesh_tpu_torch
    from nerf2mesh_tpu_torch.kernels import build as kbuild
    from nerf2mesh_tpu_torch.ops import pallas_encode as pe
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
    spec = cs.ref_spec()
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    sets = abt.point_sets(rng, N_POINTS)
    sets["hot_spot"] = hot_spot(spec, rng)
    sets["small"] = rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    res = dict(tree=tree, card=card, sweep={})
    for name, pts in sets.items():
        res["sweep"][name] = r = case(pe, spec, table, pts, rng)
        abt.log(f"[ab] {name}: {r}")
    if hasattr(pe, "sweep_bwd_plain"):     # a checkout with K4b
        chunks = pe.sweep_chunks(N_POINTS, spec.num_levels, pe._num_sms(dev),
                                 forward=False)
        res["scratch_reduce"] = r = dict(
            chunks=chunks, ms=scratch_reduce_ms(spec, dev, chunks))
        abt.log(f"[ab] scratch reduction: {r}")
    res["ref_training"] = r = ref_training(cs, dev)
    abt.log(f"[ab] ref training: {r}")
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
