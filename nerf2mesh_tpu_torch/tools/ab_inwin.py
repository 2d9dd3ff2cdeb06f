"""A/B timing of K2 (``inwin_fwd``) and K1 (``occ_lookup``) of one
checkout, with K3 (``inwin_bwd``) beside them, on fixed inputs and in
profiled windows of stage-0 training and eval (chip_smoke's phases 4-5);
in a checkout that has them, also K7 (``ops/inwin_variants``).

    python3 nerf2mesh_tpu_torch/tools/ab_inwin.py [--tree DIR] [--out FILE]
        [--only k7]

DIR is the root of a checkout (default: the one that holds this file). Its
package and its ``chip_smoke.py`` are imported, so one script times two
commits: run it once per checkout in the order a, b, b, a, one after
another on one card. Needs a CUDA card; imports only torch, numpy, the
checkout and ``ab_table_grads.py`` beside this file.

K2 inputs, at the full block512 table (16 levels, 2^19 rows a level,
finest resolution 2048), morton-sorted, each at kernel levels 0-6 (where
the trainer starts) and 0-8:

  uniform, half_shell, shell, clusters   2^18 points (ab_table_grads.py);
  small       4096 uniform points;
  eval_median, eval_largest   the median and the largest of K2's calls in
              one 256x256 eval frame of the trainer below, also at the
              call's own levels.

K3 on uniform and half_shell at levels 0-8. K1 on a random 128^3 grid
(30% occupied): 32768 x 128 uniformly random cells; the sampler's, for
32768 rays of random train views and pixels, taken from the checkout's
coarse pass (``sampling._coarse_pass``) with the trained grid; and the
largest K1 call of the eval frame (one march round).  pack_bits, which
repacks the grid before every K1 launch, is timed beside it.  Every result
is checked against the checkout's plain version (K2, K7: atol 1e-5; K1:
exact; K3: ab_table_grads.check).  Times are the mean of 20 back-to-back
calls between two CUDA events, of the wrapper and, for K1 and K2, of the
C entry point alone ("bare": a wrapper's Python can take longer than its
kernel, and then the wrapper's time is the host's).

The training window: a Trainer at chip_smoke's bench configuration trains
128 steps (ms/step over the last 64), records one eval frame of val view 0,
then 8 more steps and one more frame run under torch.profiler: wall,
device busy time, idle share, kernel count, and the device time and
launches of K1, K2 and K3 a step and a frame.

K7: inwin_dense_deep, _const_rows and _four_tiles at levels 6 and 8 (8
stages one window twice in the same-window tile) on the half_shell points,
each checked (atol 1e-5), then timed through the wrapper and through the C
entry point alone, with K2 at the one level beside them (bare).  ``--only
k7`` times K7 alone (~15 s a run): the A/B of two K7 bodies.

Prints one line a measurement and, last, one JSON object; ``--out`` also
appends that object to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
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
LEVEL_SETS = (tuple(range(7)), tuple(range(9)))
TRAIN_STEPS = 128
PROFILE_STEPS = 8
K7_LEVELS = (6, 8)
ATOL = 1e-5


def k2_meta(se, spec, x, levels):
    metas = [se.tile_meta(x.reshape(-1, se.TILE, 3), spec, l) for l in levels]
    return (torch.stack([m[0] for m in metas]).contiguous(),
            torch.stack([m[1] for m in metas]).contiguous())


def bare_k2(table, x, bases, rows, spec, levels):
    """K2 through the checkout's C entry point alone (no wrapper): a
    function that launches it into a fixed output, and that output."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.ops.hashgrid import level_arrays
    lib = kernels.load()
    scales, offsets = level_arrays(spec, tuple(levels))
    N, Lk = x.shape[0], len(levels)
    out = torch.empty((N, Lk, 3), device=x.device)
    stream = kernels.current_stream_handle(x.device)
    # a checkout whose K2 takes the channel count has one more argument
    chan = (3,) if len(lib.n2m_inwin_fwd.argtypes) == 13 else ()

    def run():
        code = lib.n2m_inwin_fwd(table.data_ptr(), x.data_ptr(),
                                 bases.data_ptr(), rows.data_ptr(), scales,
                                 offsets, float(spec.shift), N, N // 128, Lk,
                                 *chan, out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"K2: CUDA error {code}")
    return run, out


@torch.no_grad()
def k2_case(se, table, x, spec, level_sets=LEVEL_SETS):
    """K2 on morton-sorted x at each of level_sets: checked, then timed
    through the wrapper and through the C entry point alone (bare)."""
    r = dict(points=x.shape[0])
    for levels in level_sets:
        args = (table, x, *k2_meta(se, spec, x, levels), spec, levels)
        plain = se.inwin_fwd_plain(*args)
        run, out = bare_k2(*args)
        run()
        err = max(float((se.inwin_fwd(*args) - plain).abs().max()),
                  float((out - plain).abs().max()))
        if not err <= ATOL:
            raise AssertionError(f"K2 out of tolerance: {err}")
        r[f"L{len(levels)}"] = dict(
            ms=abt.cuda_time_ms(lambda: se.inwin_fwd(*args)),
            bare_ms=abt.cuda_time_ms(run), max_abs_err=err)
    return r


def sort(se, x):
    return x[se.morton_perm(x)[0]].contiguous()


def k3_case(se, spec, x, rng):
    levels = LEVEL_SETS[-1]
    bases, rows = k2_meta(se, spec, x, levels)
    g = torch.from_numpy(rng.normal(size=(x.shape[0], len(levels), 3))
                         .astype(np.float32)).to(x.device)
    args = (x, bases, rows, spec, levels, spec.table_size)
    err, share = abt.check(se.inwin_bwd, se.inwin_bwd_plain, g, args)
    return dict(points=x.shape[0], max_abs_err=err, tol_share=share,
                ms=abt.cuda_time_ms(lambda: se.inwin_bwd(g, *args)))


@torch.no_grad()
def k1_case(occ_sweep, words, grid, idx):
    """K1 on idx: checked, then timed through the wrapper and through the
    C entry point alone (bare, into an aligned output)."""
    from nerf2mesh_tpu_torch import kernels
    lib = kernels.load()
    idx = idx.contiguous()
    out = torch.empty_like(idx)
    stream = kernels.current_stream_handle(idx.device)

    def bare():
        code = lib.n2m_occ_lookup(words.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), idx.numel(), stream)
        if code:
            raise RuntimeError(f"K1: CUDA error {code}")

    got = occ_sweep.occ_lookup(words, idx)
    bare()
    want = grid.reshape(-1)[idx.long()].to(torch.int32)
    bad = int((got != occ_sweep.occ_lookup_plain(words, idx)).sum()) + int(
        (got != want).sum()) + int((out != want).sum())
    if bad:
        raise AssertionError(f"K1: {bad} mismatching bits")
    return dict(shape=list(idx.shape), distinct=int(torch.unique(idx).numel()),
                ms=abt.cuda_time_ms(lambda: occ_sweep.occ_lookup(words, idx)),
                bare_ms=abt.cuda_time_ms(bare))


def recorded(module, name, fn):
    """Run fn with module.name recording its arguments; returns them."""
    calls = []
    real = getattr(module, name)

    def rec(*a, **k):
        calls.append(a)
        return real(*a, **k)

    setattr(module, name, rec)
    try:
        fn()
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return calls


def train_cells(sampling, trainer, ds, rng, dev, n=32768):
    """K1's indices for n rays of random train views and pixels: the
    checkout's coarse pass, with its occ_lookup call recorded (a checkout
    from before sampling.occupancy_index has the same pass)."""
    from nerf2mesh_tpu_torch.data.rays import get_rays
    rs = trainer.render_spec
    views = rng.integers(0, ds.num_frames, n)
    pix = torch.from_numpy(rng.integers(0, ds.H * ds.W, n)).to(dev)
    rays = get_rays(torch.from_numpy(ds.poses[views]).to(dev),
                    tuple(float(v) for v in ds.intrinsics_for(0)), ds.H, ds.W,
                    pix)
    aabb = torch.tensor([-rs.bound] * 3 + [rs.bound] * 3, device=dev)
    nears, fars = sampling.near_far_from_aabb(rays["rays_o"], rays["rays_d"],
                                              aabb, rs.min_near)
    calls = recorded(sampling, "occ_lookup", lambda: sampling._coarse_pass(
        rays["rays_o"], rays["rays_d"], trainer.render.occ_grid, nears, fars,
        rs.num_coarse,
        rs.grid_size, rs.cascades, rs.bound, rs.contract, rs.dt_gamma,
        rs.max_steps))
    return calls[0][1]


def profile(fn, per):
    """Wall, device busy, idle share, kernels and the device time and
    launches of K1, K2 and K3, each over `per` steps or frames."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    if not kern or busy <= 0:
        return None
    res = dict(wall_ms=wall / per, busy_ms=busy / per,
               idle_share=1 - busy / wall, kernels=len(kern) / per)
    for key, sub in (("k1", "occ_lookup_kernel"), ("k2", "inwin_fwd_kernel"),
                     ("k3", "inwin_bwd_kernel")):
        t = [e.time_range.elapsed_us() / 1e3 for e in kern if sub in e.name]
        res[f"{key}_ms"], res[f"{key}_launches"] = sum(t) / per, len(t) / per
    return res


def training_run(cs, se, sampling, occ_sweep, spec, table, dev, rng, res):
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    cfg = cs.bench_config()
    ds, val = cs.scene(cfg)
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    losses, _, _, _, ms_step, rays_s, _ = cs.train_window(
        trainer, ds, TRAIN_STEPS, TRAIN_STEPS // 2)

    def frame():
        trainer.render_image(val.poses[0], val.intrinsics_for(0), val.H, val.W)

    k2_calls = []
    k1_calls = recorded(sampling, "occ_lookup", lambda: k2_calls.extend(
        recorded(se, "inwin_fwd", frame)))
    sizes = sorted(a[1].shape[0] for a in k2_calls)
    abt.log(f"[ab] eval frame: {len(k2_calls)} K2 calls, points {sizes}, "
            f"levels {sorted(set(len(a[-1]) for a in k2_calls))}; "
            f"{len(k1_calls)} K1 calls, "
            f"shapes {sorted(set(tuple(a[1].shape) for a in k1_calls))}")
    by_size = sorted(k2_calls, key=lambda a: a[1].shape[0])
    for key, call in (("eval_median", by_size[len(by_size) // 2]),
                      ("eval_largest", by_size[-1])):
        res["k2"][key] = r = k2_case(se, table, call[1], spec,
                                     LEVEL_SETS + (tuple(call[-1]),))
        abt.log(f"[ab] K2 {key}: {r}")

    grid = trainer.render.occ_grid
    words = occ_sweep.pack_bits(grid)
    res["k1"]["sampler_train"] = r = k1_case(
        occ_sweep, words, grid, train_cells(sampling, trainer, ds, rng, dev))
    abt.log(f"[ab] K1 sampler_train: {r}")
    eval_round = max(k1_calls, key=lambda a: a[1].numel())[1]
    res["k1"]["eval_round"] = r = k1_case(occ_sweep, words, grid, eval_round)
    abt.log(f"[ab] K1 eval_round: {r}")
    res["k1"]["pack_bits_trained_ms"] = abt.cuda_time_ms(
        lambda: occ_sweep.pack_bits(grid))
    res["training"] = dict(
        ms_step=ms_step, rays_s=rays_s, loss_first=losses[0],
        loss_last=losses[-1],
        steps=profile(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                      PROFILE_STEPS),
        frame=profile(frame, 1))
    abt.log(f"[ab] training and eval: {res['training']}")


def bare_k7(name, table, x, bases, rows, spec, level):
    """K7 variant `name` through the checkout's C entry point alone."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.ops import inwin_variants as iv
    lib = kernels.load()
    out = torch.empty((x.shape[0], 1, 3), device=x.device)
    stream = kernels.current_stream_handle(x.device)
    args = (iv.VARIANTS[name], table.data_ptr(), x.data_ptr(),
            bases.data_ptr(), rows.data_ptr(), spec.level_scale32(level),
            int(spec.offsets[level]), float(spec.shift), x.shape[0],
            x.shape[0] // 128, out.data_ptr(), stream)

    def run():
        code = lib.n2m_inwin_dense(*args)
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")
    return run, out


@torch.no_grad()
def k7(spec, table, x):
    """K7's variants at K7_LEVELS: checked, timed (wrapper and bare)."""
    from nerf2mesh_tpu_torch.ops import inwin_variants as iv
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    res = {}
    for level in K7_LEVELS:
        bases, rows = se.tile_meta(x.reshape(-1, se.TILE, 3), spec, level)
        crows = iv.const_rows(bases.shape[0], x.device)
        for name, args, plain in (
                ("inwin_dense_deep", (table, x, bases, rows, spec, level),
                 iv.inwin_dense_plain),
                ("inwin_dense_const_rows", (table, x, bases, spec, level),
                 iv.inwin_dense_const_rows_plain),
                ("inwin_dense_four_tiles", (table, x, bases, rows, spec,
                                            level), iv.inwin_dense_plain)):
            fn = getattr(iv, name)
            want = plain(*args)
            run, out = bare_k7(name, table, x, bases, (
                crows if name == "inwin_dense_const_rows" else rows), spec,
                level)
            run()
            err = max(float((fn(*args) - want).abs().max()),
                      float((out - want).abs().max()))
            if not err <= ATOL:
                raise AssertionError(f"{name} out of tolerance: {err}")
            res[f"{name}_L{level}"] = dict(
                max_abs_err=err, ms=abt.cuda_time_ms(lambda: fn(*args)),
                bare_ms=abt.cuda_time_ms(run))
        run, _ = bare_k2(table, x, bases[None].contiguous(),
                         rows[None].contiguous(), spec, (level,))
        res[f"inwin_fwd_one_level_bare_L{level}"] = dict(
            ms=abt.cuda_time_ms(run))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout to time")
    ap.add_argument("--out", help="append the JSON result to this file")
    ap.add_argument("--only", choices=("k7",),
                    help="time K7 alone (the two checkouts must have it)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        abt.log("ab_inwin: no CUDA device")
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import nerf2mesh_tpu_torch
    from nerf2mesh_tpu_torch.kernels import build as kbuild
    from nerf2mesh_tpu_torch.ops import occ_sweep, sampling
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
    sets = {k: sort(se, torch.from_numpy(v).to(dev))
            for k, v in abt.point_sets(rng, N_POINTS).items()}
    sets["small"] = sort(se, torch.from_numpy(
        rng.uniform(0, 1, (4096, 3)).astype(np.float32)).to(dev))
    res = dict(tree=tree, card=card)
    if args.only is None:
        k2_k3_k1(cs, se, sampling, occ_sweep, spec, table, sets, dev, rng,
                 res)
    if os.path.exists(os.path.join(pkg, "ops", "inwin_variants.py")):
        res["k7"] = r = k7(spec, table, sets["half_shell"])
        abt.log(f"[ab] K7 at levels {K7_LEVELS} (half_shell): {r}")
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


def k2_k3_k1(cs, se, sampling, occ_sweep, spec, table, sets, dev, rng, res):
    """K2 on every point set, K3, K1, and the training window, into res."""
    res.update(k2={}, k3={}, k1={})
    for name, x in sets.items():
        res["k2"][name] = r = k2_case(se, table, x, spec)
        abt.log(f"[ab] K2 {name}: {r}")
    for name in ("uniform", "half_shell"):
        res["k3"][name] = r = k3_case(se, spec, sets[name], rng)
        abt.log(f"[ab] K3 {name}: {r}")
    H = 128
    grid = torch.from_numpy((rng.random((1, H, H, H)) < 0.3)
                            .astype(np.uint8)).to(dev)
    words = occ_sweep.pack_bits(grid)
    res["k1"]["random"] = r = k1_case(occ_sweep, words, grid, torch.from_numpy(
        rng.integers(0, H ** 3, (32768, 128), dtype=np.int32)).to(dev))
    res["k1"]["pack_bits_ms"] = abt.cuda_time_ms(
        lambda: occ_sweep.pack_bits(grid))
    abt.log(f"[ab] K1 random: {r}; pack_bits {res['k1']['pack_bits_ms']:.4f} ms")
    training_run(cs, se, sampling, occ_sweep, spec, table, dev, rng, res)


if __name__ == "__main__":
    sys.exit(main())
