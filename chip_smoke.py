"""Smoke run of the PyTorch port on one CUDA GPU (an H100 / sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 2;
  2. build: compile the port's kernels (nerf2mesh_tpu_torch/csrc) with nvcc;
  3. kernels: K1 occ_lookup, K2 inwin_fwd and K3 inwin_bwd against their
     plain PyTorch versions at the shapes the training step gives them,
     plus K2 + the residual against the plain hashgrid_encode; K3's global
     vector adds counted, and K3 on a hot spot (16 tiles inside one level-0
     lattice cell); K6 on a long run (2048 points in one level-15 block); K5
     winsort_fwd and K6 winsort_bwd against theirs on 2^18 uniform points
     (with out-of-bounds and block-edge points) at winsort levels 7-15,
     plus K5 + its residual against hashgrid_encode; K4 sweep_fwd and K4b
     sweep_bwd (the ref table gradient) against their plain versions on
     2^18 points at the ref slice's table (uniform, out-of-bounds, on-edge
     and 1-ulp-from-edge points), K4b also on 2^18 points in 16 tight
     clusters, both at 40 and 70 levels and on a tiled grid; times from CUDA
     events (the mean of 20
     back-to-back runs), each beside its bound (bytes over 3.35 TB/s or
     fp32 flops over 67 TFLOP/s, whichever is larger);
  4. slice: stage-0 training at bench.py's configuration on the in-memory
     256x256 x 24-view sphere scene; every loss finite, the loss falls, and
     K1-K3's launch counters are above 0 for the training run alone; after
     phase 5, 8 more steps and one eval frame under torch.profiler (device
     busy time, idle share, kernels, top ops);
  5. eval: Trainer.evaluate on 4 val views at 256x256 before and after the
     phase-4 training; the PSNR after is finite and above the PSNR before,
     and K1 and K2 launch during each eval alone; ms per frame and march
     rounds;
  6. winsort: a fresh trainer at the same configuration with
     winsort_fine=True, stochastic_fine=False trains 64 steps (losses finite
     and falling, K5 and K6 launched by the training alone), then evaluates
     the val views (K5 launched by the eval alone); ms/step, rays/s,
     ms/frame and PSNR; 8 more steps profiled;
  7. cli: the ref small-table slice through nerf2mesh_tpu_torch.main on a
     256x256 blender scene written to a temporary directory (24 train, 4
     val, 2 test views): 128 steps at bench.py's flags with --grid_layout
     ref --log2_hashmap_size 14, an eval and a checkpoint at step 128, the
     final val and test evals (PSNR, SSIM, LPIPS proxy) and the test video;
     every logged loss finite and falling, K1, K4 and K4b launched by the
     training, the block512 kernels never; then main --test reloads the
     checkpoint, and a fresh Trainer loaded from it reproduces the step-128
     val PSNR within 1e-4 dB.  ms/step, rays/s, eval ms/frame, peak memory;
     8 more steps and one eval frame of the loaded trainer profiled.
The line before the last is the kernels' JSON record (launch counts from
each kernel's own path: phase 4 for K1-K3, phase 6's training for K5/K6,
phase 7's CLI run for K4 and K4b), the last line the device record.  Imports only
the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
SLICE_STEPS = 128          # grid refresh at 0, slab updates at 16, 32, ...
TIMED_STEPS = 64           # steady-state window: the last TIMED_STEPS steps
WINSORT_STEPS = 64         # phase 6 (exact encode: K5/K6 in every step)
N_VAL = 4                  # eval views (phases 5 and 6)
WINSORT_LEVELS = tuple(range(7, 16))   # the gather levels at the full spec
KERNEL_POINTS = 2 ** 18    # phase 3: the point pool of a training step
CLI_STEPS = 128            # phase 7
PROFILE_STEPS = 8          # profiled steps after phases 4, 6 and 7
TOL = {"occ_lookup": (0.0, 0.0), "inwin_fwd": (1e-5, 0.0),
       "inwin_bwd": (1e-5, 1e-4), "winsort_fwd": (1e-5, 0.0),
       "winsort_bwd": (1e-5, 1e-4), "sweep_fwd": (1e-5, 0.0),
       "sweep_bwd": (1e-5, 1e-4), "encode": (1e-5, 1e-5)}
# the H100 SXM's published peaks (device memory; fp32 outside the tensor
# cores) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def trilinear_flops(n_point_levels: int, channels: int = 3) -> int:
    """fp32 operations of a trilinear encode (or its gradient) over n
    (point, level) pairs, all 8 corners: the lattice position, fraction and
    1 - fraction (12), each corner's weight (2) and its channels' multiply
    and add (2C).  Integer index arithmetic is not counted."""
    return n_point_levels * (12 + 8 * (2 + 2 * channels))


def bound(nbytes: int, flops: int):
    """(least ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_rows(spec, levels) -> int:
    return sum(int(spec.offsets[l + 1] - spec.offsets[l]) for l in levels)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn over `reps` back-to-back runs between two CUDA
    events, after a warm-up run: the host enqueues ahead of the card, so a
    wrapper's own Python time shows only where it exceeds its kernel's."""
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


def profile_region(fn, label: str, per: int = 1, top: int = 6):
    """Run fn once under torch.profiler and log the wall time, the device
    busy time (the sum of the kernels' durations on the one stream), the
    device's idle share, the kernel count and the ops with the most device
    time (host ops, by the device time of their own kernels), each divided
    by `per` (steps or frames); says so when the profiler records no
    device time or is refused."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        log(f"[profile] {label}: profiler refused ({e})")
        return
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    if not kern or busy <= 0:
        log(f"[profile] {label}: the profiler saw no device time")
        return
    ops = sorted(((getattr(a, "self_device_time_total", 0.0), a.key[:48])
                  for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU), reverse=True)[:top]
    log(f"[profile] {label}: wall {wall / per:.2f} ms, device busy "
        f"{busy / per:.2f} ms, idle share {1 - busy / wall:.3f}, "
        f"{len(kern) / per:.0f} kernels, per {'step' if per > 1 else 'run'}"
        f" (profiled); top device time: " + "; ".join(
            f"{k} {t / 1e3 / per:.3f} ms ({t / 1e3 / busy:.1%})"
            for t, k in ops))


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}")
    return card, name


def phase_build():
    from nerf2mesh_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    path = kbuild.build(verbose=True)
    kbuild.load()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kbuild.build_seconds if kbuild.build_seconds else 'cached'})")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def boundary_points(spec, levels, rng, n_per_level=64):
    """Points whose lattice position x*scale+shift is an integer on a block
    edge (a multiple of 8, or 7 below one) or within 1 ulp of it, per level:
    where a floor computed two ways could disagree."""
    pts = []
    for l in levels:
        s = np.float32(spec.level_scale32(l))
        nb = int(spec.block_counts[l])
        for _ in range(n_per_level):
            p = rng.uniform(0.05, 0.95, 3).astype(np.float32)
            axis = rng.integers(3)
            g = 8 * rng.integers(1, max(nb - 1, 2)) - rng.integers(2)
            x = np.float32((g - np.float32(spec.shift)) / s)
            x = np.nextafter(x, np.float32(rng.choice([-1, 2])) * x) \
                if rng.random() < 0.6 else x
            p[axis] = np.clip(x, 0.0, 1.0)
            pts.append(p)
    return np.stack(pts)


def same_window_tile(spec, levels, rng):
    """(level, tile points [128, 3]) whose 2x2x2 block neighbourhood holds two
    slots with the same window id, on the first level of `levels` that has
    such a neighbourhood (at the full spec: level 8; levels 5-7 have none).
    The points spread over all 8 slots; one sits at the base corner."""
    from nerf2mesh_tpu_torch.ops.hashgrid import block_window
    slots = torch.tensor([[s & 1, (s >> 1) & 1, (s >> 2) & 1] for s in range(8)])
    for l in levels:
        nb = int(spec.block_counts[l])
        ax = torch.arange(nb - 1)
        b = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
        win = torch.sort(block_window(b[:, None, :] + slots[None], spec, l), 1)[0]
        hit = (win[:, 1:] == win[:, :-1]).any(1).nonzero()[:, 0]
        if len(hit):
            base = b[hit[0]].numpy()
            cells = 8 * base[None] + rng.uniform(0.0, 15.0, (128, 3))
            cells[0] = 8 * base + 0.25
            pts = ((cells - spec.shift) / spec.level_scale32(l)).astype(np.float32)
            return int(l), np.clip(pts, 0.0, 1.0)
    raise RuntimeError(f"no same-window slot pair on levels {levels}")


def phase_kernels(dev):
    from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode
    from nerf2mesh_tpu_torch.ops import occ_sweep, splat_encode as se

    rng = np.random.default_rng(SEED)
    results = []

    # K1: a random 128^3 grid, 32768 rays x 128 coarse candidates
    H = 128
    occ = torch.from_numpy((rng.random((1, H, H, H)) < 0.3).astype(np.uint8)).to(dev)
    words = occ_sweep.pack_bits(occ)
    idx = torch.from_numpy(rng.integers(0, H ** 3, (32768, 128),
                                        dtype=np.int32)).to(dev)
    got = occ_sweep.occ_lookup(words, idx)
    want = occ_sweep.occ_lookup_plain(words, idx)
    direct = occ.reshape(-1)[idx.long()].to(torch.int32)
    err = int((got != want).sum()) + int((got != direct).sum())
    if err:
        raise AssertionError(f"K1 occ_lookup: {err} mismatching bits")
    results.append(dict(
        name="occ_lookup", route="cuda",
        source="nerf2mesh_tpu_torch/csrc/occ_lookup.cu",
        replaces="nerf2mesh_tpu/ops/occ_sweep.py:51",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: occ_sweep.occ_lookup(words, idx)),
        plain_ms=cuda_time_ms(lambda: occ_sweep.occ_lookup_plain(words, idx)),
        bound=bound(words.numel() * 4 + 2 * idx.numel() * 4, 0)))

    # K2/K3: the full merged table, 2^18 points, kernel levels 0-8 (the
    # trainer starts with 0-6 and its probe can move finer levels over; 8 is
    # the first level with a same-window slot pair)
    spec = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=19,
                        desired_resolution=2048, layout="block512")
    levels = tuple(range(9))
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    N = KERNEL_POINTS
    sl, tile = same_window_tile(spec, levels, rng)
    bnd = boundary_points(spec, levels, rng)
    n_bulk = N - 128 - len(bnd)
    d = rng.normal(size=(n_bulk // 2, 3))
    shell = 0.5 + 0.3 * d / np.linalg.norm(d, axis=1, keepdims=True) \
        + rng.normal(0, 0.01, (n_bulk // 2, 3))
    bulk = np.concatenate([shell, rng.uniform(0, 1, (n_bulk - n_bulk // 2, 3)),
                           bnd]).astype(np.float32)
    xb = torch.from_numpy(np.clip(bulk, 0, 1)).to(dev)
    perm, _ = se.morton_perm(xb)
    x = torch.cat([xb[perm], torch.from_numpy(tile).to(dev)]).contiguous()
    T = N // se.TILE
    metas = [se.tile_meta(x.reshape(T, se.TILE, 3), spec, l) for l in levels]
    bases = torch.stack([m[0] for m in metas]).contiguous()
    rows = torch.stack([m[1] for m in metas]).contiguous()
    last = rows[sl, -1]
    if len(set(last.tolist())) == 8:
        raise AssertionError("same-window tile lost its window collision")

    out_k = se.inwin_fwd(table, x, bases, rows, spec, levels)
    out_p = se.inwin_fwd_plain(table, x, bases, rows, spec, levels)
    err2 = float((out_k - out_p).abs().max())
    g = torch.from_numpy(rng.normal(size=(N, len(levels), 3))
                         .astype(np.float32)).to(dev)
    bargs = (x, bases, rows, spec, levels, spec.table_size)
    dt_k = se.inwin_bwd(g, *bargs)
    err3 = float((dt_k - se.inwin_bwd_plain(g, *bargs)).abs().max())
    # atomics add each row's ~100s of terms in another order: the rtol is
    # taken relative to the row's sum of |terms| (atomic_tol_margin)
    tol3 = atomic_tol_margin(se.inwin_bwd, se.inwin_bwd_plain, g, bargs)
    log(f"[kernels] K2 max|err| {err2:.3e}; K3 max|err| {err3:.3e}; "
        f"in-window corner share "
        f"{float((out_p != 0).any(-1).float().mean()):.3f}")
    if not err2 <= TOL["inwin_fwd"][0]:
        raise AssertionError(f"K2 inwin_fwd disagrees: {err2}")
    if tol3 < 0:
        raise AssertionError(f"K3 inwin_bwd disagrees: {err3}")
    # the colliding slot pair's window rows got the gradient of both slots
    n_win_rows = int(dt_k[int(spec.offsets[sl]):int(spec.offsets[sl + 1])]
                     .abs().sum(-1).gt(0).sum())
    log(f"[kernels] same-window tile at level {sl}: rows {last.tolist()}, "
        f"{n_win_rows} table rows of the level touched")
    inwin_bwd_extra(dev, spec, levels, g, bargs)

    # K2 + residual == plain exact encode (kernel levels 0-8, gather 9-15)
    gather = tuple(range(9, 16))
    feat, cnt = se.splat_encode_raw(table, x, spec, gather_levels=gather)
    ref = hashgrid_encode(table, x, spec)
    err_enc = float((feat - ref).abs().max())
    log(f"[kernels] splat_encode_raw vs hashgrid_encode max|err| "
        f"{err_enc:.3e}; residual corners/level {cnt.tolist()}")
    atol, rtol = TOL["encode"]
    if not torch.allclose(feat, ref, atol=atol, rtol=rtol):
        raise AssertionError(f"K2 + residual != hashgrid_encode: {err_enc}")

    # bytes: each input read once (the table rows of the kernel's levels),
    # each output written once; the backward writes the whole [total, 3]
    # gradient its wrapper zeroes
    Lk = len(levels)
    meta = bases.numel() * 4 + rows.numel() * 4 + x.numel() * 4
    results.append(dict(
        name="inwin_fwd", route="cuda",
        source="nerf2mesh_tpu_torch/csrc/splat_inwin.cu",
        replaces="nerf2mesh_tpu/ops/splat_encode.py:234", max_abs_err=err2,
        ms=cuda_time_ms(lambda: se.inwin_fwd(table, x, bases, rows, spec, levels)),
        plain_ms=cuda_time_ms(
            lambda: se.inwin_fwd_plain(table, x, bases, rows, spec, levels)),
        bound=bound(level_rows(spec, levels) * 12 + meta + N * Lk * 12,
                    trilinear_flops(N * Lk))))
    results.append(dict(
        name="inwin_bwd", route="cuda",
        source="nerf2mesh_tpu_torch/csrc/splat_inwin.cu",
        replaces="nerf2mesh_tpu/ops/splat_encode.py:263", max_abs_err=err3,
        ms=cuda_time_ms(lambda: se.inwin_bwd(g, *bargs)),
        plain_ms=cuda_time_ms(lambda: se.inwin_bwd_plain(g, *bargs)),
        bound=bound(N * Lk * 12 + meta + spec.table_size * 12,
                    trilinear_flops(N * Lk))))
    results += winsort_kernels(dev, spec, table, rng)
    results += sweep_kernel(dev, rng)
    for r in results:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        r["library_ms"] = None      # no one PyTorch call computes these
        log(f"[kernels] {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return results


def atomic_tol_margin(kernel, plain, g, args):
    """Least margin of a gradient kernel against its plain version: atol +
    rtol of each row's summed |terms| (the plain gradient of |g|), for g and
    for |g| (where every term is >= 0 and the bound is the plain allclose).
    Negative means a row disagrees.  The tolerance is TOL[kernel's name]."""
    atol, rtol = TOL[kernel.__name__]
    mag = plain(g.abs(), *args)
    return min(float((atol + rtol * mag - (kernel(g, *args) - plain(g, *args))
                      .abs()).min()),
               float((atol + rtol * mag - (kernel(g.abs(), *args) - mag)
                      .abs()).min()))


def touched_tol_share(kernel, plain, g, args):
    """The largest |kernel - plain| over its tolerance (atomic_tol_margin's)
    among the gradient entries some term reaches (the plain gradient of |g|
    above 0): how near the entries the kernel writes came to failing."""
    atol, rtol = TOL[kernel.__name__]
    mag = plain(g.abs(), *args)
    err = (kernel(g, *args) - plain(g, *args)).abs()
    hit = mag > 0
    return float((err[hit] / (atol + rtol * mag[hit])).max())


def inwin_bwd_extra(dev, spec, levels, g, bargs):
    """K3's global vector adds on the main input, counted by the plain
    corner walk; then K3 on the hot spot, 16 morton tiles inside one
    lattice cell of level 0, where every lane of every warp adds into the
    same 8 rows."""
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    plain = se.inwin_bwd_plain
    adds = se.inwin_bwd_vector_adds(g, *bargs[:-1])
    inw = se._inwin_corners(*bargs[:-1])[2]
    scalar = 3 * int((inw & (g != 0).any(-1)[..., None]).sum())
    log(f"[kernels] K3 global vector adds {adds} (the scalar atomics they "
        f"replace: {scalar})")

    rng = np.random.default_rng(SEED + 1)
    s0 = spec.level_scale32(0)
    xh = torch.from_numpy(((7 + rng.uniform(0.01, 0.99, (2048, 3)) - spec.shift)
                           / s0).astype(np.float32)).to(dev)
    if not bool((torch.floor(xh * s0 + spec.shift) == 7).all()):
        raise AssertionError("hot spot left its level-0 cell")
    metas = [se.tile_meta(xh.reshape(-1, se.TILE, 3), spec, l) for l in levels]
    hargs = (xh, torch.stack([m[0] for m in metas]).contiguous(),
             torch.stack([m[1] for m in metas]).contiguous(), spec, levels,
             spec.table_size)
    gh = torch.from_numpy(rng.normal(size=(2048, len(levels), 3))
                          .astype(np.float32)).to(dev)
    margin = atomic_tol_margin(se.inwin_bwd, plain, gh, hargs)
    err = float((se.inwin_bwd(gh, *hargs) - plain(gh, *hargs)).abs().max())
    share = touched_tol_share(se.inwin_bwd, plain, gh, hargs)
    log(f"[kernels] K3 hot spot (16 tiles in one level-0 cell): max|err| "
        f"{err:.3e}; largest error over tolerance among touched entries "
        f"{share:.3f}")
    if margin < 0:
        raise AssertionError(f"K3 disagrees on the hot spot: {err}")


def winsort_long_run(dev, spec):
    """K6 on a long run: 2048 points inside one level-15 block (a window
    whose run spans 16 tiles, one owner block) and 2048 uniform points."""
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    rng = np.random.default_rng(SEED + 2)
    s = np.float32(spec.level_scale32(15))
    pts = np.concatenate([(8 * 100 + rng.uniform(0.01, 7.99, (2048, 3))
                           - spec.shift) / s, rng.uniform(0, 1, (2048, 3))])
    xc = torch.from_numpy(pts.astype(np.float32)).to(dev)
    oob = torch.zeros(4096, dtype=torch.bool, device=dev)
    metas = [se.winsort_meta(xc, oob, spec, l) for l in WINSORT_LEVELS]
    perm = torch.stack([m[0] for m in metas]).to(torch.int32).contiguous()
    wins = torch.stack([m[1] for m in metas]).contiguous()
    slots = torch.stack([m[2] for m in metas]).contiguous()
    run = int((wins[-1] == wins[-1, perm[-1].long().argsort()[0]]).sum())
    g = torch.from_numpy(rng.normal(size=(4096, len(WINSORT_LEVELS), 3))
                         .astype(np.float32)).to(dev)
    args = (xc, perm, wins, slots, spec, WINSORT_LEVELS, spec.table_size)
    err = float((se.winsort_bwd(g, *args) - se.winsort_bwd_plain(g, *args))
                .abs().max())
    share = touched_tol_share(se.winsort_bwd, se.winsort_bwd_plain, g, args)
    log(f"[kernels] K6 long run ({run} points in one level-15 window): "
        f"max|err| {err:.3e}; largest error over tolerance among touched "
        f"entries {share:.3f}")
    if run < 2048 or atomic_tol_margin(se.winsort_bwd, se.winsort_bwd_plain,
                                       g, args) < 0:
        raise AssertionError(f"K6 disagrees on the long run: {err}")


def winsort_kernels(dev, spec, table, rng):
    """K5/K6 on 2^18 uniform points (the fine-level regime: no spatial
    locality) at winsort levels 7-15, with out-of-bounds points and points on
    and 1 ulp from block edges."""
    from nerf2mesh_tpu_torch.ops.hashgrid import hashgrid_encode
    from nerf2mesh_tpu_torch.ops import splat_encode as se

    wl, N = WINSORT_LEVELS, KERNEL_POINTS
    bnd = boundary_points(spec, wl, rng)
    oobp = rng.uniform(0, 1, (64, 3))
    oobp[:32, 0], oobp[32:, 2] = 1.5, -0.2
    pts = np.concatenate([rng.uniform(0, 1, (N - len(bnd) - 64, 3)), bnd, oobp])
    x = torch.from_numpy(pts[rng.permutation(N)].astype(np.float32)).to(dev)
    xc = x.clamp(0, 1).contiguous()
    oob = ((x < 0) | (x > 1)).any(-1)
    metas = [se.winsort_meta(xc, oob, spec, l) for l in wl]
    perm = torch.stack([m[0] for m in metas]).to(torch.int32).contiguous()
    wins = torch.stack([m[1] for m in metas]).contiguous()
    slots = torch.stack([m[2] for m in metas]).contiguous()

    out_k = se.winsort_fwd(table, xc, perm, wins, slots, spec, wl)
    out_p = se.winsort_fwd_plain(table, xc, perm, wins, slots, spec, wl)
    err5 = float((out_k - out_p).abs().max())
    g = torch.from_numpy(rng.normal(size=(N, len(wl), 3))
                         .astype(np.float32)).to(dev)
    args = (xc, perm, wins, slots, spec, wl, spec.table_size)
    err6 = float((se.winsort_bwd(g, *args)
                  - se.winsort_bwd_plain(g, *args)).abs().max())
    tol6 = atomic_tol_margin(se.winsort_bwd, se.winsort_bwd_plain, g, args)
    share = float(torch.stack([m[3] for m in metas]).float().mean())
    log(f"[kernels] K5 max|err| {err5:.3e}; K6 max|err| {err6:.3e}; slotted "
        f"point share {share:.3f}; tiles with equal slots "
        f"{int((slots[..., 0] == slots[..., 1]).sum())} of "
        f"{slots.shape[0] * slots.shape[1]}")
    if not err5 <= TOL["winsort_fwd"][0]:
        raise AssertionError(f"K5 winsort_fwd disagrees: {err5}")
    if tol6 < 0:
        raise AssertionError(f"K6 winsort_bwd disagrees: {err6}")
    winsort_long_run(dev, spec)

    feat, _ = se.splat_encode_raw(table, x, spec, gather_levels=wl,
                                  winsort_levels=wl)
    ref = hashgrid_encode(table, x, spec)
    err_enc = float((feat - ref).abs().max())
    log(f"[kernels] winsort splat_encode_raw vs hashgrid_encode max|err| "
        f"{err_enc:.3e}")
    atol, rtol = TOL["encode"]
    if not torch.allclose(feat, ref, atol=atol, rtol=rtol):
        raise AssertionError(f"K5 + residual != hashgrid_encode: {err_enc}")

    fwd = (table, xc, perm, wins, slots, spec, wl)
    Lw = len(wl)
    meta = (perm.numel() + wins.numel() + slots.numel()) * 4 + xc.numel() * 4
    return [
        dict(name="winsort_fwd", route="cuda",
             source="nerf2mesh_tpu_torch/csrc/splat_winsort.cu",
             replaces="nerf2mesh_tpu/ops/splat_encode.py:365",
             max_abs_err=err5,
             ms=cuda_time_ms(lambda: se.winsort_fwd(*fwd)),
             plain_ms=cuda_time_ms(lambda: se.winsort_fwd_plain(*fwd)),
             bound=bound(level_rows(spec, wl) * 12 + meta + N * Lw * 12,
                         trilinear_flops(N * Lw))),
        dict(name="winsort_bwd", route="cuda",
             source="nerf2mesh_tpu_torch/csrc/splat_winsort.cu",
             replaces="nerf2mesh_tpu/ops/splat_encode.py:397",
             max_abs_err=err6,
             ms=cuda_time_ms(lambda: se.winsort_bwd(g, *args)),
             plain_ms=cuda_time_ms(lambda: se.winsort_bwd_plain(g, *args)),
             bound=bound(N * Lw * 12 + meta + spec.table_size * 12,
                         trilinear_flops(N * Lw)))]


def ref_spec():
    """The ref slice's table: 16 levels at resolutions 16..2048, levels 0-1
    dense, 2-15 hashed at 2^14 rows (bench_config(grid_layout="ref",
    log2_hashmap_size=14))."""
    from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec
    return HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=14,
                        desired_resolution=2048, layout="ref")


def sweep_bwd(g, table, x, spec):
    """K4b: the ref table gradient (kernels' call order, as in TOL)."""
    from nerf2mesh_tpu_torch.ops import pallas_encode as pe
    return pe.sweep_bwd(table, x, g, spec, need_dx=False)[0]


def sweep_bwd_plain(g, table, x, spec):
    from nerf2mesh_tpu_torch.ops import pallas_encode as pe
    return pe.sweep_bwd_plain(table, x, g, spec, need_dx=False)[0]


def sweep_kernel(dev, rng):
    """K4 and K4b on 2^18 points at the ref slice's table: uniform points,
    lattice edges (exact and 1 ulp off) at every level, coordinates 0 and
    1, the 1-ulp denormal below 0, 1 ulp above 1 and far outside; K4b also
    on 2^18 points in 16 tight clusters (thousands of adds to each coarse
    row); both at 40 and 70 levels (two launches: 64 levels, then 6) and on
    a tiled grid (whose dense levels wrap) on 4096 of those points."""
    from nerf2mesh_tpu_torch.ops import pallas_encode as pe
    from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec
    spec = ref_spec()
    if not pe.sweep_supported(spec) or spec.table_size != 248120:
        raise AssertionError(f"ref slice spec: {spec}")
    N, L = KERNEL_POINTS, spec.num_levels
    pts = rng.uniform(0, 1, (N, 3))
    k = 0
    for l in range(L):
        s = np.float32(spec.level_scale32(l))
        for _ in range(64):
            v = np.float32((rng.integers(1, int(s)) - np.float32(spec.shift)) / s)
            if rng.random() < 0.6:
                v = np.nextafter(v, np.float32(rng.choice([-1, 2])))
            pts[k, rng.integers(3)] = v
            k += 1
    tail = pts[N - 64:]
    tail[:8, 0], tail[8:16, 1] = 0.0, 1.0
    tail[16:24, 2] = np.nextafter(np.float32(0), np.float32(-1))
    tail[24:32, 0] = np.nextafter(np.float32(1), np.float32(2))
    tail[32:40, 1], tail[40:48, 2], tail[48:56] = 1.5, -0.2, 2.0
    x = torch.from_numpy(pts[rng.permutation(N)].astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    out_k = pe.sweep_fwd(table, x, spec)
    out_p = pe.sweep_fwd_plain(table, x, spec)
    err4 = float((out_k - out_p).abs().max())
    oob = ((x < 0) | (x > 1)).any(-1)
    log(f"[kernels] K4 max|err| {err4:.3e} over {N} points "
        f"({int(oob.sum())} out of bounds, all zero: "
        f"{not bool(out_k[oob].any())})")
    if not err4 <= TOL["sweep_fwd"][0] or bool(out_k[oob].any()):
        raise AssertionError(f"K4 sweep_fwd disagrees: {err4}")

    g = torch.from_numpy(rng.normal(size=(N, L * 3)).astype(np.float32)).to(dev)
    bargs = (table, x, spec)
    err4b = float((sweep_bwd(g, *bargs) - sweep_bwd_plain(g, *bargs))
                  .abs().max())
    margin = atomic_tol_margin(sweep_bwd, sweep_bwd_plain, g, bargs)
    centres = rng.uniform(0.2, 0.8, (16, 3))
    xc = torch.from_numpy(np.clip(centres[rng.integers(0, 16, N)]
                                  + rng.normal(0, 0.002, (N, 3)), 0, 1)
                          .astype(np.float32)).to(dev)
    cargs = (table, xc, spec)
    share_c = touched_tol_share(sweep_bwd, sweep_bwd_plain, g, cargs)
    margin_c = atomic_tol_margin(sweep_bwd, sweep_bwd_plain, g, cargs)
    log(f"[kernels] K4b max|err| {err4b:.3e} (uniform and boundary points); "
        f"16 clusters: largest error over tolerance among touched entries "
        f"{share_c:.3f}")
    if margin < 0 or margin_c < 0:
        raise AssertionError(f"K4b sweep_bwd disagrees: {err4b}, clusters "
                             f"{share_c}")
    for var in (dict(num_levels=40, log2_hashmap_size=14),
                dict(num_levels=70, log2_hashmap_size=14),
                dict(num_levels=6, log2_hashmap_size=12, gridtype="tiled")):
        vspec = HashGridSpec(**{**dict(level_dim=3, desired_resolution=2048,
                                       layout="ref"), **var})
        vt = torch.from_numpy(rng.uniform(-1, 1, (vspec.table_size, 3))
                              .astype(np.float32)).to(dev)
        verr = float((pe.sweep_fwd(vt, x[:4096], vspec)
                      - pe.sweep_fwd_plain(vt, x[:4096], vspec)).abs().max())
        vg = torch.from_numpy(rng.normal(size=(4096, vspec.num_levels * 3))
                              .astype(np.float32)).to(dev)
        vshare = touched_tol_share(sweep_bwd, sweep_bwd_plain, vg,
                                   (vt, x[:4096], vspec))
        log(f"[kernels] K4 at {var}: max|err| {verr:.3e}; K4b largest error "
            f"over tolerance {vshare:.3f}")
        if not verr <= TOL["sweep_fwd"][0]:
            raise AssertionError(f"K4 sweep_fwd disagrees at {var}: {verr}")
        if atomic_tol_margin(sweep_bwd, sweep_bwd_plain, vg,
                             (vt, x[:4096], vspec)) < 0:
            raise AssertionError(f"K4b sweep_bwd disagrees at {var}")
    # bytes: x once, the table once, the [N, L*3] features once; the
    # backward reads g and writes the whole gradient its wrapper zeroes
    return [dict(name="sweep_fwd", route="cuda",
                 source="nerf2mesh_tpu_torch/csrc/sweep_encode.cu",
                 replaces="nerf2mesh_tpu/ops/pallas_encode.py:68",
                 max_abs_err=err4,
                 ms=cuda_time_ms(lambda: pe.sweep_fwd(table, x, spec)),
                 plain_ms=cuda_time_ms(lambda: pe.sweep_fwd_plain(table, x,
                                                                  spec)),
                 bound=bound(N * 12 + spec.table_size * 12 + N * L * 12,
                             trilinear_flops(N * L))),
            dict(name="sweep_bwd", route="cuda",
                 source="nerf2mesh_tpu_torch/csrc/sweep_encode.cu",
                 replaces="nerf2mesh_tpu/ops/pallas_encode.py:212 (XLA)",
                 max_abs_err=err4b,
                 ms=cuda_time_ms(lambda: sweep_bwd(g, *bargs)),
                 plain_ms=cuda_time_ms(lambda: sweep_bwd_plain(g, *bargs)),
                 bound=bound(N * 12 + N * L * 12 + spec.table_size * 12,
                             trilinear_flops(N * L)))]


# --------------------------------------------------------------------------
# phase 4: the slice
# --------------------------------------------------------------------------

def bench_config(**kw):
    """bench.py's stage-0 configuration, with the overrides kw."""
    from nerf2mesh_tpu_torch.config import Config
    base = dict(
        bound=1.0, scale=0.8, dt_gamma=0.0, iters=30000,
        num_rays=4096, num_points=2 ** 18, max_steps=1024,
        grid_size=128, diffuse_step=1000, random_image_batch=True,
        background="random", mark_untrained=True, adaptive_num_rays=True,
        stochastic_fine=True, seed=SEED)
    base.update(kw)
    return dataclasses.replace(Config(path=""), **base).finalize()


def scene(cfg):
    from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
    from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
    frames = render_synthetic_frames(H=256, W=256, n_train=24, n_val=N_VAL,
                                     n_test=0)
    return (dataset_from_frames(cfg, frames, "train"),
            dataset_from_frames(cfg, frames, "val"))


def train_window(trainer, ds, steps, timed):
    """Run `steps` training steps; returns (losses, ray buckets, gather
    routes, last metrics, ms/step and rays/s over the last `timed` steps,
    launch counts of the run alone)."""
    from nerf2mesh_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses, buckets, routes = [], [], []
    t_start, timed_rays = None, 0
    for s in range(steps):
        if s == steps - timed:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        nr = trainer._bucket(trainer.num_rays)
        m = trainer.train_steps(ds, 1)
        losses.append(m["loss"])
        buckets.append(nr)
        routes.append(trainer.net_spec.encode_gather_levels)
        if t_start is not None:
            timed_rays += nr
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    if not last8 < first:
        raise AssertionError(f"loss did not fall: first-8 mean {first}, "
                             f"last-8 mean {last8}")
    return (losses, buckets, routes, m, (t_end - t_start) / timed * 1e3,
            timed_rays / (t_end - t_start), launches)


def run_eval(trainer, val, name, must_launch):
    """Trainer.evaluate on the val views with the launch counts set to 0
    just before and read just after; returns (PSNR, ms/frame, launches)."""
    from nerf2mesh_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = trainer.evaluate(val, name=name, track_best=False)
    ms_frame = (time.perf_counter() - t0) / val.num_frames * 1e3
    launches = dict(kernels.LAUNCHES)
    psnr = float(res["PSNR"])
    log(f"[eval] {name}: PSNR {psnr:.4f}; {ms_frame:.1f} ms/frame "
        f"({val.H}x{val.W}); march rounds per frame "
        f"{trainer.stats['eval_rounds']}; launches {launches}")
    if not math.isfinite(psnr):
        raise AssertionError(f"{name}: PSNR {psnr}")
    for k in must_launch:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} was not launched")
    return psnr, ms_frame, launches


def phase_slice(dev):
    """Phase 4 (128 training steps), with phase 5 (eval) around it."""
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    cfg = bench_config()
    t0 = time.perf_counter()
    ds, val = scene(cfg)
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    log(f"[slice] scene {ds.images.shape} + {val.images.shape} val + trainer "
        f"set up in {time.perf_counter() - t0:.1f} s; table "
        f"{tuple(trainer.params.table.shape)}")

    eval_launch = ("occ_lookup", "inwin_fwd")
    psnr0, ms0, _ = run_eval(trainer, val, "before", eval_launch)

    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    losses, buckets, routes, m, ms_step, rays_s, launches = train_window(
        trainer, ds, SLICE_STEPS, TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[slice] {SLICE_STEPS} steps in {time.perf_counter() - t_all:.1f} s;"
        f" losses first {np.round(losses[:4], 5).tolist()} last "
        f"{np.round(losses[-4:], 5).tolist()}")
    log(f"[slice] ray buckets {sorted(set(buckets))} (first {buckets[0]}, "
        f"last {buckets[-1]}); gather levels first {routes[0]} last "
        f"{routes[-1]}; last num_points {int(m['num_points'])}, pool "
        f"overflow {int(m['pool_overflow'])}")
    log(f"[slice] steady state (last {TIMED_STEPS} steps): {ms_step:.2f} "
        f"ms/step, {rays_s:.1f} rays/s; peak memory {peak:.2f} GiB; "
        f"launches {launches}")
    if len(set(buckets)) < 2:
        raise AssertionError(f"adaptive ray bucket never changed: {buckets}")
    for k in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the slice")

    psnr1, ms1, _ = run_eval(trainer, val, "after", eval_launch)
    if not psnr1 > psnr0:
        raise AssertionError(f"eval PSNR did not rise: {psnr0} -> {psnr1}")
    log(f"[eval] PSNR {psnr0:.4f} -> {psnr1:.4f} over {SLICE_STEPS} steps; "
        f"{ms0:.1f} -> {ms1:.1f} ms/frame")
    profile_region(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                   f"block512 steps {SLICE_STEPS}-{SLICE_STEPS + PROFILE_STEPS}",
                   per=PROFILE_STEPS)
    profile_region(lambda: trainer.render_image(
        val.poses[0], val.intrinsics_for(0), val.H, val.W),
        "block512 eval frame")
    return launches


def phase_winsort(dev):
    """Phase 6: exact winsort training (K5 forward, K6 table gradient) and
    its eval."""
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    cfg = bench_config(winsort_fine=True, stochastic_fine=False)
    ds, val = scene(cfg)
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    if trainer.net_spec.encode_winsort_levels != WINSORT_LEVELS:
        raise AssertionError(
            f"winsort levels {trainer.net_spec.encode_winsort_levels}")
    t_all = time.perf_counter()
    losses, buckets, routes, m, ms_step, rays_s, launches = train_window(
        trainer, ds, WINSORT_STEPS, WINSORT_STEPS // 2)
    log(f"[winsort] {WINSORT_STEPS} steps in "
        f"{time.perf_counter() - t_all:.1f} s; losses first "
        f"{np.round(losses[:4], 5).tolist()} last "
        f"{np.round(losses[-4:], 5).tolist()}; buckets {sorted(set(buckets))};"
        f" gather (= winsort) levels last {routes[-1]}")
    log(f"[winsort] last {WINSORT_STEPS // 2} steps: {ms_step:.2f} ms/step, "
        f"{rays_s:.1f} rays/s; launches {launches}")
    for k in ("winsort_fwd", "winsort_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by training")
    psnr, ms_frame, _ = run_eval(trainer, val, "winsort", ("winsort_fwd",))
    log(f"[winsort] eval PSNR {psnr:.4f}, {ms_frame:.1f} ms/frame")
    profile_region(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                   f"winsort steps {WINSORT_STEPS}-"
                   f"{WINSORT_STEPS + PROFILE_STEPS}", per=PROFILE_STEPS)
    return launches


def cli_argv(scene_dir, workspace, **kw):
    """The CLI flags of bench_config(**kw) (path and workspace given)."""
    from nerf2mesh_tpu_torch.config import Config
    cfg, default = bench_config(**kw), Config()
    argv = [scene_dir, "--workspace", workspace]
    for f in dataclasses.fields(Config):
        v = getattr(cfg, f.name)
        if f.name in ("path", "workspace", "refine_steps") or v == getattr(
                default, f.name):
            continue
        if isinstance(v, bool):
            argv.append(f"--{f.name}" if v else f"--no-{f.name}")
        else:
            argv += [f"--{f.name}", str(v)]
    return argv


def phase_cli(dev):
    """Phase 7: the ref small-table slice through nerf2mesh_tpu_torch.main;
    returns the launch counts of the whole first CLI run."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.config import parse_args
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.utils.convert import read_jax_checkpoint
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_")
    try:
        t0 = time.perf_counter()
        scene_dir = generate_synthetic_dataset(
            os.path.join(tmp, "scene"), H=256, W=256, n_train=24,
            n_val=N_VAL, n_test=2)
        ws = os.path.join(tmp, "ws")
        flags = dict(grid_layout="ref", log2_hashmap_size=14,
                     iters=CLI_STEPS, n_eval=1, n_ckpt=1, test_no_mesh=True)
        argv = cli_argv(scene_dir, ws, **flags)
        cfg = parse_args(argv)
        want = dataclasses.replace(bench_config(**flags), path=scene_dir,
                                   workspace=ws)
        if dataclasses.asdict(cfg) != dataclasses.asdict(want):
            raise AssertionError(f"CLI flags {argv} != bench_config")
        log(f"[cli] scene written in {time.perf_counter() - t0:.1f} s; "
            f"main {' '.join(argv[1:])}")

        train_launches = {}
        real_train = Trainer.train

        def counted_train(self, *a, **k):      # launches of training alone
            torch.cuda.synchronize()
            before = dict(kernels.LAUNCHES)
            out = real_train(self, *a, **k)
            torch.cuda.synchronize()
            for key, v in kernels.LAUNCHES.items():
                train_launches[key] = train_launches.get(key, 0) + v - before[key]
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        Trainer.train = counted_train
        try:
            t0 = time.perf_counter()
            trainer = cli_main(argv, device=dev)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
        finally:
            Trainer.train = real_train
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        tl = trainer.train_log
        losses = [e["loss"] for e in tl]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite logged loss: {losses}")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"loss did not fall: {losses}")
        a = next(e for e in tl if e["step"] >= CLI_STEPS // 2)
        b = tl[-1]
        ms_step = (b["seconds"] - a["seconds"]) / (b["step"] - a["step"]) * 1e3
        rays_s = (b["rays"] - a["rays"]) / (b["seconds"] - a["seconds"])
        log(f"[cli] main ran {t_main:.1f} s; logged losses "
            f"{np.round(losses, 5).tolist()}")
        log(f"[cli] steps {a['step']}-{b['step']}: {ms_step:.2f} ms/step, "
            f"{rays_s:.1f} rays/s; peak memory {peak:.2f} GiB; launches: "
            f"training {train_launches}, whole run {launches}")
        for key in ("occ_lookup", "sweep_fwd", "sweep_bwd"):
            if train_launches.get(key, 0) <= 0:
                raise AssertionError(f"{key} was not launched by training")
        for key in ("inwin_fwd", "inwin_bwd", "winsort_fwd", "winsort_bwd"):
            if launches[key]:
                raise AssertionError(f"{key} launched on the ref path")
        results = trainer.stats["results"]
        log(f"[cli] evals (step {CLI_STEPS} val, final val, test): {results}")
        if len(results) != 3 or not all(math.isfinite(v) for r in results
                                        for v in r.values()):
            raise AssertionError(f"evals: {results}")

        ckpt = os.path.join(ws, "checkpoints", "ngp_stage0_latest.ckpt")
        step_ckpt = os.path.join(ws, "checkpoints",
                                 f"ngp_stage0_{CLI_STEPS:07d}.ckpt")
        videos = [v for v in ("test_frames.npz", "test_rgb.gif",
                              "test_rgb.mp4")
                  if os.path.exists(os.path.join(ws, v))]
        if not (os.path.exists(ckpt) and os.path.exists(step_ckpt)
                and videos):
            raise AssertionError(f"workspace lacks a checkpoint or video: "
                                 f"{sorted(os.listdir(ws))}")
        saved = read_jax_checkpoint(ckpt)
        psnr_saved = float(saved["stats"]["results"][0]["PSNR"])
        log(f"[cli] wrote {os.path.basename(step_ckpt)} "
            f"({os.path.getsize(step_ckpt) / 2 ** 20:.1f} MiB), video "
            f"{videos}; step-{CLI_STEPS} val PSNR {psnr_saved:.6f}")

        tester = cli_main(argv + ["--test"], device=dev)
        if tester.step != CLI_STEPS or not all(
                math.isfinite(v) for v in tester.stats["results"][0].values()):
            raise AssertionError(f"--test: step {tester.step}, "
                                 f"{tester.stats['results']}")

        fresh = Trainer(cfg, device=dev)
        if not fresh.load_checkpoint():
            raise AssertionError("no checkpoint to load")
        val = load_nerf_dataset(cfg, "val")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = fresh.evaluate(val, name="reload", track_best=False)
        ms_frame = (time.perf_counter() - t0) / val.num_frames * 1e3
        log(f"[cli] reloaded step {fresh.step}: val PSNR {res['PSNR']:.6f} vs "
            f"{psnr_saved:.6f} recorded; {ms_frame:.1f} ms/frame "
            f"({val.H}x{val.W}), march rounds {fresh.stats['eval_rounds']}, "
            f"launches {dict(kernels.LAUNCHES)}")
        if not abs(res["PSNR"] - psnr_saved) <= 1e-4:
            raise AssertionError(f"reloaded PSNR {res['PSNR']} != "
                                 f"{psnr_saved}")
        train = load_nerf_dataset(cfg, "train")
        profile_region(lambda: fresh.train_steps(train, PROFILE_STEPS),
                       f"ref steps {CLI_STEPS}-{CLI_STEPS + PROFILE_STEPS}",
                       per=PROFILE_STEPS)
        profile_region(lambda: fresh.render_image(
            val.poses[0], val.intrinsics_for(0), val.H, val.W),
            "ref eval frame")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    card, name = phase_device()
    log(card)
    dev = torch.device("cuda", 0)
    phase_build()
    results = phase_kernels(dev)
    launches = phase_slice(dev)
    ws_launches = phase_winsort(dev)
    cli_launches = phase_cli(dev)
    for r in results:
        path = (ws_launches if r["name"].startswith("winsort") else
                cli_launches if r["name"].startswith("sweep") else launches)
        r["launches"] = path[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
