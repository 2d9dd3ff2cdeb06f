"""Smoke run of the PyTorch port on one CUDA GPU (an H100 / sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 2;
  2. build: compile the port's kernels (nerf2mesh_tpu_torch/csrc) with nvcc;
  3. kernels: K1 occ_lookup, K2 inwin_fwd and K3 inwin_bwd against their
     plain PyTorch versions at the shapes the training step gives them,
     plus K2 + the residual against the plain hashgrid_encode, with times
     from CUDA events (median of 20);
  4. slice: stage-0 training at bench.py's configuration on the in-memory
     256x256 x 24-view sphere scene; every loss finite, the loss falls, and
     each kernel's launch counter is above 0 for the training run alone.
The line before the last is the kernels' JSON record, the last line the
device record.  Imports only the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SLICE_STEPS = 128          # grid refresh at 0, slab updates at 16, 32, ...
TIMED_STEPS = 64           # steady-state window: the last TIMED_STEPS steps
TOL = {"occ_lookup": (0.0, 0.0), "inwin_fwd": (1e-5, 0.0),
       "inwin_bwd": (1e-5, 1e-4), "encode": (1e-5, 1e-5)}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Median over `reps` runs of fn's device time, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
    from nerf2mesh_tpu_torch import kernels
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
        plain_ms=cuda_time_ms(lambda: occ_sweep.occ_lookup_plain(words, idx))))

    # K2/K3: the full merged table, 2^18 points, kernel levels 0-8 (the
    # trainer starts with 0-6 and its probe can move finer levels over; 8 is
    # the first level with a same-window slot pair)
    spec = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=19,
                        desired_resolution=2048, layout="block512")
    levels = tuple(range(9))
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    N = 2 ** 18
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
    dt_k = se.inwin_bwd(g, x, bases, rows, spec, levels, spec.table_size)
    dt_p = se.inwin_bwd_plain(g, x, bases, rows, spec, levels, spec.table_size)
    err3 = float((dt_k - dt_p).abs().max())
    # atomics add each row's ~100s of terms in another order: for signed g
    # the rtol is taken relative to the row's sum of |terms| (the
    # order-independent bound), i.e. the plain gradient of |g|; for |g|,
    # where every term is >= 0, that is the plain allclose
    mag = se.inwin_bwd_plain(g.abs(), x, bases, rows, spec, levels,
                             spec.table_size)
    mag_k = se.inwin_bwd(g.abs(), x, bases, rows, spec, levels,
                         spec.table_size)
    tol3 = min(float((TOL["inwin_bwd"][0] + TOL["inwin_bwd"][1] * mag
                      - (dt_k - dt_p).abs()).min()),
               float((TOL["inwin_bwd"][0] + TOL["inwin_bwd"][1] * mag
                      - (mag_k - mag).abs()).min()))
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

    results.append(dict(
        name="inwin_fwd", route="cuda",
        source="nerf2mesh_tpu_torch/csrc/splat_inwin.cu",
        replaces="nerf2mesh_tpu/ops/splat_encode.py:234", max_abs_err=err2,
        ms=cuda_time_ms(lambda: se.inwin_fwd(table, x, bases, rows, spec, levels)),
        plain_ms=cuda_time_ms(
            lambda: se.inwin_fwd_plain(table, x, bases, rows, spec, levels))))
    results.append(dict(
        name="inwin_bwd", route="cuda",
        source="nerf2mesh_tpu_torch/csrc/splat_inwin.cu",
        replaces="nerf2mesh_tpu/ops/splat_encode.py:263", max_abs_err=err3,
        ms=cuda_time_ms(lambda: se.inwin_bwd(g, x, bases, rows, spec, levels,
                                             spec.table_size)),
        plain_ms=cuda_time_ms(lambda: se.inwin_bwd_plain(
            g, x, bases, rows, spec, levels, spec.table_size))))
    for r in results:
        log(f"[kernels] {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms")
    return results


# --------------------------------------------------------------------------
# phase 4: the slice
# --------------------------------------------------------------------------

def bench_config():
    """bench.py's stage-0 configuration."""
    from nerf2mesh_tpu_torch.config import Config
    return dataclasses.replace(
        Config(path=""),
        bound=1.0, scale=0.8, dt_gamma=0.0, iters=30000,
        num_rays=4096, num_points=2 ** 18, max_steps=1024,
        grid_size=128, diffuse_step=1000, random_image_batch=True,
        background="random", mark_untrained=True, adaptive_num_rays=True,
        stochastic_fine=True, seed=SEED,
    ).finalize()


def phase_slice(dev):
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
    from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    cfg = bench_config()
    t0 = time.perf_counter()
    frames = render_synthetic_frames(H=256, W=256, n_train=24, n_val=0,
                                     n_test=0)
    ds = dataset_from_frames(cfg, frames, "train")
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    log(f"[slice] scene {ds.images.shape} + trainer set up in "
        f"{time.perf_counter() - t0:.1f} s; table {tuple(trainer.params.table.shape)}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, buckets, routes = [], [], []
    t_start = None
    timed_rays = 0
    t_all = time.perf_counter()
    for s in range(SLICE_STEPS):
        if s == SLICE_STEPS - TIMED_STEPS:
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
    ms_step = (t_end - t_start) / TIMED_STEPS * 1e3
    rays_s = timed_rays / (t_end - t_start)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[slice] {SLICE_STEPS} steps in {t_end - t_all:.1f} s; losses "
        f"first {np.round(losses[:4], 5).tolist()} last "
        f"{np.round(losses[-4:], 5).tolist()}")
    log(f"[slice] ray buckets {sorted(set(buckets))} (first {buckets[0]}, "
        f"last {buckets[-1]}); gather levels first {routes[0]} last "
        f"{routes[-1]}; last num_points {int(m['num_points'])}, pool "
        f"overflow {int(m['pool_overflow'])}")
    log(f"[slice] steady state (last {TIMED_STEPS} steps): {ms_step:.2f} "
        f"ms/step, {rays_s:.1f} rays/s; peak memory {peak:.2f} GiB; "
        f"launches {launches}")

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    if not last8 < first:
        raise AssertionError(f"loss did not fall: first-8 mean {first}, "
                             f"last-8 mean {last8}")
    if len(set(buckets)) < 2:
        raise AssertionError(f"adaptive ray bucket never changed: {buckets}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the slice")
    return launches, dict(ms_per_step=ms_step, rays_per_sec=rays_s,
                          peak_gib=peak, loss_first8=first, loss_last8=last8)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    card, name = phase_device()
    log(card)
    dev = torch.device("cuda", 0)
    phase_build()
    results = phase_kernels(dev)
    launches, _ = phase_slice(dev)
    for r in results:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
