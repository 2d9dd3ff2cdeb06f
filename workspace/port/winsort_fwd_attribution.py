"""Attribution runs for K5 winsort_fwd on a CUDA card.

    python3 workspace/port/winsort_fwd_attribution.py [--out FILE]

Builds winsort_fwd_variants.cu (beside this file) with nvcc into a shared
library under workspace/runs/, then times each build of K5's body before
its redesign (the mean of 20 back-to-back launches between two CUDA events,
two rounds) beside the package's K5, on window-sorted inputs at the full
block512 table (16 levels, 2^19 rows a level, finest resolution 2048) and
winsort levels 7-15:

  uniform      2^18 uniform points with out-of-bounds and block-edge points
               (chip_smoke.py's K5 input);
  half_shell, shell, clusters   2^18 points (tools/ab_table_grads.py);
  long_run     2^15 points inside one level-15 block, the rest of 2^18
               uniform;
  n65536, n16384, n4096, n128   uniform points of smaller counts.

The builds: (d) d_current, the body as it was, checked against
winsort_fwd_plain (atol 1e-5); (a) a_no_stores, (b) b_x_sorted, (c)
c_const_row and abc_all_three, wrong on purpose (see the .cu file).  Needs
a CUDA card and nvcc; imports the package of this checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "nerf2mesh_tpu_torch" / "tools"))

import ab_table_grads as abt  # noqa: E402
from nerf2mesh_tpu_torch import kernels  # noqa: E402
from nerf2mesh_tpu_torch.kernels import build as kbuild  # noqa: E402
from nerf2mesh_tpu_torch.ops import splat_encode as se  # noqa: E402
from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec, level_arrays  # noqa: E402

LEVELS = tuple(range(7, 16))
P = ctypes.c_void_p


def build_variants() -> ctypes.CDLL:
    out = ROOT / "workspace" / "runs" / "libwsv.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).resolve().parent / "winsort_fwd_variants.cu"
    cmd = [kbuild.find_nvcc(), "-Xptxas=-v", *kbuild.NVCC_FLAGS, "-shared",
           "-I", str(kbuild.SRC_DIR), "-o", str(out), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    regs = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    print(f"[attr] built in {time.perf_counter() - t0:.1f} s", flush=True)
    for ln in regs:
        print(f"[ptxas] {ln}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.wsv_count.restype = ctypes.c_int
    lib.wsv_name.restype = ctypes.c_char_p
    lib.wsv_name.argtypes = [ctypes.c_int]
    lib.wsv_exact.argtypes = [ctypes.c_int]
    lib.wsv_launch.argtypes = [ctypes.c_int, P, P, P, P, P,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(ctypes.c_int32), ctypes.c_float,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                               P, P]
    lib.wsv_launch.restype = ctypes.c_int
    return lib


def inputs(spec, rng):
    import chip_smoke as cs
    N = 2 ** 18
    bnd = cs.boundary_points(spec, LEVELS, rng)
    oobp = rng.uniform(0, 1, (64, 3))
    oobp[:32, 0], oobp[32:, 2] = 1.5, -0.2
    uni = np.concatenate([rng.uniform(0, 1, (N - len(bnd) - 64, 3)), bnd, oobp])
    sets = {"uniform": uni[rng.permutation(N)]}
    sets.update(abt.point_sets(rng, N))
    s = np.float32(spec.level_scale32(15))
    blk = (8 * 100 + rng.uniform(0.01, 7.99, (2 ** 15, 3)) - spec.shift) / s
    sets["long_run"] = np.concatenate([blk, rng.uniform(0, 1, (N - 2 ** 15, 3))])
    for n in (65536, 16384, 4096, 128):
        sets[f"n{n}"] = rng.uniform(0, 1, (n, 3))
    return {k: v.astype(np.float32) for k, v in sets.items()}


def meta(xnp, spec, dev):
    x = torch.from_numpy(xnp).to(dev)
    xc = x.clamp(0, 1).contiguous()
    oob = ((x < 0) | (x > 1)).any(-1)
    metas = [se.winsort_meta(xc, oob, spec, l) for l in LEVELS]
    perm = torch.stack([m[0] for m in metas]).to(torch.int32).contiguous()
    wins = torch.stack([m[1] for m in metas]).contiguous()
    slots = torch.stack([m[2] for m in metas]).contiguous()
    sl = slots.cpu().numpy()
    distinct = [float(np.mean([len(np.unique(sl[k, c:c + 8]))
                               for c in range(0, sl.shape[1], 8)]))
                for k in range(len(LEVELS))]
    return xc, perm, wins, slots, distinct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="append the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("winsort_fwd_attribution: no CUDA device", flush=True)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[attr] {card}; torch {torch.__version__}", flush=True)
    lib = build_variants()
    kernels.load()
    dev = torch.device("cuda", 0)
    spec = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=19,
                        desired_resolution=2048, layout="block512")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    scales, offsets = level_arrays(spec, LEVELS)
    stream = kernels.current_stream_handle(dev)
    names = [lib.wsv_name(v).decode() for v in range(lib.wsv_count())]
    res = dict(card=card, inputs={})
    for name, pts in inputs(spec, rng).items():
        xc, perm, wins, slots, distinct = meta(pts, spec, dev)
        N, T, Lw = xc.shape[0], xc.shape[0] // se.TILE, len(LEVELS)
        plain = se.winsort_fwd_plain(table, xc, perm, wins, slots, spec, LEVELS)
        out = torch.empty((N, Lw, 3), device=dev)

        def run(v):
            code = lib.wsv_launch(v, table.data_ptr(), xc.data_ptr(),
                                  perm.data_ptr(), wins.data_ptr(),
                                  slots.data_ptr(), scales, offsets,
                                  float(spec.shift), N, T, Lw, out.data_ptr(),
                                  stream)
            if code:
                raise RuntimeError(f"{names[v]}: CUDA error {code}")

        r = dict(points=N, distinct_slot_windows_per_8_tiles=distinct,
                 package_ms=abt.cuda_time_ms(
                     lambda: se.winsort_fwd(table, xc, perm, wins, slots,
                                            spec, LEVELS)),
                 variants={})
        for v, vname in enumerate(names):
            out.fill_(float("nan"))
            run(v)
            torch.cuda.synchronize()
            err = float((out - plain).abs().nan_to_num(float("inf")).max())
            if lib.wsv_exact(v) and not err <= 1e-5:
                raise AssertionError(f"{name}: {vname} disagrees: {err}")
            r["variants"][vname] = dict(err=err, ms=[])
        for _ in range(2):
            for v, vname in enumerate(names):
                r["variants"][vname]["ms"].append(abt.cuda_time_ms(lambda: run(v)))
        res["inputs"][name] = r
        print(f"[attr] {name}: N {N}, distinct slot windows a chunk of 8 "
              f"tiles by level {np.round(distinct, 2).tolist()}; package "
              f"{r['package_ms']:.4f} ms", flush=True)
        for vname, d in r["variants"].items():
            print(f"[attr]   {vname:16s} {d['ms'][0]:.4f} {d['ms'][1]:.4f} ms"
                  f"  err {d['err']:.2e}", flush=True)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
