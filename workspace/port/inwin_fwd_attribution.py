"""Attribution runs for K2 inwin_fwd and K1 occ_lookup on a CUDA card.

    python3 workspace/port/inwin_fwd_attribution.py [--out FILE]

Builds inwin_fwd_variants.cu (beside this file) with nvcc into a shared
library under workspace/runs/, then times each build (the mean of 20
back-to-back launches between two CUDA events, two rounds) beside the
package's kernel:

K2 at the full block512 table (16 levels, 2^19 rows a level, finest
resolution 2048), kernel levels 0-8 and 0-6, on morton-sorted 2^18-point
sets (tools/ab_table_grads.py: uniform, half_shell, shell, clusters) and
4096 uniform points.  The builds (see the .cu file): the body before the
redesign as it was (d), with (a) no output stores, (b) constant rows, (c)
level-major lanes, (a)+(b); the redesign (s_staged, the package's body)
without stores and with constant rows; the package's K2 through its C
entry point (bare) and its wrapper.  Exact
builds are checked against inwin_fwd_plain (atol 1e-5).

K1 on a random 128^3 grid at 32768 x 128 cells: uniformly random, and the
sampler's (chip_smoke.sampler_cells): the body before the redesign and
the same without the word reads, the redesign's body without the word
reads, and the package's K1 through its C entry point (bare) and through
its wrapper; pack_bits of the grid.

Needs a CUDA card and nvcc; imports the package of this checkout.
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
import chip_smoke as cs  # noqa: E402
from nerf2mesh_tpu_torch import kernels  # noqa: E402
from nerf2mesh_tpu_torch.kernels import build as kbuild  # noqa: E402
from nerf2mesh_tpu_torch.ops import occ_sweep  # noqa: E402
from nerf2mesh_tpu_torch.ops import splat_encode as se  # noqa: E402
from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec, level_arrays  # noqa: E402

P = ctypes.c_void_p


def build_variants() -> ctypes.CDLL:
    out = ROOT / "workspace" / "runs" / "libk2v.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).resolve().parent / "inwin_fwd_variants.cu"
    cmd = [kbuild.find_nvcc(), "-Xptxas=-v", *kbuild.NVCC_FLAGS, "-shared",
           "-I", str(kbuild.SRC_DIR), "-o", str(out), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    print(f"[attr] built in {time.perf_counter() - t0:.1f} s", flush=True)
    for ln in (res.stdout + res.stderr).splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            print(f"[ptxas] {ln.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.k2v_count.restype = ctypes.c_int
    lib.k2v_name.restype = ctypes.c_char_p
    lib.k2v_name.argtypes = [ctypes.c_int]
    lib.k2v_exact.argtypes = [ctypes.c_int]
    lib.k2v_launch.argtypes = [ctypes.c_int, P, P, P, P,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(ctypes.c_int32), ctypes.c_float,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                               P, P]
    lib.k2v_launch.restype = ctypes.c_int
    lib.k1v_launch.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int64,
                               ctypes.c_int, P]
    lib.k1v_launch.restype = ctypes.c_int
    return lib


def k2_inputs(rng, dev):
    sets = abt.point_sets(rng, 2 ** 18)
    sets["n4096"] = rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    out = {}
    for name, pts in sets.items():
        x = torch.from_numpy(pts).to(dev)
        out[name] = x[se.morton_perm(x)[0]].contiguous()
    return out


def k2_case(lib, names, table, x, spec, levels, stream):
    dev = x.device
    metas = [se.tile_meta(x.reshape(-1, se.TILE, 3), spec, l) for l in levels]
    bases = torch.stack([m[0] for m in metas]).contiguous()
    rows = torch.stack([m[1] for m in metas]).contiguous()
    scales, offsets = level_arrays(spec, levels)
    N, T, Lk = x.shape[0], x.shape[0] // se.TILE, len(levels)
    plain = se.inwin_fwd_plain(table, x, bases, rows, spec, levels)
    out = torch.empty((N, Lk, 3), device=dev)

    def run(v):
        code = lib.k2v_launch(v, table.data_ptr(), x.data_ptr(),
                              bases.data_ptr(), rows.data_ptr(), scales,
                              offsets, float(spec.shift), N, T, Lk,
                              out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"{names[v]}: CUDA error {code}")

    lib_pkg = kernels.load()

    def bare():
        code = lib_pkg.n2m_inwin_fwd(table.data_ptr(), x.data_ptr(),
                                     bases.data_ptr(), rows.data_ptr(), scales,
                                     offsets, float(spec.shift), N, T, Lk,
                                     out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"K2: CUDA error {code}")

    pkg = se.inwin_fwd(table, x, bases, rows, spec, levels)
    out.fill_(float("nan"))
    bare()
    err = max(float((pkg - plain).abs().max()),
              float((out - plain).abs().nan_to_num(float("inf")).max()))
    if not err <= 1e-5:
        raise AssertionError(f"package K2 disagrees: {err}")
    r = dict(points=N, levels=Lk, package_err=err, variants={},
             package_ms=[abt.cuda_time_ms(lambda: se.inwin_fwd(
                 table, x, bases, rows, spec, levels)) for _ in range(2)],
             bare_ms=[abt.cuda_time_ms(bare) for _ in range(2)])
    for v, vname in enumerate(names):
        out.fill_(float("nan"))
        run(v)
        torch.cuda.synchronize()
        e = float((out - plain).abs().nan_to_num(float("inf")).max())
        if lib.k2v_exact(v) and not e <= 1e-5:
            raise AssertionError(f"{vname} disagrees: {e}")
        r["variants"][vname] = dict(err=e, ms=[])
    for _ in range(2):
        for v, vname in enumerate(names):
            r["variants"][vname]["ms"].append(abt.cuda_time_ms(lambda: run(v)))
    return r


def k1_cases(lib, rng, dev, stream):
    H = 128
    occ = torch.from_numpy((rng.random((1, H, H, H)) < 0.3)
                           .astype(np.uint8)).to(dev)
    words = occ_sweep.pack_bits(occ)
    train, _ = cs.sampler_cells(dev, rng)
    sets = {"random": torch.from_numpy(rng.integers(
        0, H ** 3, (32768, 128), dtype=np.int32)).to(dev), "sampler": train}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = dict(pack_bits_ms=abt.cuda_time_ms(lambda: occ_sweep.pack_bits(occ)))
    for name, idx in sets.items():
        out = torch.empty_like(idx)

        def run(v):
            code = lib.k1v_launch(v, words.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), idx.numel(), sms, stream)
            if code:
                raise RuntimeError(f"K1 variant {v}: CUDA error {code}")

        pkg = kernels.load()

        def bare():
            code = pkg.n2m_occ_lookup(words.data_ptr(), idx.data_ptr(),
                                      out.data_ptr(), idx.numel(), stream)
            if code:
                raise RuntimeError(f"K1: CUDA error {code}")

        want = occ_sweep.occ_lookup_plain(words, idx)
        for check in (lambda: run(0), bare):
            out.fill_(-1)
            check()
            if not torch.equal(out, want):
                raise AssertionError("K1 build disagrees")
        r = {}
        for _ in range(2):
            for v, vname in enumerate(("old", "old_no_words", "vec_no_words")):
                r.setdefault(vname, []).append(abt.cuda_time_ms(lambda: run(v)))
            r.setdefault("package_bare", []).append(abt.cuda_time_ms(bare))
            r.setdefault("package", []).append(abt.cuda_time_ms(
                lambda: occ_sweep.occ_lookup(words, idx)))
        res[name] = r
        print(f"[attr] K1 {name}: {r}", flush=True)
    print(f"[attr] pack_bits {res['pack_bits_ms']:.4f} ms", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="append the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("inwin_fwd_attribution: no CUDA device", flush=True)
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
    stream = kernels.current_stream_handle(dev)
    names = [lib.k2v_name(v).decode() for v in range(lib.k2v_count())]
    res = dict(card=card, k2={})
    for name, x in k2_inputs(rng, dev).items():
        for levels in (tuple(range(9)), tuple(range(7)), (6,)):
            key = f"{name}_L{len(levels)}"
            res["k2"][key] = r = k2_case(lib, names, table, x, spec, levels,
                                         stream)
            print(f"[attr] K2 {key}: package {r['package_ms'][0]:.4f} "
                  f"{r['package_ms'][1]:.4f} ms, bare {r['bare_ms'][0]:.4f} "
                  f"{r['bare_ms'][1]:.4f} ms", flush=True)
            for vname, d in r["variants"].items():
                print(f"[attr]   {vname:24s} {d['ms'][0]:.4f} {d['ms'][1]:.4f}"
                      f" ms  err {d['err']:.2e}", flush=True)
    res["k1"] = k1_cases(lib, rng, dev, stream)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
