"""Attribution runs for K7 inwin_dense (csrc/inwin_dense.cu) on a CUDA card.

    python3 workspace/port/inwin_dense_attribution.py [--out FILE]

Builds variants of the package's inwin_dense.cu, each made by a textual
substitution of the committed source (so they follow it), with nvcc into
shared libraries under workspace/runs/, and times each at level 6 of the
full block512 table on 2^18 morton-sorted uniform points: deep, const_rows
and four_tiles through the variant's C entry point, the mean of 50
back-to-back launches between two CUDA events, two rounds.  Each result's
largest error against the plain version is logged; the builds marked
"wrong on purpose" remove work and are timed, not checked.

  kernel            the package's source as it is;
  cvt_split         the tf32 split by cvt.rna.tf32.f32 (the same rounding);
  groups_of_4       commit groups of 4 k-steps in place of 2;
  setmaxnreg_all    the producer's registers given to the consumers in
                    every variant, not only the apart ones;
  setmaxnreg_none   in none;
  no_mma            no wgmma (wrong on purpose): staging, A build, epilogue;
  one_mma           A_hi*B_hi alone (one tf32 product, ~5e-4 off);
  no_staging        the producer stages nothing (wrong on purpose);
  no_staging_no_mma the A build and the epilogue alone;
  a_twice           A built for the first two groups of a tile only (wrong
                    on purpose): staging, wgmma and epilogue.

Then the rate that wgmma.m64nNk8 tf32 sustains (A from registers, B from
128B-swizzled shared memory, as K7 issues it) for N = 48, 96, 192 with 1-3
warpgroups a block, 1 or 2 blocks an SM and 1 or 2 accumulator chains: the
ceiling of K7's product on this card.

Needs a CUDA card and nvcc; imports the package of this checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from nerf2mesh_tpu_torch import kernels  # noqa: E402
from nerf2mesh_tpu_torch.kernels import build as kbuild  # noqa: E402
from nerf2mesh_tpu_torch.ops import inwin_variants as iv  # noqa: E402
from nerf2mesh_tpu_torch.ops import splat_encode as se  # noqa: E402
from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec  # noqa: E402

OUT = ROOT / "workspace" / "runs" / "k7_attribution"
SRC = (kbuild.SRC_DIR / "inwin_dense.cu").read_text()
LEVEL = 6

MMA3 = ("    n2m::wgmma_m64n48k8(d, alo[i], dh, first ? 0u : 1u);\n"
        "    n2m::wgmma_m64n48k8(d, ahi[i], dl, 1u);\n"
        "    n2m::wgmma_m64n48k8(d, ahi[i], dh, 1u);\n")
KEEP_A = ('    asm volatile("" :: "r"(alo[i][0]), "r"(alo[i][1]), "r"(alo[i][2]),'
          ' "r"(alo[i][3]), "r"(ahi[i][0]), "r"(ahi[i][1]), "r"(ahi[i][2]),'
          ' "r"(ahi[i][3]), "l"(dh), "l"(dl), "r"(first ? 0u : 1u));\n')
STAGE = ("        stage_window(table + (off + static_cast<int64_t>(win) * 512)"
         " * 3, eo,")
NO_STAGE = (STAGE, "        if (win < 0) " + STAGE.strip())
NO_MMA = (MMA3, KEEP_A)
BUILD_A = "      if (gr + 1 < kGroups)\n"
CVT = ("n2m::split_tf32(", "split_cvt(")
CVT_DEF = ("namespace {\n", """namespace {
__device__ __forceinline__ void split_cvt(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo)
      : "f"(__fsub_rn(v, __uint_as_float(hi))));
}
""")
SMR = "if constexpr (Tr::kApart)\n"

VARIANTS = {
    "kernel": [],
    "cvt_split": [CVT_DEF, CVT],
    "groups_of_4": [("constexpr int kGroupK = 2;", "constexpr int kGroupK = 4;")],
    "setmaxnreg_all": [(SMR, "if constexpr (true)\n")],
    "setmaxnreg_none": [(SMR, "if constexpr (false)\n")],
    "no_mma": [NO_MMA],
    "one_mma": [(MMA3, "    n2m::wgmma_m64n48k8(d, ahi[i], dh, first ? 0u : 1u);\n")],
    "no_staging": [NO_STAGE],
    "no_staging_no_mma": [NO_STAGE, NO_MMA],
    "a_twice": [(BUILD_A, BUILD_A.replace("gr + 1 < kGroups", "gr + 1 < 2"))],
}


def nvcc(src: Path, lib: Path):
    return subprocess.Popen(
        [kbuild.find_nvcc(), "-Xptxas=-v", *kbuild.NVCC_FLAGS, "-shared", "-I",
         str(kbuild.SRC_DIR), "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_notes(text: str):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill stores" in ln or "C7512" in ln
            or "error" in ln]


def build_variants():
    """Each variant's n2m_inwin_dense_<tag> (ctypes), built side by side."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, subs in VARIANTS.items():
        s = SRC
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"{tag}: the source no longer holds {a!r}")
            s = s.replace(a, b)
        s = s.replace("n2m_inwin_dense(", f"n2m_inwin_dense_{tag}(")
        (OUT / f"{tag}.cu").write_text(s)
        procs[tag] = nvcc(OUT / f"{tag}.cu", OUT / f"lib{tag}.so")
    fns = {}
    for tag, proc in procs.items():
        text, _ = proc.communicate()
        print(f"[attr] build {tag}: rc {proc.returncode}; {ptxas_notes(text)}",
              flush=True)
        if proc.returncode:
            raise RuntimeError(text)
        fn = getattr(ctypes.CDLL(str(OUT / f"lib{tag}.so")),
                     f"n2m_inwin_dense_{tag}")
        fn.argtypes = kbuild._SIGNATURES["n2m_inwin_dense"]
        fns[tag] = fn
    return fns


def time_ms(fn, reps: int = 50) -> float:
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


def attribution(res):
    fns = build_variants()
    dev = torch.device("cuda", 0)
    spec = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=19,
                        desired_resolution=2048, layout="block512")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    xb = torch.from_numpy(rng.uniform(0, 1, (2 ** 18, 3))
                          .astype(np.float32)).to(dev)
    x = xb[se.morton_perm(xb)[0]].contiguous()
    N = x.shape[0]
    bases, rows = se.tile_meta(x.reshape(-1, se.TILE, 3), spec, LEVEL)
    crows = iv.const_rows(bases.shape[0], dev)
    out = torch.empty((N, 1, 3), device=dev)
    stream = kernels.current_stream_handle(dev)
    for rnd in range(2):
        for tag, fn in fns.items():
            row = {}
            for name, v in iv.VARIANTS.items():
                r = crows if v == 1 else rows
                args = (v, table.data_ptr(), x.data_ptr(), bases.data_ptr(),
                        r.data_ptr(), spec.level_scale32(LEVEL),
                        int(spec.offsets[LEVEL]), float(spec.shift), N,
                        N // se.TILE, out.data_ptr(), stream)
                if fn(*args):
                    raise RuntimeError(f"{tag} {name}: launch failed")
                want = (iv.inwin_dense_plain(table, x, bases, rows, spec, LEVEL)
                        if v != 1 else iv.inwin_dense_const_rows_plain(
                            table, x, bases, spec, LEVEL))
                row[name] = dict(ms=time_ms(lambda: fn(*args)),
                                 max_abs_err=float((out - want).abs().max()))
            res.setdefault("attribution", {}).setdefault(tag, []).append(row)
            print(f"[attr] round {rnd} {tag}: " + "; ".join(
                f"{k} {v['ms']:.4f} ms (err {v['max_abs_err']:.1e})"
                for k, v in row.items()), flush=True)


RATE_NS = (48, 96, 192)


def rate_source() -> str:
    """wgmma.m64nNk8 tf32 issued as K7 issues it, C chains a warpgroup, in a
    loop of commit groups of 4 k-steps with one group in flight."""
    out = ['#include <cuda_runtime.h>', '#include <cstdint>',
           '#include "inwin_dense.cuh"']
    for n in RATE_NS:
        r = n // 2
        regs = ", ".join(f"%{i}" for i in range(r))
        cons = ", ".join(f'"+f"(d[{i}])' for i in range(r))
        out.append(f'''
__device__ __forceinline__ void mma{n}(float (&d)[{r}], const uint32_t (&a)[4],
                                       uint64_t desc) {{
  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 {{{regs}}}, "
      "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1;\\n}}"
      : {cons}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}}''')
        for c in (1, 2):
            if n * c > 192:
                continue
            out.append(f'''
__global__ void rate{n}_{c}(int reps, float* sink) {{
  extern __shared__ uint8_t raw[];
  uint8_t* buf = raw + ((1024 - (n2m::smem_addr(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < {n} * 32; i += blockDim.x)
    reinterpret_cast<float*>(buf)[i] = 0.001f * (i % 97);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const uint32_t a[4] = {{0x3f800000u, 0x3f000000u, 0x3e800000u, 0x3f800000u}};
  float d[{c}][{r}];
  for (int j = 0; j < {c}; ++j)
    for (int i = 0; i < {r}; ++i) d[j][i] = 0.f;
  const uint32_t b = n2m::smem_addr(buf);
  for (int k = 0; k < reps; ++k) {{
    n2m::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < {c}; ++j) mma{n}(d[j], a, n2m::b_desc(b + s * 32));
    n2m::wgmma_commit();
    n2m::wgmma_wait<1>();
  }}
  n2m::wgmma_wait<0>();
  float t = 0.f;
  for (int j = 0; j < {c}; ++j)
    for (int i = 0; i < {r}; ++i) t += d[j][i];
  if (t == 12345.f) sink[0] = t;
}}
extern "C" int run_rate{n}_{c}(int blocks, int warpgroups, int reps,
                              void* sink) {{
  const int smem = {n} / 8 * 1024 + 1024;
  cudaFuncSetAttribute(rate{n}_{c},
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rate{n}_{c}<<<blocks, 128 * warpgroups, smem>>>(reps, (float*)sink);
  return cudaGetLastError();
}}''')
    return "\n".join(out) + "\n"


def wgmma_rate(res, reps: int = 2000):
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "rate.cu").write_text(rate_source())
    proc = nvcc(OUT / "rate.cu", OUT / "librate.so")
    text, _ = proc.communicate()
    print(f"[rate] build: rc {proc.returncode}; {ptxas_notes(text)}", flush=True)
    if proc.returncode:
        raise RuntimeError(text)
    lib = ctypes.CDLL(str(OUT / "librate.so"))
    sink = torch.zeros(1, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in RATE_NS:
        for c in (1, 2):
            if n * c > 192:
                continue
            fn = getattr(lib, f"run_rate{n}_{c}")
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            for w in (1, 2, 3):
                for per_sm in (1, 2):
                    if fn(sms * per_sm, w, 10, sink.data_ptr()):
                        continue        # too many registers for the block
                    torch.cuda.synchronize()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    code = fn(sms * per_sm, w, reps, sink.data_ptr())
                    b.record()
                    b.synchronize()
                    if code:
                        continue
                    flops = 2.0 * 64 * n * 8 * 4 * c * reps * w * sms * per_sm
                    tf = flops / a.elapsed_time(b) / 1e9
                    res.setdefault("wgmma_rate", []).append(
                        dict(n=n, chains=c, warpgroups=w, blocks_per_sm=per_sm,
                             tflops=tf))
                    print(f"[rate] m64n{n}k8 tf32, {c} chain(s), {w} "
                          f"warpgroup(s) a block, {per_sm} block(s) an SM: "
                          f"{tf:.1f} TFLOP/s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="append the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("inwin_dense_attribution: no CUDA device", flush=True)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[attr] {card}; torch {torch.__version__}", flush=True)
    res = dict(card=card)
    attribution(res)
    wgmma_rate(res)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
