"""Where JPEG 2000's small files spend their decode: a gprof flat profile of
native/j2kdec.cpp over the 64^2 (and smaller) variants of
fixtures/formats/jpeg2000, and the split of data/jpeg2000.decode_jpeg2000
into the C++ decode and the numpy unpack.

    python3 workspace/port/j2k_profile.py [--reps N] [--out DIR]
        [--fixtures formats/jpeg2000_modes]

The codestreams (a JP2 file's jp2c payload) go to one file; a C++ harness
linked with a copy of j2kdec.cpp decodes them N times over: once built
with -O3 and its usual 8 threads (the time a file), once with one thread
and -pg, with inlining off so that gprof can name tier 1's parts.  Needs
g++ and gprof; the profile is written to DIR/j2k_gprof.txt."""
import argparse
import glob
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402

from nerf2mesh_tpu_torch.data import jpeg2000 as j2k  # noqa: E402

HARNESS = r"""
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int64_t j2k_info(const uint8_t *, int64_t, int64_t *, int64_t,
                            char *, int64_t);
extern "C" int64_t j2k_decode(const uint8_t *, int64_t, int32_t *, char *,
                              int64_t);
int main(int argc, char **argv) {
  FILE *f = fopen(argv[1], "rb");
  int reps = atoi(argv[2]);
  std::vector<std::vector<uint8_t>> cs;
  uint32_t len;
  while (fread(&len, 4, 1, f) == 1) {
    std::vector<uint8_t> b(len);
    if (fread(b.data(), 1, len, f) != len) return 2;
    cs.push_back(b);
  }
  fclose(f);
  char err[512];
  auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r)
    for (auto &b : cs) {
      int64_t info[21];
      int64_t nc = j2k_info(b.data(), b.size(), info, 21, err, 512);
      if (nc < 0) return 3;
      std::vector<int32_t> out(nc * (info[2] - info[0]) * (info[3] - info[1]));
      if (j2k_decode(b.data(), b.size(), out.data(), err, 512) < 0) return 4;
    }
  double s = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t0).count();
  printf("%zu codestreams x %d: %.1f us a file\n", cs.size(), reps,
         s / reps / cs.size() * 1e6);
  return 0;
}
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--out", default=".")
    ap.add_argument("--fixtures", default="formats/jpeg2000")
    args = ap.parse_args()
    root = os.path.join("nerf2mesh_tpu_torch", "fixtures", args.fixtures)
    files = [f for f in sorted(glob.glob(root + "/*")) if "512" not in f]
    datas = [open(f, "rb").read() for f in files]
    streams = [d if d[:4] == j2k.J2K_SIGNATURE else j2k._openjpeg_jp2(d)[1]
               for d in datas]
    # the Python side: decode_jpeg2000 against its C++ part alone
    for d in datas:
        j2k.decode_jpeg2000(d)
    best = {}
    for name, fn, xs in (("decode_jpeg2000", j2k.decode_jpeg2000, datas),
                         ("decode_codestream (C++ and its buffers)",
                          j2k.decode_codestream, streams)):
        b = 1e9
        for _ in range(5):
            t = time.perf_counter()
            for x in xs:
                fn(x)
            b = min(b, time.perf_counter() - t)
        best[name] = b / len(xs) * 1e6
        print(f"{name}: {best[name]:.1f} us a file over {len(xs)} files",
              flush=True)
    tmp = tempfile.mkdtemp(prefix="j2kprof_")
    try:
        with open(os.path.join(tmp, "cs.bin"), "wb") as f:
            for s in streams:
                f.write(np.uint32(len(s)).tobytes() + s)
        with open(os.path.join(tmp, "main.cpp"), "w") as f:
            f.write(HARNESS)
        src = open(os.path.join("nerf2mesh_tpu_torch", "native",
                                "j2kdec.cpp")).read()
        with open(os.path.join(tmp, "j2k8.cpp"), "w") as f:
            f.write(src)
        with open(os.path.join(tmp, "j2k1.cpp"), "w") as f:
            f.write(src.replace("constexpr int kThreads = 8;",
                                "constexpr int kThreads = 1;"))
        runs = (("o3_8threads", "j2k8.cpp", ["-O3"]),
                ("o3_1thread", "j2k1.cpp", ["-O3"]),
                ("gprof_1thread", "j2k1.cpp",
                 ["-O2", "-pg", "-fno-inline", "-fno-omit-frame-pointer"]))
        for name, cpp, fl in runs:
            exe = os.path.join(tmp, name)
            subprocess.run(["g++", "-std=c++17", "-pthread", *fl, "-o", exe,
                            os.path.join(tmp, "main.cpp"),
                            os.path.join(tmp, cpp)], check=True)
            res = subprocess.run([exe, os.path.join(tmp, "cs.bin"),
                                  str(args.reps)], capture_output=True,
                                 text=True, cwd=tmp)
            print(f"{name}: {res.stdout.strip()} (rc {res.returncode})",
                  flush=True)
        if shutil.which("gprof"):
            prof = subprocess.run(["gprof", "-b", "-p", os.path.join(
                tmp, "gprof_1thread"), os.path.join(tmp, "gmon.out")],
                capture_output=True, text=True).stdout
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "j2k_gprof.txt"), "w") as f:
                f.write(prof)
            print("\n".join(prof.splitlines()[:24]), flush=True)
        else:
            print("gprof: not found", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
