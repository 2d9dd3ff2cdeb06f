"""chip_smoke.py's phase 14 (c) and (k) alone on one card: build the
port's kernels, decode every committed fixture to its Pillow hash with the
500 ms per MP bar (each format's read and decode logged apart), then main
on fixtures/colmap_rare (K1-K3 held at one more step; phase 3's times are
not taken, so they print as 0).

    python3 workspace/port/phase14_rare.py
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
dev = torch.device("cuda", 0)
c.phase_build()
t0 = time.perf_counter()
with c.no_modules("PIL", "cv2", "sklearn", "orbax", "tensorstore",
                  "zstandard"):
    c.decode_fixtures()
    t1 = time.perf_counter()
    launches, errs = c.ckpt_formats_capture(
        dev, {"occ_lookup": 0.0, "inwin_fwd": 0.0, "inwin_bwd": 0.0},
        "colmap_rare", "(k)",
        "McIdas, IMT, FITS, XV thumbnail, FLI and XPM masks")
    t2 = time.perf_counter()
print(f"decode {t1 - t0:.1f} s, (k) {t2 - t1:.1f} s; launches "
      f"{ {k: v for k, v in launches.items() if v} }; errs {errs}",
      flush=True)
print("QUICK OK")
