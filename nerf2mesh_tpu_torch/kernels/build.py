"""Build and load the port's CUDA kernels (nvcc -> one shared library -> ctypes).

Every ``csrc/*.cu`` file exposes plain ``extern "C"`` entry points, so the
library is compiled by nvcc alone, without PyTorch's headers (seconds, not
minutes).  The build runs at first use, inside the package's ``build/``
directory, keyed by a hash of the sources, headers and flags; a finished
library is reused.  Each source compiles to an object in its own nvcc
process, all started together, and one more nvcc links them.  Each entry
point launches on the stream it is given, allocates nothing, and returns
its ``cudaGetLastError()``; ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
_HOST_F32 = ctypes.POINTER(ctypes.c_float)
_HOST_I32 = ctypes.POINTER(ctypes.c_int32)

# entry point -> argtypes (all return int: the launch's cudaGetLastError)
_SIGNATURES = {
    # words, idx, out, n, stream
    "n2m_occ_lookup": (_P, _P, _P, _I64, _P),
    # table, x, bases, rows, scales (host), offsets (host), shift, n_points,
    # n_tiles, n_levels, out, stream
    "n2m_inwin_fwd": (_P, _P, _P, _P, _HOST_F32, _HOST_I32, _F32, _I64, _I64,
                      _I32, _P, _P),
    # grad, x, bases, rows, scales (host), offsets (host), shift, n_points,
    # n_tiles, n_levels, dtable, stream
    "n2m_inwin_bwd": (_P, _P, _P, _P, _HOST_F32, _HOST_I32, _F32, _I64, _I64,
                      _I32, _P, _P),
    # table, x, perm, wins, slots, scales (host), offsets (host), shift,
    # n_points, n_tiles, n_levels, out, stream
    "n2m_winsort_fwd": (_P, _P, _P, _P, _P, _HOST_F32, _HOST_I32, _F32, _I64,
                        _I64, _I32, _P, _P),
    # grad, x, perm, wins, slots, scales (host), offsets (host), shift,
    # n_points, n_tiles, n_levels, n_windows, dtable, stream
    "n2m_winsort_bwd": (_P, _P, _P, _P, _P, _HOST_F32, _HOST_I32, _F32, _I64,
                        _I64, _I32, _I64, _P, _P),
    # table, x, levels (host), shift, n_points, n_levels, chunks, out,
    # stream
    "n2m_sweep_fwd": (_P, _P, _P, _F32, _I64, _I32, _I64, _P, _P),
    # grad, x, levels (host), shift, n_points, n_levels, chunks, dtable,
    # stream
    "n2m_sweep_bwd": (_P, _P, _P, _F32, _I64, _I32, _I64, _P, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the port's CUDA "
        "kernels are compiled from nerf2mesh_tpu_torch/csrc at first use")


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libn2m_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds, verbose: bool) -> None:
    """Run the nvcc commands side by side; raise on the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
        elif verbose and text:
            print(text, flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into one sm_90a shared library unless it exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    ptxas = ["-Xptxas=-v"] if verbose else []
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *ptxas, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources(), objs)], verbose)
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *[str(o) for o in objs]]], verbose)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)            # atomic: concurrent builders agree
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and cached for the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.n2m_error_string.argtypes = [ctypes.c_int]
            lib.n2m_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.n2m_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
