"""Build the port's C++ host libraries (``native/*.cpp``) at first use.

Each library is compiled with $CXX (default g++) into the package's
git-ignored ``build/`` directory, named by a hash of its source and the
flags, never next to the source; a failed build raises.  meshing/meshops.py
and data/jpeg.py load theirs this way; ``load_library`` builds and loads
one with its functions' ctypes signatures (the image readers' libraries).
A library may add flags of its own (``LIBRARY_FLAGS``) to ``CXXFLAGS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "build")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")
# j2kdec follows OpenJPEG's float arithmetic bit for bit: no FMA may join
# one of its multiplies to an add; it decodes code-blocks on threads
LIBRARY_FLAGS = {"j2kdec": ("-ffp-contract=off", "-pthread")}


def flags(name: str) -> tuple:
    """The compiler flags of native/<name>.cpp's library."""
    return CXXFLAGS + LIBRARY_FLAGS.get(name, ())


def source_path(name: str) -> str:
    return os.path.join(PKG_DIR, "native", f"{name}.cpp")


def library_path(name: str, build_dir: str) -> str:
    """Where native/<name>.cpp's library for its current source and the
    flags lives in build_dir."""
    with open(source_path(name), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(flags(name)).encode())
    return os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_library(name: str, build_dir: str) -> str:
    """Compile native/<name>.cpp unless its library exists; returns its
    path.  Raises RuntimeError when the compiler fails."""
    path = library_path(name, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *flags(name), "-o", tmp,
           source_path(name)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the {name} library failed: "
                           f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, path)
    return path


_loaded = {}
_lock = threading.Lock()


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """native/<name>.cpp's library, built at first use and loaded once, with
    each function's ctypes signature set from `signatures` {function:
    (restype, [argtypes])}."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name, BUILD_DIR))
            for fn, (res, args) in signatures.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _loaded[name] = lib
    return lib
