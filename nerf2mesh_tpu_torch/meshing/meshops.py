"""Mesh processing API (parity target: reference meshutils.py).

A copy of ``nerf2mesh_tpu/meshing/meshops.py`` over the port's own copy of
the native library source (``nerf2mesh_tpu_torch/native/meshops.cpp``,
byte-equal to the JAX package's): quadric decimation, remeshing and
component cleaning in C++, plus numpy implementations of the simple
operations (masked-face removal, box-predicate vertex removal, midpoint
subdivision).  Unlike the JAX copy, the library is built at first use into
the package's ignored ``build/`` directory by utils/native.py, named by a
hash of the source and the flags; a failed build raises.
``native/Makefile`` builds the same library by hand.
tests/test_torch_meshing.py holds the two copies equal.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..utils import native

_BUILD_DIR = native.BUILD_DIR
_lib = None


def library_path(build_dir: Optional[str] = None) -> str:
    """Where the library for the current source and flags lives (in
    build_dir, default the package's build/)."""
    return native.library_path("meshops", build_dir or _BUILD_DIR)


def build(build_dir: Optional[str] = None) -> str:
    """Compile native/meshops.cpp with $CXX (default g++) unless the library
    for this source and these flags exists; returns its path.  Raises
    RuntimeError when the compiler fails."""
    return native.build_library("meshops", build_dir or _BUILD_DIR)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    pf = ctypes.POINTER(ctypes.c_float)
    pi = ctypes.POINTER(ctypes.c_int)
    lib.meshops_decimate.restype = ctypes.c_int
    lib.meshops_decimate.argtypes = [
        pf, ctypes.c_int, pi, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(pf), pi, ctypes.POINTER(pi), pi,
        ctypes.POINTER(pi),
    ]
    lib.meshops_remesh.restype = ctypes.c_int
    lib.meshops_remesh.argtypes = [
        pf, ctypes.c_int, pi, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        pi, ctypes.c_int,
        ctypes.POINTER(pf), pi, ctypes.POINTER(pi), pi,
        ctypes.POINTER(pi),
    ]
    lib.meshops_clean.restype = ctypes.c_int
    lib.meshops_clean.argtypes = [
        pf, ctypes.c_int, pi, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(pf), pi, ctypes.POINTER(pi), pi,
    ]
    lib.meshops_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _call_native(fn, verts, tris, *args, n_extra_out: int = 0):
    """Invoke a native op; returns (verts, tris[, extra int array per face])."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(tris, np.int32)
    pf = ctypes.POINTER(ctypes.c_float)
    pi = ctypes.POINTER(ctypes.c_int)
    out_v, out_f = pf(), pi()
    out_nv, out_nf = ctypes.c_int(0), ctypes.c_int(0)
    extras = [pi() for _ in range(n_extra_out)]
    rc = fn(
        v.ctypes.data_as(pf), len(v),
        f.ctypes.data_as(pi), len(f),
        *args,
        ctypes.byref(out_v), ctypes.byref(out_nv),
        ctypes.byref(out_f), ctypes.byref(out_nf),
        *[ctypes.byref(e) for e in extras],
    )
    assert rc == 0
    nv, nf = out_nv.value, out_nf.value
    rv = np.ctypeslib.as_array(out_v, shape=(nv, 3)).copy()
    rf = np.ctypeslib.as_array(out_f, shape=(nf, 3)).copy()
    lib.meshops_free(ctypes.cast(out_v, ctypes.c_void_p))
    lib.meshops_free(ctypes.cast(out_f, ctypes.c_void_p))
    res = [rv, rf]
    for e in extras:
        res.append(np.ctypeslib.as_array(e, shape=(nf,)).copy())
        lib.meshops_free(ctypes.cast(e, ctypes.c_void_p))
    return tuple(res)


def decimate_mesh(verts: np.ndarray, tris: np.ndarray, target: float,
                  protect: Optional[np.ndarray] = None,
                  return_src: bool = False):
    """Quadric edge-collapse to ~`target` faces (meshutils.py:27-60).

    With return_src=True also returns, per output face, the input face index
    it descends from (for carrying per-face attributes through)."""
    lib = _load()
    if protect is not None:
        protect = np.ascontiguousarray(protect, np.uint8)
        pp = protect.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        pp = ctypes.POINTER(ctypes.c_uint8)()
    res = _call_native(lib.meshops_decimate, verts, tris,
                       ctypes.c_int(int(target)), pp, n_extra_out=1)
    return res if return_src else res[:2]


def remesh_mesh(verts: np.ndarray, tris: np.ndarray, target_len: float,
                iterations: int = 3,
                face_attr: Optional[np.ndarray] = None,
                sel_attr: int = -1):
    """Isotropic explicit remeshing (meshutils.py:196-230
    isotropic_explicit_remeshing): split/collapse/flip/relax toward edge
    length `target_len`.  With face_attr + sel_attr >= 0, only the region
    whose faces carry attr == sel_attr is remeshed (selection border fixed);
    returns (verts, tris, attr) with the attribute carried through."""
    lib = _load()
    pi = ctypes.POINTER(ctypes.c_int)
    if face_attr is not None:
        fa = np.ascontiguousarray(face_attr, np.int32)
        pa = fa.ctypes.data_as(pi)
    else:
        pa = pi()
        sel_attr = -1
    return _call_native(lib.meshops_remesh, verts, tris,
                        ctypes.c_float(float(target_len)),
                        ctypes.c_int(int(iterations)),
                        pa, ctypes.c_int(int(sel_attr)), n_extra_out=1)


def clean_mesh(verts: np.ndarray, tris: np.ndarray,
               v_pct: float = 1.0, min_f: int = 8, min_d: float = 5.0,
               repair: bool = True, remesh: bool = False,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge close vertices (v_pct% of bbox diag), drop degenerate/dup faces,
    remove small isolated components (meshutils.py:146-188)."""
    del repair, remesh  # non-manifold repair folded into dedup; no remesh here
    verts = np.asarray(verts, np.float32)
    if len(verts) == 0:
        return verts, np.asarray(tris, np.int32)
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    eps = diag * v_pct / 10000.0
    lib = _load()
    return _call_native(lib.meshops_clean, verts, tris,
                        ctypes.c_float(eps), ctypes.c_int(min_f),
                        ctypes.c_float(min_d))


def remove_masked_trigs(verts: np.ndarray, tris: np.ndarray,
                        mask: np.ndarray, dilation: int = 5,
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Remove faces where mask!=0, after shrinking the masked set by `dilation`
    rings of face adjacency (meshutils.py:63-93 dilates the *selection* so
    borderline faces survive)."""
    mask = np.asarray(mask).astype(bool)
    keep = ~mask
    # dilate the keep set over vertex-adjacent faces `dilation` times
    for _ in range(dilation):
        kept_verts = np.zeros(len(verts), bool)
        kept_verts[tris[keep].reshape(-1)] = True
        keep = keep | kept_verts[tris].any(axis=1)
    v, f = verts, tris[keep]
    return _compact(v, f)


def remove_selected_verts(verts: np.ndarray, tris: np.ndarray,
                          predicate, ) -> Tuple[np.ndarray, np.ndarray]:
    """Remove vertices where predicate(verts) is True plus their faces
    (meshutils.py:122-144; the reference passes pymeshlab string expressions —
    here `predicate` is a callable or a boolean mask)."""
    if callable(predicate):
        sel = predicate(verts)
    else:
        sel = np.asarray(predicate, bool)
    face_sel = sel[tris].any(axis=1)
    return _compact(verts, tris[~face_sel])


def select_inside_box(r: float):
    """Predicate: |x|,|y|,|z| all <= r (used to carve cascade centers,
    renderer.py:637)."""
    return lambda v: np.all(np.abs(v) <= r, axis=-1)


def select_outside_box(aabb: np.ndarray):
    """Predicate: outside the [6] aabb (renderer.py:650)."""
    aabb = np.asarray(aabb)
    return lambda v: np.any((v <= aabb[:3]) | (v >= aabb[3:]), axis=-1)


def midpoint_subdivide(verts: np.ndarray, tris: np.ndarray,
                       face_mask: np.ndarray,
                       return_parents: bool = False):
    """1-to-4 midpoint subdivision of selected faces; neighbors of split edges
    are bisected to stay watertight (meshutils.py:191-230 refine path).

    With return_parents=True also returns, per output face, the index of the
    input face it derives from (children inherit per-face attributes)."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int64)
    face_mask = np.asarray(face_mask, bool)
    nv = len(verts)

    # collect split edges from selected faces
    sel = tris[face_mask]
    edges = np.concatenate([sel[:, [0, 1]], sel[:, [1, 2]], sel[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    ekey = edges[:, 0] * (nv + 1) + edges[:, 1]
    uniq_keys = np.unique(ekey)
    mid_of = {k: nv + i for i, k in enumerate(uniq_keys)}
    ua, ub = uniq_keys // (nv + 1), uniq_keys % (nv + 1)
    new_verts = 0.5 * (verts[ua] + verts[ub])
    all_verts = np.concatenate([verts, new_verts], axis=0)

    def mid(a, b):
        k = min(a, b) * (nv + 1) + max(a, b)
        return mid_of.get(k, -1)

    out = []
    parents = []
    for fi, (a, b, c) in enumerate(tris):
        mab, mbc, mca = mid(a, b), mid(b, c), mid(c, a)
        n_split = (mab >= 0) + (mbc >= 0) + (mca >= 0)
        n0 = len(out)
        if n_split == 0:
            out.append((a, b, c))
        elif n_split == 3:
            out += [(a, mab, mca), (mab, b, mbc), (mca, mbc, c), (mab, mbc, mca)]
        elif n_split == 1:
            if mab >= 0:
                out += [(a, mab, c), (mab, b, c)]
            elif mbc >= 0:
                out += [(b, mbc, a), (mbc, c, a)]
            else:
                out += [(c, mca, b), (mca, a, b)]
        else:  # 2 splits
            if mab < 0:
                out += [(c, mca, mbc), (mca, a, b), (mca, b, mbc)]
            elif mbc < 0:
                out += [(a, mab, mca), (mab, b, c), (mab, c, mca)]
            else:
                out += [(b, mbc, mab), (mbc, c, a), (mbc, a, mab)]
        parents += [fi] * (len(out) - n0)
    res = (all_verts.astype(np.float32), np.asarray(out, np.int32))
    if return_parents:
        return res + (np.asarray(parents, np.int64),)
    return res


def decimate_and_refine_mesh(verts: np.ndarray, tris: np.ndarray,
                             mask: np.ndarray,
                             decimate_ratio: float = 0.1,
                             refine_size: float = 0.01,
                             refine_remesh_size: float = 0.02,
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Adaptive refinement (meshutils.py:191-230), in the reference's order:
    mask==1 faces are decimated (selected-only, target
    (1-ratio)*(mask==1).sum() faces within the selection), the mask==1 region
    is isotropically remeshed to refine_remesh_size, then mask==2 faces with
    edges over refine_size are midpoint-subdivided.  The mask is carried
    through each topology change (pymeshlab carries fq; here the native ops
    return face provenance / attributes)."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    mask = np.asarray(mask).astype(np.int32)

    # 1. decimate the mask==1 selection (meshutils.py:204-206: quadric
    #    collapse, selected=True, targetfacenum=(1-ratio)*n_sel — i.e. remove
    #    ratio*n_sel faces, all from the selection)
    n_sel = int((mask == 1).sum())
    if decimate_ratio > 0 and n_sel > 0 and len(tris) > 0:
        target = len(tris) - int(decimate_ratio * n_sel)
        protect = (mask != 1).astype(np.uint8)
        verts, tris, src = decimate_mesh(verts, tris, target, protect=protect,
                                         return_src=True)
        mask = mask[src]

    # 2. isotropic remeshing of the (possibly decimated) selection
    #    (meshutils.py:208-209: 3 iterations at refine_remesh_size).  In SDF
    #    mode this is the only active step (reference main.py:151-153 zeroes
    #    decimate_ratio/refine_size and masks every face 1).
    if refine_remesh_size > 0 and (mask == 1).any() and len(tris) > 0:
        verts, tris, mask = remesh_mesh(
            verts, tris, refine_remesh_size, iterations=3,
            face_attr=mask, sel_attr=1)

    # 3. subdivide large high-error faces (meshutils.py:216-218: midpoint
    #    subdivision of the mask==2 selection with threshold refine_size)
    if refine_size > 0 and len(tris) > 0:
        e0 = np.linalg.norm(verts[tris[:, 0]] - verts[tris[:, 1]], axis=-1)
        e1 = np.linalg.norm(verts[tris[:, 1]] - verts[tris[:, 2]], axis=-1)
        e2 = np.linalg.norm(verts[tris[:, 2]] - verts[tris[:, 0]], axis=-1)
        big = np.maximum(np.maximum(e0, e1), e2) > refine_size
        to_split = (mask == 2) & big
        if to_split.any():
            verts, tris, parents = midpoint_subdivide(verts, tris, to_split,
                                                      return_parents=True)
            mask = mask[parents]

    # 4. repair (meshutils.py:212-214): dedup/degenerate removal via clean
    return clean_mesh(verts, tris, min_f=4, min_d=2.0)


def _compact(verts: np.ndarray, tris: np.ndarray):
    used, inv = np.unique(tris.reshape(-1), return_inverse=True)
    return (np.asarray(verts, np.float32)[used],
            inv.reshape(-1, 3).astype(np.int32))
