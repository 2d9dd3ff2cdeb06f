"""Mesh file I/O (replaces the reference's trimesh dependency for load/export,
renderer.py:139-141, 543-544): binary-little-endian PLY write/read and the
OBJ+MTL writer used by the stage-1 web export (renderer.py:409-439).

A copy of ``nerf2mesh_tpu/meshing/io.py`` (the port imports nothing of the JAX
package); tests/test_torch_meshing.py holds the two equal.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray):
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(tris)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(verts.astype("<f4").tobytes())
        face_block = np.empty((len(tris), 13), np.uint8)
        face_block[:, 0] = 3
        face_block[:, 1:] = tris.astype("<i4").view(np.uint8).reshape(-1, 12)
        f.write(face_block.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    n_vert = n_face = 0
    fmt = "binary_little_endian"
    vert_props = []
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
            elif cur == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))

    _SZ = {"float": ("<f4", 4), "float32": ("<f4", 4), "double": ("<f8", 8),
           "uchar": ("<u1", 1), "uint8": ("<u1", 1), "int": ("<i4", 4),
           "uint": ("<u4", 4)}

    if fmt == "ascii":
        body = data[head_end:].decode().split()
        ncol = len(vert_props)
        vals = np.array(body[: n_vert * ncol], np.float32).reshape(n_vert, ncol)
        names = [p[0] for p in vert_props]
        verts = vals[:, [names.index("x"), names.index("y"), names.index("z")]]
        rest = body[n_vert * ncol:]
        tris = []
        i = 0
        for _ in range(n_face):
            k = int(rest[i])
            tris.append([int(v) for v in rest[i + 1:i + 1 + k]][:3])
            i += 1 + k
        return verts.astype(np.float32), np.array(tris, np.int32)

    # binary little endian
    off = head_end
    row = sum(_SZ[t][1] for _, t in vert_props)
    raw = np.frombuffer(data, np.uint8, count=n_vert * row, offset=off)
    raw = raw.reshape(n_vert, row)
    cols = {}
    c = 0
    for name, typ in vert_props:
        dt, sz = _SZ[typ]
        cols[name] = raw[:, c:c + sz].copy().view(dt).reshape(-1)
        c += sz
    verts = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
    off += n_vert * row
    # faces: assume uchar count == 3 + 3 int32 (13 bytes)
    fraw = np.frombuffer(data, np.uint8, count=n_face * 13, offset=off)
    fraw = fraw.reshape(n_face, 13)
    assert np.all(fraw[:, 0] == 3), "only triangle PLY supported"
    tris = fraw[:, 1:].copy().view("<i4").reshape(n_face, 3)
    return verts, tris.astype(np.int32)


def write_obj(path: str, verts: np.ndarray, tris: np.ndarray,
              vts: np.ndarray = None, fts: np.ndarray = None,
              mtl_name: str = None, tex_name: str = None):
    """OBJ (+MTL) writer matching the reference's stage-1 export format
    (renderer.py:409-439): v / vt (flipped v) / f v/vt triplets."""
    base = os.path.splitext(os.path.basename(path))[0]
    lines = []
    if mtl_name:
        lines.append(f"mtllib {base}.mtl \n")
    for v in verts:
        lines.append(f"v {v[0]} {v[1]} {v[2]} \n")
    if vts is not None:
        for vt in vts:
            lines.append(f"vt {vt[0]} {1 - vt[1]} \n")
    if mtl_name:
        lines.append("usemtl defaultMat \n")
    if vts is not None and fts is not None:
        for f, ft in zip(tris, fts):
            lines.append(
                f"f {f[0]+1}/{ft[0]+1} {f[1]+1}/{ft[1]+1} {f[2]+1}/{ft[2]+1} \n")
    else:
        for f in tris:
            lines.append(f"f {f[0]+1} {f[1]+1} {f[2]+1} \n")
    with open(path, "w") as fp:
        fp.writelines(lines)
    if mtl_name:
        mtl_path = os.path.join(os.path.dirname(path), f"{base}.mtl")
        with open(mtl_path, "w") as fp:
            fp.write("newmtl defaultMat \n")
            fp.write("Ka 1 1 1 \nKd 1 1 1 \nKs 0 0 0 \n")
            fp.write("Tr 1 \nillum 1 \nNs 0 \n")
            if tex_name:
                fp.write(f"map_Kd {tex_name} \n")
