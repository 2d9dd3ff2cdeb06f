"""--vis_pose: the cameras and the scene box, headless (port of
nerf2mesh_tpu/utils/vis_pose.py).

The reference shows an interactive trimesh scene of the camera frusta and
the bound box (and the sparse points of a colmap capture).  This writes the
same geometry as a coloured point cloud to ``<workspace>/poses.ply``: the
box's edges, each camera's frustum segments and up to ~20000 sparse points,
byte-equal to the JAX package's file, plus ``poses.png``, a 3-D scatter,
where matplotlib imports.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _frustum_points(pose: np.ndarray, size: float = 0.1, n: int = 8):
    """Sampled segment points of one camera frustum (provider.py:24-39)."""
    pos = pose[:3, 3]
    x, y, z = (size * pose[:3, k] for k in range(3))
    a, b, c, d = pos + x + y - z, pos - x + y - z, pos - x - y - z, pos + x - y - z
    t = np.linspace(0.0, 1.0, n)[:, None]
    return np.concatenate([p[None] * (1 - t) + q[None] * t for p, q in
                           [(pos, a), (pos, b), (pos, c), (pos, d),
                            (a, b), (b, c), (c, d), (d, a)]], 0)


def _box_points(bound: float, n: int = 16):
    t = np.linspace(-bound, bound, n)
    pts = []
    for u in (-bound, bound):
        for v in (-bound, bound):
            pts += [np.stack([t, np.full_like(t, u), np.full_like(t, v)], -1),
                    np.stack([np.full_like(t, u), t, np.full_like(t, v)], -1),
                    np.stack([np.full_like(t, u), np.full_like(t, v), t], -1)]
    return np.concatenate(pts, 0)


def write_pose_vis(workspace: str, poses: np.ndarray, bound: float,
                   points: Optional[np.ndarray] = None) -> str:
    """poses [B, 4, 4] cam2world; points [M, 3] or None.  Writes
    <workspace>/poses.ply (and poses.png with matplotlib); returns the PLY's
    path."""
    chunks = [(_box_points(bound), (255, 255, 0))]
    for p in np.asarray(poses):
        chunks.append((_frustum_points(np.asarray(p)), (0, 255, 0)))
    if points is not None and len(points):
        sub = np.asarray(points)[::max(1, len(points) // 20000)]
        chunks.append((sub, (180, 180, 255)))
    xyz = np.concatenate([c[0] for c in chunks], 0).astype(np.float32)
    rgb = np.concatenate(
        [np.tile(np.asarray(c[1], np.uint8), (len(c[0]), 1)) for c in chunks],
        0)

    os.makedirs(workspace, exist_ok=True)
    path = os.path.join(workspace, "poses.ply")
    rec = np.zeros(len(xyz), dtype=[("xyz", np.float32, 3),
                                    ("rgb", np.uint8, 3)])
    rec["xyz"], rec["rgb"] = xyz, rgb
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(xyz)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\n"
                 "property uchar blue\nend_header\n").encode())
        f.write(rec.tobytes())

    try:
        import matplotlib
    except ImportError:
        return path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], c=rgb / 255.0, s=1)
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(os.path.join(workspace, "poses.png"), dpi=110)
    plt.close(fig)
    return path
