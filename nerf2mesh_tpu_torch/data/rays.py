"""Camera and ray math (port of nerf2mesh_tpu/data/rays.py).

Conventions follow the reference: dir_cam = [(i-cx)/fx, -(j-cy)/fy, -1] at
pixel centers, not normalized; poses are cam2world [4, 4]; rays_d =
dir_cam @ R^T, rays_o = t.  The rotation is a full-fp32 product written out
per element (the JAX package runs it at Precision.HIGHEST: bf16 ray
directions warped the stage-0 field).  The numpy camera helpers are copies
of the JAX module's.
"""

from __future__ import annotations

import numpy as np
import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True).clamp(min=eps))


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def pixel_dirs_cam(i, j, intrinsics):
    """Camera-space (unnormalized) ray directions for pixel centers.
    i: [N] column (x), j: [N] row (y), float, already +0.5."""
    fx, fy, cx, cy = intrinsics
    xs = (i - cx) / fx
    ys = -(j - cy) / fy
    zs = -torch.ones_like(i)
    return torch.stack([xs, ys, zs], dim=-1)


def get_rays(poses: torch.Tensor, intrinsics, H: int, W: int,
             indices: torch.Tensor = None):
    """World-space rays.

    poses: [B, 4, 4] cam2world (B == N when indices picks a pose per ray).
    intrinsics: (fx, fy, cx, cy) scalars.  indices: optional [N] flat pixel
    ids (j * W + i); None gives the full H*W image (poses must be [1, 4, 4]).
    Returns dict rays_o [N, 3], rays_d [N, 3] and, with indices, i, j [N]."""
    idx = (torch.arange(H * W, device=poses.device) if indices is None
           else indices)
    jj = (idx // W).float() + 0.5
    ii = (idx % W).float() + 0.5
    dirs = pixel_dirs_cam(ii, jj, intrinsics)                  # [N, 3]
    rot = poses[:, :3, :3]
    # rays_d[n, r] = sum_c dirs[n, c] * rot[n, r, c], in fp32 on every device
    rays_d = (dirs[:, None, 0] * rot[:, :, 0] + dirs[:, None, 1] * rot[:, :, 1]
              + dirs[:, None, 2] * rot[:, :, 2])
    rays_o = poses[:, :3, 3].expand_as(rays_d)
    out = {"rays_o": rays_o, "rays_d": rays_d}
    if indices is not None:
        out["i"] = idx % W
        out["j"] = idx // W
    return out


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33,
                       offset=(0, 0, 0)) -> np.ndarray:
    """Scale/offset camera centers into the scene box (reference provider.py:16-19)."""
    pose = np.array(pose, dtype=np.float32)
    pose[:3, 3] = pose[:3, 3] * scale + np.asarray(offset, dtype=np.float32)
    return pose


def make_projection(H: int, W: int, fl_y: float, near: float,
                    far: float = 1000.0) -> np.ndarray:
    """Perspective projection matching the reference (provider.py:265-276)."""
    y = H / (2.0 * fl_y)
    aspect = W / H
    return np.array(
        [
            [1 / (y * aspect), 0, 0, 0],
            [0, -1 / y, 0, 0],
            [0, 0, -(far + near) / (far - near), -(2 * far * near) / (far - near)],
            [0, 0, -1, 0],
        ],
        dtype=np.float32,
    )


def make_mvps(projection: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """MVP per camera: projection @ inv(cam2world)."""
    return np.einsum("ij,njk->nik", projection,
                     np.linalg.inv(poses)).astype(np.float32)


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """One orbit-camera cam2world pose looking at the origin; the rotation's
    third column is the camera *backward* axis (get_rays uses dir_cam z=-1)."""
    center = np.array([
        radius * np.sin(theta) * np.sin(phi),
        radius * np.cos(theta),
        radius * np.sin(theta) * np.cos(phi),
    ], dtype=np.float32)

    def normalize(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-8)

    backward = normalize(center)
    up = np.array([0, 1, 0], dtype=np.float32)
    right = normalize(np.cross(up, backward))
    up = normalize(np.cross(backward, right))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack((right, up, backward), axis=-1)
    pose[:3, 3] = center
    return pose


def _quat(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) of a rotation matrix, w >= 0."""
    tr = np.trace(R)
    i = int(np.argmax([R[0, 0], R[1, 1], R[2, 2], tr]))
    if i == 3:
        q = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1], 1 + tr])
    else:
        j, k = (i + 1) % 3, (i + 2) % 3
        q = np.empty(4)
        q[i] = 1 - tr + 2 * R[i, i]
        q[j] = R[j, i] + R[i, j]
        q[k] = R[k, i] + R[i, k]
        q[3] = R[k, j] - R[j, k]
    q /= np.linalg.norm(q)
    return -q if q[3] < 0 else q


def slerp(R0: np.ndarray, R1: np.ndarray, t: float) -> np.ndarray:
    """The rotation a fraction t of the way from R0 to R1 along the
    shortest arc (scipy's Slerp, in numpy, in float64 as scipy works)."""
    R0, R1 = np.asarray(R0, np.float64), np.asarray(R1, np.float64)
    q = _quat(R0.T @ R1)
    s = np.linalg.norm(q[:3])
    angle = 2 * np.arctan2(s, q[3])
    if s < 1e-12:
        return np.array(R0, dtype=np.float64)
    k = q[:3] / s
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    a = t * angle
    return R0 @ (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K)
