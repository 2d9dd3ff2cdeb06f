"""COLMAP binary model readers and writers (cameras.bin / images.bin /
points3D.bin), qvec2rotmat and rotmat2qvec: a copy of
nerf2mesh_tpu/data/colmap_utils.py below this docstring (numpy and struct
only; tests/test_torch_colmap.py holds the two equal).

Implements the public COLMAP binary format specification
(colmap/src/colmap/scene/reconstruction_io.cc); behavioral parity target is
the reference's nerf/colmap_utils.py:108-258 readers.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray          # [M, 2] pixel coords
    point3D_ids: np.ndarray  # [M]

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt: str):
    sz = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(sz))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cam_id] = Camera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (m,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * m), dtype=np.float64).reshape(m, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].copy().view(np.int64).astype(np.int64)
            images[img_id] = Image(img_id, qvec, tvec, cam_id,
                                   name.decode("utf-8"), xys, ids)
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * track_len), dtype=np.int32
                                  ).reshape(track_len, 2)
            pts[pid] = Point3D(pid, xyz, rgb, float(err),
                               track[:, 0].copy(), track[:, 1].copy())
    return pts


def write_cameras_binary(cams: Dict[int, Camera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        model_ids = {v[0]: k for k, v in CAMERA_MODELS.items()}
        for cam in cams.values():
            f.write(struct.pack("<iiQQ", cam.id, model_ids[cam.model],
                                cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: Dict[int, Image], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            m = len(im.xys)
            f.write(struct.pack("<Q", m))
            data = np.empty((m, 3), np.float64)
            data[:, :2] = im.xys
            data[:, 2] = im.point3D_ids.astype(np.int64).view(np.float64)
            f.write(data.tobytes())


def write_points3d_binary(pts: Dict[int, Point3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            track = np.stack([p.image_ids, p.point2D_idxs], -1).astype(np.int32)
            f.write(track.tobytes())
