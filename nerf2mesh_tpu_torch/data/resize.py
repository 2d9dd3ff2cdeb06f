"""Image and depth-map resizing without cv2 or Pillow, in numpy.

The JAX package resizes with the library at hand, and the port follows
each filter:

* ``resize_area``: cv2.resize(img, (w, h), interpolation=INTER_AREA) on
  uint8 images (blender frames whose size differs from the json's, and
  ``--downscale``).  Shrinking averages each output pixel's footprint with
  OpenCV's area weights (``computeResizeAreaTab``; at integer factors its
  block mean, rounded half up as its vector path does); enlarging is
  OpenCV's area-mode bilinear.  Both are separable products in float64,
  rounded to uint8.
* ``resize_bicubic``: Image.fromarray(img).resize((w, h)), Pillow's default
  BICUBIC (a = -0.5) on uint8 images (COLMAP frames whose size differs from
  their camera's): Pillow's support, bounds and coefficients in double,
  normalized and rounded to 22-bit fixed point, a horizontal then a
  vertical pass in integers, each rounded and clipped to uint8.  RGBA is
  resized premultiplied by alpha, as Pillow does.
* ``resize_linear``: cv2.resize(map, (w, h), interpolation=INTER_LINEAR) on
  float32 maps (dense depth): pixel-centre sampling, clamped at the edges,
  in float32.

tests/test_torch_captures.py holds each against the library it replaces.
"""

from __future__ import annotations

import math

import numpy as np


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] float32 weights of OpenCV's computeResizeAreaTab
    (shrinking: scale = src / dst >= 1)."""
    scale = src / dst
    A = np.zeros((dst, src), np.float32)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            A[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            A[dx, sx] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            A[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return A


def _area_linear_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of OpenCV's area-mode bilinear (INTER_AREA when an
    axis enlarges)."""
    scale, inv = src / dst, dst / src
    A = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        sx = math.floor(dx * scale)
        fx = np.float32((dx + 1) - (sx + 1) * inv)
        fx = 0.0 if fx <= 0 else float(fx - math.floor(fx))
        if sx >= src - 1:
            sx, fx = src - 1, 0.0
        A[dx, sx] += 1.0 - fx
        if fx:
            A[dx, sx + 1] += fx
    return A


def _resize_area_int(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    H, W = img.shape[:2]
    h, w = H // ky, W // kx
    x = img[:h * ky, :w * kx].astype(np.int64)
    s = x.reshape(h, ky, w, kx, -1).sum(axis=(1, 3))
    area = kx * ky
    if area == 4:
        return ((s + 2) >> 2).astype(np.uint8)       # OpenCV's vector path
    return np.clip(np.rint(s / area), 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA) for an [H, W]
    or [H, W, C] uint8 image."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[:2]
    if (H, W) == (h, w):
        out = img.copy()
    elif W >= w and H >= h and W % w == 0 and H % h == 0:
        out = _resize_area_int(img, W // w, H // h)
    else:
        shrink = W >= w and H >= h
        ax = _area_weights(W, w) if shrink else _area_linear_weights(W, w)
        ay = _area_weights(H, h) if shrink else _area_linear_weights(H, h)
        x = img.astype(np.float64)
        t = np.tensordot(ax.astype(np.float64), x, axes=([1], [1]))  # [w,H,C]
        t = np.tensordot(ay.astype(np.float64), t, axes=([1], [1]))  # [h,w,C]
        out = np.clip(np.rint(t), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


_PREC = 22                       # Pillow's PRECISION_BITS for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pillow_coeffs(src: int, dst: int):
    """(xmin [dst], fixed-point coefficients [dst, ksize]) of Pillow's
    precompute_coeffs + normalize_coeffs_8bpc for BICUBIC."""
    scale = src / dst
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    ksize = int(math.ceil(support)) * 2 + 1
    kk = np.zeros((dst, ksize), np.float64)
    xmins = np.zeros(dst, np.int64)
    for xx in range(dst):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) / fscale)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        kk[xx, :xmax] = w
        xmins[xx] = xmin
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * (1 << _PREC)),
                     np.trunc(0.5 + kk * (1 << _PREC))).astype(np.int64)
    return xmins, fixed


def _pillow_pass(x: np.ndarray, dst: int) -> np.ndarray:
    """One Pillow resample pass along axis 1 of [R, src, C] uint8.  The
    integer sums run as a float64 product with the banded coefficient
    matrix: every partial sum is an integer below 2^53, so it is exact in
    any order."""
    R, src, C = x.shape
    xmins, k = _pillow_coeffs(src, dst)
    M = np.zeros((src, dst), np.float64)
    for d in range(dst):
        n = min(k.shape[1], src - xmins[d])
        M[xmins[d]:xmins[d] + n, d] = k[d, :n]
    t = x.transpose(0, 2, 1).reshape(R * C, src).astype(np.float64) @ M
    ss = (1 << (_PREC - 1)) + t.astype(np.int64)
    out = np.clip(ss >> _PREC, 0, 255).astype(np.uint8)
    return out.reshape(R, C, dst).transpose(0, 2, 1)


def resize_bicubic(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Image.fromarray(img).resize((w, h)) (BICUBIC) for an [H, W] or
    [H, W, 3 or 4] uint8 image."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    H, W = x.shape[:2]
    rgba = x.shape[-1] == 4
    if rgba:                        # Pillow resizes RGBA as "RGBa"
        a = x[..., 3:].astype(np.int64)
        t = x[..., :3].astype(np.int64) * a + 128
        x = np.concatenate([((t + (t >> 8)) >> 8).astype(np.uint8),
                            x[..., 3:]], -1)
    if W != w:
        x = _pillow_pass(x, w)
    if H != h:
        x = _pillow_pass(x.transpose(1, 0, 2), h).transpose(1, 0, 2)
    x = np.ascontiguousarray(x)
    if rgba:
        a = x[..., 3:].astype(np.int64)
        rgb = x[..., :3].astype(np.int64)
        un = np.clip((255 * rgb) // np.maximum(a, 1), 0, 255)
        rgb = np.where((a == 0) | (a == 255), rgb, un)
        x = np.concatenate([rgb.astype(np.uint8), x[..., 3:]], -1)
    return x[..., 0] if squeeze else x


def _linear_taps(src: int, dst: int):
    """(left index, right index, right weight) of OpenCV's INTER_LINEAR."""
    scale = 1.0 / (dst / src)            # OpenCV's 1 / inv_scale, in double
    f = (np.arange(dst) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)       # the fraction in double, then float
    lo = s < 0
    f[lo], s[lo] = 0, 0
    hi = s >= src - 1
    f[hi], s[hi] = 0, src - 1
    return s, np.minimum(s + 1, src - 1), f


def resize_linear(m: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR) for an [H, W]
    float32 map."""
    m = np.asarray(m, np.float32)
    H, W = m.shape
    if (H, W) == (h, w):
        return m.copy()
    x0, x1, fx = _linear_taps(W, w)
    y0, y1, fy = _linear_taps(H, h)
    one = np.float32(1)
    rows = m[:, x0] * (one - fx) + m[:, x1] * fx          # [H, w]
    return (rows[y0] * (one - fy)[:, None]
            + rows[y1] * fy[:, None]).astype(np.float32)
