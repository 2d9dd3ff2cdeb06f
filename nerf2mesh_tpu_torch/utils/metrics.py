"""Evaluation metrics (port of nerf2mesh_tpu/utils/metrics.py): PSNR
(reference nerf/utils.py:351-387), SSIM and LPIPS, on host numpy images in
[0, 1].

``LPIPSMeter`` uses the ``lpips`` package (vgg) where it is importable, and
otherwise the weight-free perceptual proxy of utils/losses.py, reported as
"LPIPS (proxy)" so that the two are never conflated.
"""

from __future__ import annotations

import numpy as np


class Meter:
    name = "meter"

    def __init__(self):
        self.V = 0.0
        self.N = 0

    def clear(self):
        self.V, self.N = 0.0, 0

    def measure(self) -> float:
        return float(self.V / max(self.N, 1))

    def update(self, preds: np.ndarray, truths: np.ndarray):
        raise NotImplementedError

    def report(self) -> str:
        return f"{self.name} = {self.measure():.6f}"


class PSNRMeter(Meter):
    name = "PSNR"

    def update(self, preds: np.ndarray, truths: np.ndarray):
        preds = np.asarray(preds, np.float32)
        truths = np.asarray(truths, np.float32)
        mse = np.mean((preds - truths) ** 2)
        self.V += -10.0 * np.log10(max(mse, 1e-12))
        self.N += 1


def ssim(img0: np.ndarray, img1: np.ndarray, max_val: float = 1.0) -> float:
    """Single-scale SSIM with a 7x7 box window (per channel, averaged)."""
    from scipy.ndimage import uniform_filter

    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2

    def f(x):
        return uniform_filter(x, size=(7, 7, 1))

    mu0, mu1 = f(img0), f(img1)
    s00 = f(img0 * img0) - mu0 * mu0
    s11 = f(img1 * img1) - mu1 * mu1
    s01 = f(img0 * img1) - mu0 * mu1
    num = (2 * mu0 * mu1 + C1) * (2 * s01 + C2)
    den = (mu0 ** 2 + mu1 ** 2 + C1) * (s00 + s11 + C2)
    return float(np.mean(num / den))


class SSIMMeter(Meter):
    name = "SSIM"

    def update(self, preds: np.ndarray, truths: np.ndarray):
        self.V += ssim(preds, truths)
        self.N += 1


class LPIPSMeter(Meter):
    name = "LPIPS (vgg)"

    def __init__(self):
        super().__init__()
        try:
            import lpips
        except ImportError:
            self.fn = None
            self.name = "LPIPS (proxy)"
        else:
            self.fn = lpips.LPIPS(net="vgg")

    def update(self, preds: np.ndarray, truths: np.ndarray):
        import torch
        p = torch.from_numpy(np.asarray(preds, np.float32))
        g = torch.from_numpy(np.asarray(truths, np.float32))
        with torch.no_grad():
            if self.fn is None:
                from .losses import perceptual_loss
                self.V += float(perceptual_loss(p, g))
            else:
                self.V += float(self.fn(p.permute(2, 0, 1)[None] * 2 - 1,
                                        g.permute(2, 0, 1)[None] * 2 - 1))
        self.N += 1
