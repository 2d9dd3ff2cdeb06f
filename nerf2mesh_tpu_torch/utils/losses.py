"""Training criteria and the weight-free perceptual loss (port of
nerf2mesh_tpu/utils/losses.py).

``perceptual_loss`` is the JAX package's LPIPS analog: three fixed random
3x3 convolutions (3->16->32->64, stride 2, "SAME" padding, ReLU), each map
unit-normalised along channels, and the mean squared feature difference.
The JAX package draws the filters from ``jax.random.normal(PRNGKey(1234))``,
which PyTorch cannot reproduce, so the port ships them as
``perceptual_filters.npz`` beside this module (written once from the JAX
function; tests/test_torch_io.py holds the two equal).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

_FILTERS = Path(__file__).resolve().parent / "perceptual_filters.npz"


def mse_loss(pred, gt):
    return (pred - gt) ** 2


def mape_loss(pred, gt, eps: float = 1e-2):
    """Mean absolute percentage error with a stop-grad denominator."""
    return (pred - gt).abs() / (gt.detach().abs() + eps)


def huber_loss(pred, gt, delta: float = 0.1):
    err = (pred - gt).abs()
    return torch.where(err <= delta, 0.5 * err * err / delta, err - 0.5 * delta)


CRITERIA = {"mse": mse_loss, "mape": mape_loss, "huber": huber_loss}


@lru_cache(maxsize=1)
def perceptual_filters() -> List[np.ndarray]:
    """The three HWIO filter banks [3, 3, cin, cout] (JAX layout)."""
    with np.load(_FILTERS) as z:
        return [z[f"w{i}"] for i in range(3)]


def _same_pad(n: int, stride: int = 2, k: int = 3):
    """XLA's "SAME" padding of one axis: (low, high); at stride 2 an even
    size pads only on the high side."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _perceptual_features(img: torch.Tensor) -> List[torch.Tensor]:
    """img [H, W, 3] in [0, 1] -> channel-normalised maps [1, C, h, w]."""
    x = ((img.float() - 0.5) * 2.0).permute(2, 0, 1)[None]         # NCHW
    feats = []
    for w in perceptual_filters():
        wt = torch.from_numpy(w).to(x.device).permute(3, 2, 0, 1)   # OIHW
        (ht, hb), (wl, wr) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        x = F.relu(F.conv2d(F.pad(x, (wl, wr, ht, hb)), wt, stride=2))
        feats.append(x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + 1e-8))
    return feats


def perceptual_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """LPIPS-style distance between two [H, W, 3] images in [0, 1]."""
    fp = _perceptual_features(pred)
    fg = _perceptual_features(gt.detach())
    terms = [((a - b) ** 2).sum(dim=1).mean() for a, b in zip(fp, fg)]
    return sum(terms) / len(terms)
