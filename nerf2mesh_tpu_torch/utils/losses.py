"""Per-element training criteria (port of nerf2mesh_tpu/utils/losses.py).

The stage-1 ``perceptual_loss`` is not ported yet (ROADMAP A8)."""

from __future__ import annotations

import torch


def mse_loss(pred, gt):
    return (pred - gt) ** 2


def mape_loss(pred, gt, eps: float = 1e-2):
    """Mean absolute percentage error with a stop-grad denominator."""
    return (pred - gt).abs() / (gt.detach().abs() + eps)


def huber_loss(pred, gt, delta: float = 0.1):
    err = (pred - gt).abs()
    return torch.where(err <= delta, 0.5 * err * err / delta, err - 0.5 * delta)


CRITERIA = {"mse": mse_loss, "mape": mape_loss, "huber": huber_loss}
