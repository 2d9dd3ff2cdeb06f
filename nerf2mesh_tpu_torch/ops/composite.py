"""Transmittance compositing on the dense [N_rays, K_samples] layout.

Port of nerf2mesh_tpu/ops/composite.py:

  alpha_i = 1 - exp(-sigma_i * dt_i)   (alpha_i = sigma_i in alpha_mode)
  T_i     = prod_{j<i} (1 - alpha_j)   (exclusive cumsum of log(1 - alpha))
  w_i     = alpha_i * T_i, masked where T_i < T_thresh (the reference's early
            stop, raymarching.cu:556-557) or the sample is invalid.
"""

from __future__ import annotations

from typing import Dict

import torch


def composite_rays(
    sigmas: torch.Tensor,      # [N, K] density (or alpha in alpha_mode)
    rgbs: torch.Tensor,        # [N, K, 3]
    ts: torch.Tensor,          # [N, K]
    dts: torch.Tensor,         # [N, K]
    valid: torch.Tensor,       # [N, K] bool
    *,
    T_thresh: float = 1e-4,
    alpha_mode: bool = False,
) -> Dict[str, torch.Tensor]:
    """Returns dict(weights [N,K], weights_sum [N], depth [N], image [N,3])."""
    sigmas = sigmas.float()
    rgbs = rgbs.float()
    if alpha_mode:
        alpha = sigmas.clamp(0.0, 1.0 - 1e-7)
    else:
        alpha = 1.0 - torch.exp(-sigmas * dts)
    alpha = torch.where(valid, alpha, 0.0)

    log1m = torch.log1p(-alpha.clamp(0.0, 1.0 - 1e-7))
    logT = torch.cumsum(log1m, dim=-1) - log1m          # exclusive
    T = torch.exp(logT.clamp(max=0.0))

    live = T >= T_thresh
    weights = torch.where(valid & live, alpha * T, 0.0)
    return {
        "weights": weights,
        "weights_sum": weights.sum(dim=-1),
        "depth": (weights * ts).sum(dim=-1),
        "image": (weights[..., None] * rgbs).sum(dim=-2),
    }
