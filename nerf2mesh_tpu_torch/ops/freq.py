"""NeRF positional (sin/cos) frequency encoding (port of
nerf2mesh_tpu/ops/freq.py): [x, sin(2^0 x), cos(2^0 x), ..., sin(2^{F-1}
x), cos(2^{F-1} x)], output_dim = D + D * 2 * F (the reference's
freqencoder); autograd gives the backward.
"""

from __future__ import annotations

import torch


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + input_dim * 2 * degree


def freq_encode(x: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """x: [N, D] -> [N, D * (1 + 2*degree)]."""
    outs = [x]
    for f in range(degree):
        xf = x * (2.0 ** f)
        outs.append(torch.sin(xf))
        outs.append(torch.cos(xf))
    return torch.cat(outs, dim=-1)
