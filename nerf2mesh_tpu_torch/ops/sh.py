"""Real spherical-harmonics direction encoding, degrees 1-8 (port of
nerf2mesh_tpu/ops/sh.py).

The reference's shencoder CUDA extension hard-codes the real SH polynomials
up to degree 8 and outputs degree^2 coefficients of unit directions.  As the
JAX module, this evaluates the same basis by the associated-Legendre
recurrence, with the Condon-Shortley phase carried by P_m^m's -(2m-1)
factors; autograd gives the backward.  The default nerf2mesh field does not
use it (its direction encoder is the identity); ``encoding.get_encoder``
offers it for user configs.
"""

from __future__ import annotations

import math

import torch


def sh_output_dim(degree: int) -> int:
    return degree * degree


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Unit directions [N, 3] -> [N, degree^2] real SH values, components
    l-major with m ascending: (0,0), (1,-1), (1,0), (1,1), (2,-2), ..."""
    if not 1 <= degree <= 8:
        raise ValueError(f"sh_encode: degree {degree} outside 1-8")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    L = degree - 1
    # c_m + i s_m = (x + i y)^m: the cos/sin(m phi) terms times sin^m theta
    c, s = [torch.ones_like(x)], [torch.zeros_like(x)]
    for m in range(1, L + 1):
        c.append(c[-1] * x - s[-1] * y)
        s.append(s[-1] * x + c[-2] * y)
    pmm = [torch.ones_like(z)]
    for m in range(1, L + 1):
        pmm.append(pmm[-1] * -(2 * m - 1))
    p = {}
    for m in range(L + 1):
        p[(m, m)] = pmm[m]
        if m + 1 <= L:
            p[(m + 1, m)] = z * (2 * m + 1) * pmm[m]
        for l in range(m + 2, L + 1):
            p[(l, m)] = ((2 * l - 1) * z * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)
    comps = []
    for l in range(L + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            k = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - am) / math.factorial(l + am))
            if m == 0:
                comps.append(k * p[(l, 0)])
            elif m > 0:
                comps.append(math.sqrt(2.0) * k * p[(l, m)] * c[m])
            else:
                comps.append(math.sqrt(2.0) * k * p[(l, am)] * s[am])
    return torch.stack(comps, dim=-1).float()
