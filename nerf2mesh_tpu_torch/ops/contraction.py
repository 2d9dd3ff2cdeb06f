"""L-infinity scene contraction (port of nerf2mesh_tpu/ops/contraction.py).

Maps world space onto [-2, 2]^3: identity inside the unit box, and
x * (2 - 1/|x|_inf) / |x|_inf outside (reference nerf/renderer.py:25-41);
``uncontract`` is its inverse.  The numpy pair (``contract_np``,
``uncontract_np``) is a copy of the JAX module's, for the mesh exports.
"""

import numpy as np
import torch


def contract(xyzs: torch.Tensor) -> torch.Tensor:
    mag = xyzs.abs().amax(dim=-1, keepdim=True)
    return torch.where(mag <= 1, xyzs, xyzs * (2 - 1 / mag) / mag)


def uncontract(xyzs: torch.Tensor) -> torch.Tensor:
    mag = xyzs.abs().amax(dim=-1, keepdim=True)
    return torch.where(mag <= 1, xyzs, xyzs / (2 * mag - mag * mag))


def contract_np(xyzs: np.ndarray) -> np.ndarray:
    mag = np.max(np.abs(xyzs), axis=-1, keepdims=True)
    return np.where(mag <= 1, xyzs, xyzs * (2 - 1 / mag) / mag)


def uncontract_np(xyzs: np.ndarray) -> np.ndarray:
    mag = np.max(np.abs(xyzs), axis=-1, keepdims=True)
    return np.where(mag <= 1, xyzs, xyzs / (2 * mag - mag * mag))
