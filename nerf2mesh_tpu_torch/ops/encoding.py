"""Encoder factory (port of nerf2mesh_tpu/ops/encoding.py; the reference's
encoding.py get_encoder).

``get_encoder(name, ...)`` returns (encode_fn(params, x) -> features,
init_fn(generator) -> params or None, output_dim), with JAX's names and
triple; the init function takes a ``torch.Generator`` where JAX's takes a
PRNG key.  The hash and tiled grids are the plain ``hashgrid_encode`` (1-3
input dimensions, linear or smoothstep); the field itself routes its
tables through the kernels (models/network.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from .freq import freq_encode, freq_output_dim
from .hashgrid import HashGridSpec, hashgrid_encode, init_hashgrid
from .sh import sh_encode, sh_output_dim


def get_encoder(name: str, input_dim: int = 3, degree: int = 4,
                num_levels: int = 16, level_dim: int = 2,
                base_resolution: int = 16, log2_hashmap_size: int = 19,
                desired_resolution: Optional[int] = 2048,
                interpolation: str = "linear",
                align_corners: bool = False):
    """(encode_fn(params, x), init_fn(generator) or None, output_dim) for
    "none"/"identity", "frequency"/"freq"/"frequency_torch",
    "sphere_harmonics"/"sh", and "hashgrid"/"tiledgrid"/"hashgrid_tcnn"
    (whose encode_fn also takes bound and max_level); ValueError otherwise.
    The analytic encoders take params=None."""
    name = (name or "None").lower()

    if name in ("none", "identity"):
        return (lambda params, x: x), None, input_dim

    if name in ("frequency", "freq", "frequency_torch"):
        return ((lambda params, x: freq_encode(x, degree)), None,
                freq_output_dim(input_dim, degree))

    if name in ("sphere_harmonics", "sh"):
        return ((lambda params, x: sh_encode(x, degree)), None,
                sh_output_dim(degree))

    if name in ("hashgrid", "tiledgrid", "hashgrid_tcnn"):
        spec = HashGridSpec(
            num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="tiled" if name == "tiledgrid" else "hash",
            interpolation=interpolation, align_corners=align_corners,
            input_dim=input_dim,
        )

        def encode(params: torch.Tensor, x: torch.Tensor, bound: float = 1.0,
                   max_level: Optional[int] = None) -> torch.Tensor:
            x01 = (x + bound) / (2 * bound)
            return hashgrid_encode(params, x01, spec, max_level)

        def init(generator: torch.Generator) -> torch.Tensor:
            return init_hashgrid(generator, spec)

        return encode, init, spec.output_dim

    raise ValueError(f"unknown encoder: {name}")
