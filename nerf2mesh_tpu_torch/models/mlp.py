"""Bias-free MLPs with the JAX package's weight layout (port of
nerf2mesh_tpu/models/mlp.py).

Each layer's weight is ``w: [in, out]`` (JAX layout, not torch.nn.Linear's
[out, in]), so a parameter named ``sigma_net.0.w`` here is
``params["sigma_net"][0]["w"]`` there.  ``compute_dtype`` mirrors
``apply_mlp``: under bfloat16 the activations and each weight are rounded
to bf16, every product accumulates and returns in fp32
(preferred_element_type there), the hidden activations are rounded to bf16
after the ReLU, and the last layer comes back in fp32, unrounded.  The
rounded operands are exact in fp32 (and in TF32), so an fp32 product of
them is the mixed-precision product; the casts' backward rounds the
cotangents to bf16 where JAX's transpose rules do.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Dense(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)


class MLP(nn.ModuleList):
    """ReLU MLP, no bias: dim_in -> dim_hidden x (num_layers-1) -> dim_out."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int, generator: torch.Generator):
        layers = []
        for l in range(num_layers):
            i = dim_in if l == 0 else dim_hidden
            o = dim_out if l == num_layers - 1 else dim_hidden
            bound = 1.0 / math.sqrt(i)        # kaiming-uniform, torch default
            w = torch.rand((i, o), generator=generator,
                           device=generator.device) * (2 * bound) - bound
            layers.append(Dense(w))
        super().__init__(layers)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        def rounded(t):
            return t.to(compute_dtype).float()

        h = rounded(x)
        n = len(self)
        for l, layer in enumerate(self):
            h = h @ rounded(layer.w)
            if l != n - 1:
                h = rounded(torch.relu(h))
        return h
