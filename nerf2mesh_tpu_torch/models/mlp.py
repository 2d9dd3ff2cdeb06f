"""Bias-free MLPs with the JAX package's weight layout (port of
nerf2mesh_tpu/models/mlp.py).

Each layer's weight is ``w: [in, out]`` (JAX layout, not torch.nn.Linear's
[out, in]), so a parameter named ``sigma_net.0.w`` here is
``params["sigma_net"][0]["w"]`` there.  ``compute_dtype`` mirrors
``apply_mlp``: bfloat16 casts activations and weights before each product
(the JAX package accumulates in fp32 via preferred_element_type; PyTorch
rounds each bf16 product's output to bf16 before the cast back).
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
        h = x.to(compute_dtype)
        n = len(self)
        for l, layer in enumerate(self):
            h = h @ layer.w.to(compute_dtype)
            if l != n - 1:
                h = torch.relu(h)
        return h.float()
