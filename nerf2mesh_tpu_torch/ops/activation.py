"""Activations with custom gradients (port of nerf2mesh_tpu/ops/activation.py).

`trunc_exp` is exp whose *gradient* clamps its input to [-15, 15], matching
the reference density activation (reference activation.py:6-17).
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
