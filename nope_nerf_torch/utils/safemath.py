"""Gradient-safe primitives for exactly-degenerate inputs.

Port of nope_nerf_tpu/utils/safemath.py. A plain L2 norm has a NaN gradient at
exactly 0 (x/|x| = 0/0), and the NaN survives multiplication by a zero
cotangent: one zero-depth masked pixel or one coincident Chamfer pair poisons
the whole gradient. Here the gradient at 0 is defined as 0.
"""

from __future__ import annotations

import torch


class _SafeNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, keepdim: bool) -> torch.Tensor:
        d2 = torch.sum(x * x, dim=dim, keepdim=True)
        norm = torch.sqrt(d2)
        ctx.save_for_backward(x, norm)
        ctx.dim, ctx.keepdim = dim, keepdim
        return norm if keepdim else norm.squeeze(dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, norm = ctx.saved_tensors
        if not ctx.keepdim:
            grad = grad.unsqueeze(ctx.dim)
        pos = norm > 0
        scale = torch.where(pos, grad / torch.where(pos, norm, torch.ones_like(norm)),
                            torch.zeros_like(norm))
        return x * scale, None, None


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm over `dim` whose gradient at ||x|| == 0 is 0 (the minimum-norm
    subgradient) instead of NaN. Values equal sqrt(sum(x*x))."""
    return _SafeNorm.apply(x, dim, keepdim)
