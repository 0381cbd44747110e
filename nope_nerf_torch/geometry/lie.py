"""so(3)/SE(3) exp and log maps, batched over leading axes.

Port of nope_nerf_tpu/geometry/lie.py (reference model/common.py:277-310).
"""

from __future__ import annotations

import torch


def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    zero = torch.zeros_like(v[..., 0])
    row0 = torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1)
    row1 = torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1)
    row2 = torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def exp_so3(r: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3) Rodrigues exp-map, (..., 3) -> (..., 3, 3).

    The norm is sqrt(max(|r|^2, 1e-12)), as in the JAX package: the value
    matches the reference's `norm + 1e-15` shift and the gradient at r = 0 is 0."""
    skew = vec2skew(r)
    sq = torch.sum(r * r, dim=-1)[..., None, None]
    norm = torch.sqrt(torch.clamp_min(sq, 1e-12))
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(skew.shape)
    skew2 = skew @ skew
    return eye + (torch.sin(norm) / norm) * skew + ((1.0 - torch.cos(norm)) / norm ** 2) * skew2


def log_so3(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SO(3) -> so(3) log map, (..., 3, 3) -> (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    theta = torch.arccos(cos_theta)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    scale = theta / (2.0 * torch.sin(theta) + eps)
    return w * scale[..., None]


def make_c2w(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(axis-angle (..., 3), translation (..., 3)) -> (..., 4, 4) camera-to-world
    (reference model/common.py:301-310)."""
    top = torch.cat([exp_so3(r), t[..., :, None]], dim=-1)   # (..., 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)      # a fill on the device: no scalar copied in
    return torch.cat([top, bottom], dim=-2)


def convert3x4_4x4(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) by appending a [0, 0, 0, 1] row (reference
    model/common.py:312-330)."""
    bottom = torch.zeros_like(mat[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)      # a fill on the device: no scalar copied in
    return torch.cat([mat, bottom], dim=-2)
