"""SSIM, the 3x3 box-filter loss variant.

Port of nope_nerf_tpu/ops/ssim.py::ssim_loss_map (reference model/losses.py:232-264:
reflection pad 1, 3x3 mean, clamp((1-SSIM)/2, 0, 1) as a map). As in the JAX
package the filter runs over the spatial (H, W) axes per channel. The 11-tap
gaussian eval variant comes with the eval slice.
"""

from __future__ import annotations

import torch

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean over a reflection-padded (H, W, C) image -> (H, W, C), as nine
    shifted adds (no convolution library call: exact f32 on every device)."""
    h, w, _ = x.shape
    xp = torch.nn.functional.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1),
                                 mode="reflect")[0].permute(1, 2, 0)
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[dy:dy + h, dx:dx + w]
    return acc / 9.0


def ssim_loss_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(H, W, C) pair -> per-pixel dissimilarity map clamp((1-SSIM)/2, 0, 1)."""
    mu_x, mu_y = _box3(x), _box3(y)
    sigma_x = _box3(x * x) - mu_x ** 2
    sigma_y = _box3(y * y) - mu_y ** 2
    sigma_xy = _box3(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x ** 2 + mu_y ** 2 + _C1) * (sigma_x + sigma_y + _C2)
    return torch.clamp((1.0 - n / d) / 2.0, 0.0, 1.0)
