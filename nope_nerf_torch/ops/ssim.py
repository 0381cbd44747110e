"""SSIM: a 3x3 box-filter loss variant and an 11-tap gaussian eval variant.

Port of nope_nerf_tpu/ops/ssim.py. `ssim_loss_map` (reference
model/losses.py:232-264): reflection pad 1, 3x3 mean, clamp((1-SSIM)/2, 0, 1)
as a map; as in the JAX package the filter runs over the spatial (H, W) axes
per channel. `ssim` (reference third_party/pytorch_ssim/__init__.py:20-93):
gaussian window 11, sigma 1.5, zero-padded same-size filter, scalar mean.
"""

from __future__ import annotations

import numpy as np
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


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Scalar SSIM between two (H, W, C) images, the eval metric: the 2-D
    gaussian window applied per channel with zero-padded borders, mean over
    all pixels. The filter is a float32 convolution (TF32 is off package-wide:
    the variance E[x^2] - E[x]^2 cancels and needs the full mantissa)."""
    c = img1.shape[-1]
    g = _gaussian_window(window_size, sigma)
    kern = torch.from_numpy(np.outer(g, g)).to(img1.device, img1.dtype)
    kern = kern[None, None].expand(c, 1, window_size, window_size).contiguous()
    pad = window_size // 2

    def filt(x):
        return torch.nn.functional.conv2d(x.permute(2, 0, 1)[None], kern, padding=pad,
                                          groups=c)[0].permute(1, 2, 0)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1 = filt(img1 * img1) - mu1_sq
    sigma2 = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + _C1) * (2 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1 + sigma2 + _C2))
    return ssim_map.mean()
