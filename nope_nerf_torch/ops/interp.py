"""Image sampling and resizing with the reference's index arithmetic.

Port of nope_nerf_tpu/ops/interp.py. The reference leans on torch's
`grid_sample` (model/common.py:75-109, get_tensor_values) and `F.interpolate`
nearest/bilinear/area (model/training.py:357-366, model/network.py:21).
Sampling is written out as gathers of the four taps, and a resize is two small
products (row weights @ image @ column weights^T) with weights built by numpy:
`F.interpolate` rounds its sample positions differently, and sub-pixel
differences shift the photometric-warp loss.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def grid_sample(image: torch.Tensor, points: torch.Tensor, mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Sample image (H, W, C) at [-1,1]^2 points (N, 2) -> (N, C), zeros padding:
    - align_corners=True:  ix = (x+1)/2 * (W-1)
    - align_corners=False: ix = ((x+1)*W - 1)/2
    Out-of-bounds taps contribute zero."""
    h, w, _ = image.shape
    x, y = points[:, 0], points[:, 1]
    if align_corners:
        ix = (x + 1.0) * 0.5 * (w - 1)
        iy = (y + 1.0) * 0.5 * (h - 1)
    else:
        ix = ((x + 1.0) * w - 1.0) * 0.5
        iy = ((y + 1.0) * h - 1.0) * 0.5

    def tap(iy_t, ix_t, w_t=None):
        valid = (ix_t >= 0) & (ix_t < w) & (iy_t >= 0) & (iy_t < h)
        v = image[iy_t.clamp(0, h - 1), ix_t.clamp(0, w - 1)]
        v = torch.where(valid[:, None], v, torch.zeros_like(v))
        return v if w_t is None else v * w_t[:, None]

    if mode == "nearest":
        # half-to-even rounding, as torch's nearbyint and jnp.round
        return tap(torch.round(iy).to(torch.int64), torch.round(ix).to(torch.int64))

    ix0f, iy0f = torch.floor(ix), torch.floor(iy)
    ix0, iy0 = ix0f.to(torch.int64), iy0f.to(torch.int64)
    ix1, iy1 = ix0 + 1, iy0 + 1
    wx1, wy1 = ix - ix0f, iy - iy0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    return (tap(iy0, ix0, wy0 * wx0) + tap(iy0, ix1, wy0 * wx1)
            + tap(iy1, ix0, wy1 * wx0) + tap(iy1, ix1, wy1 * wx1))


def get_tensor_values(image: torch.Tensor, points: torch.Tensor, mode: str = "nearest",
                      scale: bool = True, align_corners: bool = False) -> torch.Tensor:
    """Reference `get_tensor_values` (common.py:75-109) for an (H, W, C) image:
    points either already in [-1,1] (scale=False) or in pixel units."""
    if scale:
        h, w, _ = image.shape
        points = torch.stack([2.0 * points[:, 0] / w - 1.0,
                              2.0 * points[:, 1] / h - 1.0], dim=-1)
    return grid_sample(image, points, mode=mode, align_corners=align_corners)


def _nearest_weight(out_size: int, in_size: int) -> np.ndarray:
    """Row-selection matrix of F.interpolate mode='nearest': src = floor(dst * in/out)."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    idx = np.minimum(idx, in_size - 1)
    w = np.zeros((out_size, in_size), np.float32)
    w[np.arange(out_size), idx] = 1.0
    return w


def _bilinear_weight(out_size: int, in_size: int) -> np.ndarray:
    """Weights of F.interpolate mode='bilinear', align_corners=False:
    src = (dst + 0.5) * in/out - 0.5, edge-clamped."""
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    w = np.zeros((out_size, in_size), np.float32)
    np.add.at(w, (np.arange(out_size), lo), 1.0 - t)
    np.add.at(w, (np.arange(out_size), hi), t)
    return w


def _area_weight(out_size: int, in_size: int) -> np.ndarray:
    """Weights of F.interpolate mode='area' (adaptive average pooling): window
    [floor(i*in/out), ceil((i+1)*in/out)), uniform average."""
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        start = int(np.floor(i * in_size / out_size))
        end = int(np.ceil((i + 1) * in_size / out_size))
        w[i, start:end] = 1.0 / (end - start)
    return w


_WEIGHT_FNS = {"nearest": _nearest_weight, "bilinear": _bilinear_weight, "area": _area_weight}


@functools.lru_cache(maxsize=64)
def _weight(kind: str, out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    """The (out, in) weight matrix on `device`, built once per shape (a constant:
    callers never write to it)."""
    return torch.from_numpy(_WEIGHT_FNS[kind](out_size, in_size)).to(device)


def _resize(image: torch.Tensor, size: Tuple[int, int], kind: str) -> torch.Tensor:
    """(H, W, C) -> (h, w, C) by the two weight matrices. A scale-1 resize is the
    identity for all three kinds and is skipped."""
    h_out, w_out = size
    h_in, w_in, c = image.shape
    if (h_out, w_out) == (h_in, w_in):
        return image
    wh = _weight(kind, h_out, h_in, image.device)
    ww = _weight(kind, w_out, w_in, image.device)
    tmp = (wh @ image.reshape(h_in, w_in * c)).reshape(h_out, w_in, c)
    return torch.einsum("hwc,vw->hvc", tmp, ww)


def resize_nearest(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return _resize(image, size, "nearest")


def resize_bilinear(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return _resize(image, size, "bilinear")


def resize_area(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return _resize(image, size, "area")
