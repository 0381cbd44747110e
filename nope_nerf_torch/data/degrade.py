"""Synthetic depth-prior degradations. Copy of nope_nerf_tpu/data/degrade.py.

Product features of the reference (its "fault injection for data", SURVEY.md
§5.3): camera-LiDAR misalignment offsets and pixel-pattern sparsification. Noise and sky-removal live in llff.load_gt_depths.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def offset_depths(depths: np.ndarray, masks: np.ndarray, y_shift: int, x_shift: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Shift depth maps (N, H, W) by (y_shift, x_shift) pixels, zeroing boundaries —
    simulates camera-LiDAR misalignment (`DataField.offset_depths`,
    dataloading/dataset.py:190-213)."""
    shifted = np.zeros_like(depths)
    mask = np.ones_like(depths)

    if y_shift > 0:
        shifted[:, y_shift:, :] = depths[:, :-y_shift, :]
        mask[:, :y_shift, :] = 0
    elif y_shift < 0:
        shifted[:, :y_shift, :] = depths[:, -y_shift:, :]
        mask[:, y_shift:, :] = 0
    else:
        shifted = depths.copy()

    if x_shift > 0:
        shifted[:, :, x_shift:] = shifted[:, :, :-x_shift]
        shifted[:, :, :x_shift] = 0
        mask[:, :, :x_shift] = 0
    elif x_shift < 0:
        shifted[:, :, :x_shift] = shifted[:, :, -x_shift:]
        shifted[:, :, x_shift:] = 0
        mask[:, :, x_shift:] = 0

    new_mask = masks & (mask > 0)
    return shifted, new_mask


def sparsify_depths(depths: np.ndarray, masks: np.ndarray, pattern: List[int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Black out depths by a repeating [x_retain, x_skip, y_retain, y_skip] pixel
    pattern (`DataField.sparsify_depths`, dataset.py:215-227) — vectorized instead
    of the reference's per-pixel double loop."""
    _, H, W = depths.shape
    x_period = pattern[0] + pattern[1]
    y_period = pattern[2] + pattern[3]
    x_keep = (np.arange(W) % x_period) < pattern[0]
    y_keep = (np.arange(H) % y_period) < pattern[2]
    keep = y_keep[:, None] & x_keep[None, :]
    return depths * keep, masks & keep
