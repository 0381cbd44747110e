"""Scalar metrics on host numpy values.

Port of nope_nerf_tpu/utils/metrics.py (reference model/common.py:623-694).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mse2psnr(mse: float) -> np.float32:
    """-10 log10(mse), clamped for tiny mse (common.py:623-630)."""
    mse = np.maximum(mse, 1e-10)
    return (-10.0 * np.log10(mse)).astype(np.float32)


def compute_errors(gt: np.ndarray, pred: np.ndarray
                   ) -> Tuple[float, float, float, float, float, float, float]:
    """The 7 monocular-depth error metrics (common.py:676-694):
    abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3
