"""Image and depth quality of rendered views.

Port of nope_nerf_tpu/evaluation/image_eval.py (reference
model/eval_images.py:17-217, Eval_Images): PSNR/SSIM, metric depth rescale
(sc ratio), [min,max]-validity masks and the tp/fn/fp/tn confusion matrix,
and the 7 aggregate depth metrics. Everything here is host numpy; SSIM runs
as a torch convolution on the CPU.

LPIPS: the VGG16 metric of evaluation/lpips.py, on the weights and the device
the eval CLI sets there (extract_images.lpips_weights); without a weight file
`lpips` is None, as in the JAX package.

The card's machine has no cv2: the depth resize to the ground truth's
resolution (cv2.INTER_NEAREST_EXACT) is data/image_io.py's index map.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.image_io import resize_nearest_exact
from ..ops.ssim import ssim as ssim_fn
from ..utils.metrics import compute_errors, mse2psnr
from .lpips import get_lpips_fn


def depth_confusion(depth_pred: np.ndarray, depth_gt: np.ndarray,
                    min_depth: float, max_depth: float
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Validity masks and the normalized confusion matrix (eval_images.py:152-163,217).
    Returns (mask, mask_rendered, conf_mat 2x2 [[tp,fn],[fp,tn]]/n)."""
    mask_rendered = (depth_pred >= min_depth) & (depth_pred <= max_depth)
    mask_gt = (depth_gt >= min_depth) & (depth_gt <= max_depth)
    mask = mask_rendered & mask_gt
    n = depth_gt.size - 1  # the reference normalizes by num_pixels[0,-1] = n-1
    conf = np.array([
        [np.sum(mask_rendered & mask_gt), np.sum(~mask_rendered & mask_gt)],
        [np.sum(mask_rendered & ~mask_gt), np.sum(~mask_rendered & ~mask_gt)],
    ], np.float64) / max(n, 1)
    return mask, mask_rendered, conf


def eval_image(rgb_pred: np.ndarray, rgb_gt: np.ndarray,
               depth_pred: Optional[np.ndarray] = None,
               depth_gt: Optional[np.ndarray] = None,
               sc: float = 1.0, min_depth: float = 0.1, max_depth: float = 20.0,
               with_lpips: bool = True) -> Dict:
    """Metrics of one rendered view against ground truth (eval_images.py:47-217
    minus the file IO). depth_pred is rescaled to metric by `sc` (the
    preprocessing-scale ratio, evaluation/eval.py:171-175) and compared inside
    the joint validity mask. "lpips" is None without LPIPS weights or with
    `with_lpips` False (see the module docstring)."""
    mse = float(np.mean((rgb_pred - rgb_gt) ** 2))
    psnr = float(mse2psnr(mse))
    ssim = float(ssim_fn(torch.from_numpy(np.ascontiguousarray(rgb_pred, np.float32)),
                         torch.from_numpy(np.ascontiguousarray(rgb_gt, np.float32))))
    lpips = None
    if with_lpips:
        fn = get_lpips_fn()
        if fn is not None:
            lpips = fn(rgb_pred.astype(np.float32), rgb_gt.astype(np.float32))
    out: Dict = {"mse": mse, "psnr": psnr, "ssim": ssim, "lpips": lpips}

    if depth_pred is not None and depth_gt is not None:
        depth_out = depth_pred * sc
        if depth_out.shape != depth_gt.shape:
            depth_out = resize_nearest_exact(depth_out, depth_gt.shape[:2])
        mask, _, conf = depth_confusion(depth_out, depth_gt, min_depth, max_depth)
        out["conf_mat"] = conf
        out["depth_out_full"] = depth_out  # metric scale, GT resolution
        out["depth_pred_masked"] = depth_out[mask]
        out["depth_gt_masked"] = depth_gt[mask]
        if mask.any():
            out["depth_errors"] = compute_errors(depth_gt[mask], depth_out[mask])
    return out


def aggregate_depth_errors(per_image: list) -> Dict[str, float]:
    """Mean of the per-view 7-tuple depth metrics (evaluation/eval.py:200-212
    computes compute_errors per view on its masked depths, then means over
    views, not over the concatenated pixels)."""
    names = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
    errs = np.array([d["depth_errors"] for d in per_image if "depth_errors" in d])
    if errs.size == 0:  # every view's validity mask was empty
        return {k: float("nan") for k in names}
    return dict(zip(names, errs.mean(axis=0)))
