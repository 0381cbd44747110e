"""Trajectory error metrics (ATE/RPE) and the metric revert.

Port of nope_nerf_tpu/evaluation/pose_eval.py: the port's own copy, numpy
and scipy on the host (reference `utils_poses/comp_ate.py:35-103` and
`evaluation/eval_poses.py:22-37`, revert_to_metric).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as ScipyRotation


def compute_ATE(gt: np.ndarray, pred: np.ndarray) -> float:
    """RMSE of translation differences (comp_ate.py:54-75)."""
    err = gt[:, :3, 3] - pred[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=1))))


def compute_ATE_v2(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, float]:
    """Rotation-compensated translation + rotation RMSE (comp_ate.py:77-103):
    err_r = R_gt @ R_pred^T; err_t = t_gt - err_r @ t_pred."""
    err_r = gt[:, :3, :3] @ np.transpose(pred[:, :3, :3], (0, 2, 1))
    err_t = gt[:, :3, 3] - np.einsum("nij,nj->ni", err_r, pred[:, :3, 3])
    ate_t = np.sqrt(np.mean(np.sum(err_t ** 2, axis=1)))
    rotvecs = ScipyRotation.from_matrix(err_r).as_rotvec()
    ate_r = np.sqrt(np.mean(np.sum(rotvecs ** 2, axis=1)))
    return float(ate_t), float(ate_r)


def compute_rpe(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, float]:
    """Relative pose error between consecutive frames (comp_ate.py:35-52)."""
    gt_rel = np.linalg.inv(gt[:-1]) @ gt[1:]
    pred_rel = np.linalg.inv(pred[:-1]) @ pred[1:]
    rel_err = np.linalg.inv(gt_rel) @ pred_rel

    trans_err = np.linalg.norm(rel_err[:, :3, 3], axis=1)
    d = 0.5 * (np.trace(rel_err[:, :3, :3], axis1=1, axis2=2) - 1.0)
    rot_err = np.arccos(np.clip(d, -1.0, 1.0))

    rpe_trans = float(np.sqrt(np.mean(trans_err ** 2)))
    rpe_rot = float(np.sqrt(np.mean(rot_err ** 2)))
    return rpe_trans, rpe_rot


def revert_to_metric(poses: np.ndarray, reverse: Dict) -> np.ndarray:
    """Undo the LLFF preprocessing chain on (N, 4, 4) c2ws so errors come out in
    metres (eval_poses.py:22-37): unscale spherify, un-spherify, un-recenter,
    un-rescale."""
    x = poses.copy().astype(np.float64)
    if reverse.get("sc_spherify") is not None:
        x[:, :3, 3] /= reverse["sc_spherify"]
        x = reverse["c2w_spherify"][0] @ x
    x = reverse["recenter"] @ x
    x[:, :3, 3] /= reverse["sc"]
    return x


def full_pose_evaluation(c2ws_est: np.ndarray, c2ws_gt: np.ndarray,
                         reverse_est: Dict = None, reverse_gt: Dict = None
                         ) -> Dict[str, float]:
    """The eval_poses pipeline (eval_poses.py:140-163): optional metric revert,
    first-pose alignment, then ATE/ATE_v2/RPE. Degrees/cm conversions match the
    reference's printed numbers (train.py:287-294)."""
    from .align import align_ate_init_pose

    if reverse_est is not None:
        c2ws_est = revert_to_metric(c2ws_est, reverse_est)
    if reverse_gt is not None:
        c2ws_gt = revert_to_metric(c2ws_gt, reverse_gt)
    aligned = align_ate_init_pose(c2ws_est, c2ws_gt)
    ate = compute_ATE(c2ws_gt, aligned)
    ate_t, ate_r = compute_ATE_v2(c2ws_gt, aligned)
    rpe_t, rpe_r = compute_rpe(c2ws_gt, aligned)
    return {
        "ate_trans": ate,
        "ate_t_v2": ate_t,
        "ate_r_v2_deg": ate_r * 180.0 / np.pi,
        "rpe_trans": rpe_t,
        "rpe_rot_deg": rpe_r * 180.0 / np.pi,
    }
