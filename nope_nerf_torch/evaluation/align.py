"""Trajectory alignment: Umeyama sim(3)/SE(3)/pos-yaw, and the sim3-propagated /
first-pose alignments used before ATE.

Port of nope_nerf_tpu/evaluation/align.py: the port's own copy, pure numpy
on the host (reference `ATE/align_trajectory.py:39-99` align_umeyama,
`ATE/align_utils.py:112-140` alignTrajectory and
`utils_poses/align_traj.py:26-109`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def get_best_yaw(C: np.ndarray) -> float:
    """theta maximizing trace(Rz(theta) @ C) (align_trajectory.py:8-18)."""
    A = C[0, 1] - C[1, 0]
    B = C[0, 0] + C[1, 1]
    return np.pi / 2 - np.arctan2(B, A)


def rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def align_umeyama(model: np.ndarray, data: np.ndarray, known_scale: bool = False,
                  yaw_only: bool = False) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares s, R, t with model ~= s * R @ data + t
    (t = mu_model - s * R @ mu_data, matching how align_ate_c2b_use_a2b applies it:
    t_aligned = s * (R @ t_c) + t, align_traj.py:62)."""
    mu_M = model.mean(0)
    mu_D = data.mean(0)
    model_zc = model - mu_M
    data_zc = data - mu_D
    n = model.shape[0]

    C = (1.0 / n) * (model_zc.T @ data_zc)
    sigma2 = (1.0 / n) * (data_zc * data_zc).sum()
    U, D, Vt = np.linalg.svd(C)
    D = np.diag(D)
    V = Vt.T

    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(V) < 0:
        S[2, 2] = -1

    if yaw_only:
        rot_C = data_zc.T @ model_zc
        R = rot_z(get_best_yaw(rot_C))
    else:
        R = U @ S @ V.T

    s = 1.0 if known_scale else (1.0 / sigma2) * np.trace(D @ S)
    t = mu_M - s * (R @ mu_D)
    return s, R, t


def align_trajectory(p_es: np.ndarray, p_gt: np.ndarray, method: str = "sim3",
                     n_aligned: int = -1,
                     R_es0: Optional[np.ndarray] = None,
                     R_gt0: Optional[np.ndarray] = None
                     ) -> Tuple[float, np.ndarray, np.ndarray]:
    """s, R, t with gt = R * s * est + t (alignTrajectory, align_utils.py:112-140).

    method: 'sim3' | 'se3' | 'posyaw' | 'none'. For the single-pose se3/posyaw
    variants the first rotations are taken directly (the reference routes them
    through quaternions; same matrices either way).
    """
    idxs = np.arange(p_es.shape[0] if n_aligned == -1 else n_aligned)
    if method == "sim3":
        assert n_aligned >= 2 or n_aligned == -1, "sim3 uses at least 2 frames"
        s, R, t = align_umeyama(p_gt[idxs], p_es[idxs])
    elif method == "se3":
        if n_aligned == 1:
            R = R_gt0 @ R_es0.T
            t = p_gt[0] - R @ p_es[0]
            s = 1.0
        else:
            s, R, t = align_umeyama(p_gt[idxs], p_es[idxs], known_scale=True)
            s = 1.0
    elif method == "posyaw":
        if n_aligned == 1:
            C_R = R_es0 @ R_gt0.T
            R = rot_z(get_best_yaw(C_R))
            t = p_gt[0] - R @ p_es[0]
            s = 1.0
        else:
            s, R, t = align_umeyama(p_gt[idxs], p_es[idxs], known_scale=True,
                                    yaw_only=True)
            s = 1.0
    elif method == "none":
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    else:
        raise ValueError(f"unknown alignment method {method}")
    return float(s), np.asarray(R), np.asarray(t).reshape(3)


def align_ate_c2b_use_a2b(traj_a: np.ndarray, traj_b: np.ndarray,
                          traj_c: Optional[np.ndarray] = None) -> np.ndarray:
    """Align c to b using the sim3 estimated from a -> b (align_traj.py:26-69).
    All trajectories are (N, 4, 4) c2ws; returns (N, 4, 4)."""
    if traj_c is None:
        traj_c = traj_a.copy()
    t_a = traj_a[:, :3, 3]
    t_b = traj_b[:, :3, 3]
    s, R, t = align_trajectory(t_a, t_b, method="sim3")

    R_c = traj_c[:, :3, :3]
    t_c = traj_c[:, :3, 3:4]
    R_aligned = R[None] @ R_c
    t_aligned = s * (R[None] @ t_c) + t.reshape(1, 3, 1)
    out = np.tile(np.eye(4, dtype=traj_c.dtype), (traj_c.shape[0], 1, 1))
    out[:, :3, :3] = R_aligned
    out[:, :3, 3:] = t_aligned
    return out


def align_ate_init_pose(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Align by equating first poses: rel = gt[0] @ inv(pred[0]), applied to all
    (align_traj.py:72-82)."""
    rel = gt[0] @ np.linalg.inv(pred[0])
    return rel[None] @ pred


def pts_dist_max(pts: np.ndarray) -> float:
    """Max distance from the FIRST point to any other (the reference computes
    dist[0] of the full pairwise tensor, align_traj.py:9-24 — i.e. row 0 only)."""
    dist = np.linalg.norm(pts - pts[0], axis=1)
    return float(dist.max())


def align_scale_c2b_use_a2b(traj_a: np.ndarray, traj_b: np.ndarray,
                            traj_c: Optional[np.ndarray] = None
                            ) -> Tuple[np.ndarray, float]:
    """Scale-only alignment (align_traj.py:85-109)."""
    if traj_c is None:
        traj_c = traj_a.copy()
    scale = pts_dist_max(traj_b[:, :3, 3]) / pts_dist_max(traj_a[:, :3, 3])
    out = traj_c.copy()
    out[:, :3, 3] *= scale
    return out, float(scale)
