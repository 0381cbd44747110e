"""Trajectory evaluation CLI: `python -m nope_nerf_torch.cli.eval_poses <config.yaml> [--synthetic] [--vis]`.

Port of nope_nerf_tpu/cli/eval_poses.py (reference
evaluation/eval_poses.py:80-163): load the learned poses, revert the LLFF
preprocessing to metric units, align by the initial pose, and report ATE /
ATE_v2 / RPE into `extraction/evaluation.txt`. With `vis`, the metric GT and
aligned learned trajectories go to `extraction/trajectory.ply` as frustums
(cli/vis_poses.py, numpy) and, where matplotlib is installed, to
`extraction/trajectory.png`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import DeviceLike, resolve_device


def evaluate_poses(cfg: dict, vis: bool = False, synthetic: bool = False,
                   device: DeviceLike = None):
    """ATE/RPE of cfg's checkpoint against the scene's poses; returns the
    metrics dict. Without learned poses the scene's own are compared, and
    every error is 0."""
    from ..evaluation.pose_eval import full_pose_evaluation
    from ..models.poses import pose_c2w_all
    from ..training import ModelConfigs, create_train_state
    from ..training.checkpoints import load_checkpoint
    from .train import build_scene

    dev = resolve_device(device)
    out_dir = cfg["training"]["out_dir"]
    extraction_dir = os.path.join(out_dir, cfg["eval_pose"]["extraction_dir"])
    os.makedirs(extraction_dir, exist_ok=True)

    scene = build_scene(cfg, synthetic, mode="train")
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    state = create_train_state(
        0, mc, init_c2w=torch.as_tensor(scene.c2ws_gt) if cfg["pose"]["init_pose"] else None,
        device=dev)
    loaded = load_checkpoint(out_dir, cfg["training"]["load_dir"], state, load_model_only=True)
    if loaded is None:
        raise FileNotFoundError(f"no checkpoint in {out_dir}")
    state, _ = loaded

    gt = np.asarray(scene.c2ws_gt)
    if mc.pose is not None:
        with torch.no_grad():
            learned = pose_c2w_all(state.params["pose"], mc.pose).cpu().numpy()
    else:
        learned = gt
    metrics = full_pose_evaluation(learned, gt, reverse_est=scene.reverse,
                                   reverse_gt=scene.reverse)
    line = (f"ATE_t: {metrics['ate_trans']:.6f} m, "
            f"ATE_t_v2: {metrics['ate_t_v2']:.6f} m, "
            f"ATE_r_v2: {metrics['ate_r_v2_deg']:.4f} deg, "
            f"RPE_t: {metrics['rpe_trans'] * 100:.4f} cm, "
            f"RPE_r: {metrics['rpe_rot_deg']:.4f} deg")
    print(line)
    with open(os.path.join(extraction_dir, "evaluation.txt"), "a") as f:
        f.write(line + "\n")
    if vis:
        write_trajectory(extraction_dir, learned, gt, scene)
    return metrics


def write_trajectory(extraction_dir: str, learned: np.ndarray, gt: np.ndarray, scene) -> str:
    """The metric GT and learned trajectories, the learned one aligned by its
    initial pose: frustums to trajectory.ply and, with matplotlib, the figure
    trajectory.png. Returns the PLY's path."""
    from ..evaluation.align import align_ate_init_pose
    from ..evaluation.pose_eval import revert_to_metric
    from .vis_poses import write_frustums_ply

    est_m = revert_to_metric(learned, scene.reverse) if scene.reverse else learned
    gt_m = revert_to_metric(gt, scene.reverse) if scene.reverse else gt
    est_m = align_ate_init_pose(est_m, gt_m)
    h_img, w_img = scene.imgs.shape[1:3]
    fx = float(scene.K[0, 0]) * w_img / 2.0
    fy = float(-scene.K[1, 1]) * h_img / 2.0
    ply = write_frustums_ply([gt_m, est_m], ["green", "red"], h_img, w_img, fx, fy,
                             os.path.join(extraction_dir, "trajectory.ply"))
    try:
        import matplotlib
    except ImportError:
        print(f"saved {ply} (no matplotlib: no trajectory.png)")
        return ply
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(*gt_m[:, :3, 3].T, "g-o", ms=2, label="GT")
    ax.plot(*est_m[:, :3, 3].T, "r-o", ms=2, label="learned")
    ax.legend()
    fig.savefig(os.path.join(extraction_dir, "trajectory.png"), dpi=150)
    plt.close(fig)
    print(f"saved {extraction_dir}/trajectory.png and {ply}")
    return ply


def main():
    parser = argparse.ArgumentParser(description="Evaluate learned camera poses")
    parser.add_argument("config", nargs="?", default=None)
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    args = parser.parse_args()
    from ..config import load_config
    evaluate_poses(load_config(args.config), vis=args.vis, synthetic=args.synthetic,
                   device=args.device)


if __name__ == "__main__":
    main()
