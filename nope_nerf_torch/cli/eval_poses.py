"""Trajectory evaluation CLI: `python -m nope_nerf_torch.cli.eval_poses <config.yaml> --synthetic`.

Port of nope_nerf_tpu/cli/eval_poses.py (reference
evaluation/eval_poses.py:80-163): load the learned poses, revert the LLFF
preprocessing to metric units, align by the initial pose, and report ATE /
ATE_v2 / RPE into `extraction/evaluation.txt`. The trajectory figure and the
frustum export (`vis`) need cli/vis_poses.py, which is not ported yet.
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

    if vis:
        raise NotImplementedError("the trajectory figure and frustum export (vis) need "
                                  "cli/vis_poses.py, which comes with the data slice of the "
                                  "port (on-disk scenes)")
    dev = resolve_device(device)
    out_dir = cfg["training"]["out_dir"]
    extraction_dir = os.path.join(out_dir, cfg["eval_pose"]["extraction_dir"])
    os.makedirs(extraction_dir, exist_ok=True)

    scene = build_scene(cfg, synthetic)
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
    return metrics


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
