"""Config system: a two-level YAML merge over a complete in-code default schema.

Copy of nope_nerf_tpu/config.py (the port keeps its own). PyYAML is imported
only where a yaml file is read or written, so configs built in code need no
yaml at all. Without PyYAML, `load_config` still reads a yaml in the flow form
that is also JSON, as cli/get_vkitti.py writes its configs there.

Capability parity with the reference's `dataloading/configloading.py:3-47` (scene yaml
recursively merged over `configs/default.yaml`), except the default option surface lives
in code (DEFAULTS below) so the framework is importable without a config directory; an
on-disk default yaml can still be layered in between.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Optional

# The full option surface, mirroring the semantics of the reference's
# configs/default.yaml:1-158 (keys kept name-compatible so reference users can port
# their scene yamls unchanged). TPU-specific additions live under the `tpu` section.
DEFAULTS: Dict[str, Any] = {
    "model": {
        "num_layers": 8,
        "freeze_network": False,
        "network_type": "official",
        "occ_activation": "softplus",
        "hidden_dim": 256,
        "pos_enc_levels": 10,
        "dir_enc_levels": 4,
    },
    "dataloading": {
        "dataset_name": "any",
        "path": None,
        "scene": [],
        "batchsize": 1,
        "n_workers": 1,
        "img_size": None,
        "with_depth": False,
        "depth_scale": 1,  # conversion factor between pixel values and metres
        "sparsify_depth": False,
        "sparsify_depth_pattern": [1, 0, 1, 0],  # [x_retain, x_skip, y_retain, y_skip]
        "noise_mean": 0,  # additive gaussian noise to depths (m)
        "noise_std": 0,
        "offset_x": 0,  # misalignment offset (pixels)
        "offset_y": 0,
        "remove_sky": False,  # set depths of sky pixels to 0 (invalid)
        "with_mask": False,
        "spherify": True,
        "customized_poses": False,  # use poses other than colmap
        "customized_focal": False,  # use focal other than colmap
        "resize_factor": None,
        "depth_net": "dpt",
        "crop_size": 0,
        "random_ref": 1,
        "norm_depth": False,
        "load_colmap_poses": True,
        "shuffle": True,
        "sample_rate": 8,
        "bd_factor": 0.75,
        "show_pose_only": False,
    },
    "rendering": {
        "type": "nope_nerf",
        "n_max_network_queries": 64000,
        "white_background": False,
        "radius": 4.0,
        "num_points": 128,
        "depth_range": [0.01, 10],
        "dist_alpha": False,
        "use_ray_dir": True,
        "normalise_ray": True,
        "normal_loss": False,
        "sample_option": "uniform",
        "outside_steps": 0,
        # TPU-build extension: hierarchical importance samples per ray (0 = off,
        # reference parity)
        "n_importance": 0,
        # TPU-build extension: occupancy-grid guided sampling (ops/occupancy.py).
        # Redistributes the fixed per-ray sample budget toward occupied cells;
        # off by default (reference parity).
        "occupancy_grid": False,
        "occupancy_res": 64,
        "occupancy_decay": 0.95,
        "occupancy_floor": 0.01,
        "occupancy_update_every": 1,  # epochs between EMA grid updates
    },
    "depth": {
        "type": None,
        "path": "weights/dpt_hybrid.npz",
        "non_negative": True,
        "scale": 0.000305,
        "shift": 0.1378,
        "invert": True,
        "freeze": True,
    },
    "pose": {
        "learn_pose": True,
        "learn_R": True,
        "learn_t": True,
        "init_pose": False,
        "init_R_only": False,
        "learn_focal": False,
        "update_focal": True,
        "fx_only": False,
        "focal_order": 2,
        "init_pose_type": "gt",
        "init_focal_type": "gt",
    },
    "distortion": {
        "learn_distortion": True,
        "fix_scaleN": True,
        "learn_scale": True,
        "learn_shift": True,
    },
    "training": {
        "type": "nope_nerf",
        "out_dir": "out/default",
        "load_dir": "model.ckpt",
        "load_pose_dir": "model_pose.ckpt",
        "load_focal_dir": "model_focal.ckpt",
        "load_distortion_dir": "model_distortion.ckpt",
        "n_training_points": 1024,
        "scheduling_epoch": 10000,
        "batch_size": 1,
        "learning_rate": 0.001,
        "focal_lr": 0.001,
        "pose_lr": 0.0005,
        "distortion_lr": 0.0005,
        "weight_decay": 0.0,
        "scheduler_gamma_pose": 0.9,
        "scheduler_gamma": 0.9954,
        "scheduler_gamma_distortion": 0.9,
        "scheduler_gamma_focal": 0.9,
        "validate_every": -1,
        "visualize_every": 10000,
        "eval_pose_every": 1,  # epoch
        "eval_img_every": 1,  # epoch
        "print_every": 100,
        "backup_every": 10000,
        "checkpoint_every": 5000,
        "rgb_weight": [1.0, 1.0],
        "depth_weight": [0.04, 0.0],
        "weight_dist_2nd_loss": [0.0, 0.0],
        "weight_dist_1st_loss": [0.0, 0.0],
        "pc_weight": [1.0, 0.0],
        "rgb_s_weight": [1.0, 0.0],
        "depth_consistency_weight": [0.0, 0.0],
        "t_cycle_weight": [0.0, 0.0],
        "rgb_loss_type": "l1",
        "depth_loss_type": "l1",
        "log_scale_shift_per_view": False,
        "with_auto_mask": False,
        "vis_geo": True,
        "vis_resolution": [54, 96],
        "mode": "train",
        "with_ssim": False,
        "use_gt_depth": False,
        "load_ckpt_model_only": False,
        "optim": "Adam",
        "detach_gt_depth": False,
        "match_method": "dense",
        "pc_ratio": 4,
        "shift_first": False,
        "detach_ref_img": True,
        "scheduling_start": 10000,
        "auto_scheduler": True,
        "length_smooth": 1000,
        "patient": 30,
        "scale_pcs": True,
        "detach_rgbs_scale": False,
        "scheduling_mode": None,
        "vis_reprojection_every": 5000,
        "nearest_limit": 0.01,
        "annealing_epochs": 2000,
    },
    "extract_images": {
        "extraction_dir": "extraction",
        "N_novel_imgs": 120,
        "traj_option": "bspline",
        "use_learnt_poses": True,
        "use_learnt_focal": True,
        "resolution": None,
        "model_file": "model.ckpt",
        "model_file_pose": "model_pose.ckpt",
        "model_file_focal": "model_focal.ckpt",
        "eval_depth": False,
        "bspline_degree": 100,
        # Path to LPIPS weights (.npz from evaluation.lpips.convert_torch_lpips,
        # or a merged torch state dict). None -> lpips reported as None.
        "lpips_weights": None,
    },
    "eval_pose": {
        "n_points": 1024,
        "type": "nope_nerf",
        "type_to_eval": "eval",
        "opt_pose_epoch": 1000,
        "extraction_dir": "extraction",
        "init_method": "pre",
        "opt_eval_lr": 0.001,
        "depth_range": [0.1, 50],
    },
    # TPU-native knobs (no reference counterpart; see SURVEY.md §2.9).
    "tpu": {
        "mesh_shape": None,  # e.g. [8] — None = all local devices on axis 'data'
        "mesh_axes": ["data"],
        "param_dtype": "float32",
        "compute_dtype": "bfloat16",  # MLP matmul operand dtype; 'float32' for exact reference parity
        "use_pallas_renderer": True,
        "use_pallas_chamfer": False,  # scan path measured equally fast on v5e
        "scan_steps": True,  # cli.train: an epoch per Trainer.run_steps, else per-step Trainer.step
        "donate_state": True,
        "profile_dir": None,
        "seed": 42,
    },
}


def update_recursive(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> None:
    """In-place recursive dict merge: dict2's entries override/extend dict1's.

    Same merge semantics as the reference (`dataloading/configloading.py:33-47`).
    """
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {} if isinstance(v, dict) else None
        if isinstance(v, dict):
            if not isinstance(dict1[k], dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def _parse_yaml(text: str, path: str) -> Any:
    """A yaml document through PyYAML, or without it, JSON (YAML's flow form)."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ImportError(f"{path}: PyYAML is not installed, and without it only configs "
                              "in JSON form (as cli.get_vkitti writes them there) are "
                              "read") from e
    return yaml.safe_load(text)


def load_config(path: Optional[str] = None,
                default_path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Load a scene yaml merged over (optional) default yaml merged over DEFAULTS.

    Args:
        path: scene-specific yaml (highest precedence before `overrides`).
        default_path: optional on-disk default yaml layered over the in-code DEFAULTS.
        overrides: a final dict merged on top (CLI-style overrides).
    """
    cfg = copy.deepcopy(DEFAULTS)
    for p in (default_path, path):
        if p is None:
            continue
        if not os.path.exists(p):
            raise FileNotFoundError(f"config file not found: {p}")
        with open(p, "r") as f:
            loaded = _parse_yaml(f.read(), p) or {}
        update_recursive(cfg, loaded)
    if overrides:
        update_recursive(cfg, overrides)
    return cfg


def save_config(cfg: Dict[str, Any], path: str) -> None:
    import yaml
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
