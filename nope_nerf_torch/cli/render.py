"""Novel-view rendering CLI: `python -m nope_nerf_torch.cli.render <config.yaml>`.

Port of nope_nerf_tpu/cli/render.py (reference vis/render.py): loads a
checkpoint (written by either package) and the learned poses, builds the
novel trajectory ('interp' | 'bspline' | 'sprial'/'spiral'), renders
RGB/depth/disparity per view through the fused render kernel and writes pngs
and videos under extraction/. The scene is cfg's on disk (data/fields.py,
mode "render") or one of the built-in synthetic generators.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Union

import numpy as np

from .. import DeviceLike, resolve_device

SYNTHETIC_SCENES = ("plane", "driving")


def load_scene(synthetic: Union[bool, str], cfg: Optional[dict] = None):
    """The scene `render` uses: see its `synthetic` argument; without one,
    cfg's scene on disk."""
    from ..data import DataField, SceneData, make_driving_scene, make_synthetic_scene

    if synthetic is True or synthetic == "plane":
        return SceneData.from_dict(make_synthetic_scene(n_frames=8, h=120, w=160))
    if synthetic == "driving":
        return SceneData.from_dict(make_driving_scene(n_frames=8))
    if not synthetic:
        return DataField.from_cfg(cfg, mode="render").scene
    raise ValueError(f"unknown synthetic scene {synthetic!r}; one of {SYNTHETIC_SCENES}")


def novel_trajectory(cfg: dict, scene, params) -> np.ndarray:
    """The (n, 4, 4) c2ws cfg's extract_images section asks for, around the
    learned poses in `params` (or the scene's GT poses)."""
    from ..evaluation.extract import generate_spiral_nerf, interp_poses, interp_poses_bspline
    from ..models.poses import PoseConfig, pose_c2w_all

    pcfg = PoseConfig.from_cfg(cfg, scene.n_frames) if cfg["pose"]["learn_pose"] else None
    if cfg["extract_images"]["use_learnt_poses"] and pcfg is not None:
        c2ws = pose_c2w_all(params["pose"], pcfg).detach().cpu().numpy()
    else:
        c2ws = np.asarray(scene.c2ws_gt)

    n_novel = cfg["extract_images"]["N_novel_imgs"]
    option = cfg["extract_images"]["traj_option"]
    n = len(c2ws)
    if option == "interp":
        return interp_poses(c2ws, n_novel)
    if option == "bspline":
        return interp_poses_bspline(c2ws, n_novel, np.arange(n) / max(n - 1, 1),
                                    cfg["extract_images"]["bspline_degree"])
    if option in ("sprial", "spiral"):
        h, w = scene.imgs.shape[1:3]
        hwf = np.tile(np.array([h, w, scene.K[0, 0] * w / 2], np.float32)[None, :, None],
                      (n, 1, 1))
        return generate_spiral_nerf(c2ws, np.array([0.5, 20.0], np.float32), n_novel, hwf)
    raise ValueError(f"unknown traj_option {option}")


def render(cfg: dict, synthetic: Union[bool, str] = False, device: DeviceLike = None,
           save: bool = True):
    """Render cfg's novel-view trajectory; returns the frames (see
    evaluation.extract.render_trajectory). `synthetic`: True or "plane" for
    the single-plane scene, "driving" for the V-KITTI-shaped one, False for
    cfg's scene on disk. `save=False` writes no files."""
    from ..evaluation.extract import render_trajectory
    from ..models.nerf import NerfConfig
    from ..ops.render import RenderConfig
    from ..training.checkpoints import load_params

    dev = resolve_device(device)
    scene = load_scene(synthetic, cfg)
    out_dir = cfg["training"]["out_dir"]
    extraction_dir = os.path.join(out_dir, cfg["extract_images"]["extraction_dir"])
    loaded = load_params(out_dir, cfg["extract_images"]["model_file"], device=dev)
    if loaded is None:
        raise FileNotFoundError(f"no checkpoint in {out_dir}")
    params, _ = loaded

    traj = novel_trajectory(cfg, scene, params)
    resolution = cfg["extract_images"]["resolution"] or scene.imgs.shape[1:3]
    frames = render_trajectory(params["nerf"], traj, scene.K, tuple(resolution),
                               NerfConfig.from_cfg(cfg), RenderConfig.from_cfg(cfg),
                               out_dir=extraction_dir if save else None, device=dev)
    if save:
        print(f"rendered {len(frames)} novel views to {extraction_dir}")
    return frames


def main():
    parser = argparse.ArgumentParser(description="Render novel-view trajectory")
    parser.add_argument("config", nargs="?", default=None)
    parser.add_argument("--synthetic", nargs="?", const="plane", default=None,
                        choices=SYNTHETIC_SCENES,
                        help="render a built-in synthetic scene instead of one on disk")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    args = parser.parse_args()
    from ..config import load_config
    render(load_config(args.config), synthetic=args.synthetic or False, device=args.device)


if __name__ == "__main__":
    main()
