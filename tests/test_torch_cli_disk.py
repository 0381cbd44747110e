"""The port's CLIs on a scene on disk, on the CPU: cli.train for 1 epoch and
its resume, cli.eval_poses with its frustum PLY (byte for byte the JAX
package's write_frustums_ply on the same trajectories), cli.render, cli.eval
with a few pose-opt epochs, and show_pose_only; and chip_smoke.py's configs:
the yaml files as the port reads them, plus the phase's listed cuts.

The scene is a 9-frame 24x32 driving scene written by the port's
write_vkitti_scene with DPT npz priors, read through an LLFF-style config
(NDC, dist_alpha, spherify), at a tiny width (hidden 32, 8 samples, 64 rays),
as tests/test_torch_cli.py runs the synthetic scene.
"""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py keeps it on the CPU)

from nope_nerf_tpu.cli.vis_poses import write_frustums_ply as jax_write_frustums_ply
from nope_nerf_tpu.config import load_config as jax_load_config
from nope_nerf_tpu.evaluation.align import align_ate_init_pose as jax_align
from nope_nerf_tpu.evaluation.pose_eval import revert_to_metric as jax_revert

import chip_smoke
from nope_nerf_torch.cli.eval import evaluate
from nope_nerf_torch.cli.eval_poses import evaluate_poses
from nope_nerf_torch.cli.render import render
from nope_nerf_torch.cli.train import train
from nope_nerf_torch.cli.vis_poses import visualize
from nope_nerf_torch.config import load_config
from nope_nerf_torch.data import make_driving_scene, write_vkitti_scene
from nope_nerf_torch.models.poses import pose_c2w_all
from nope_nerf_torch.training import ModelConfigs, create_train_state
from nope_nerf_torch.training.checkpoints import load_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def disk_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    scene = make_driving_scene(n_frames=9, h=24, w=32, seed=0)
    dest = root / "fern"
    write_vkitti_scene(str(dest), scene, pose_noise_deg=1.0, pose_noise_trans=0.02, seed=1)
    os.makedirs(dest / "dpt")
    for i, d in enumerate(scene["depths"]):
        np.savez(dest / "dpt" / f"depth_{i:05d}.npz", pred=d[None].astype(np.float32))
    return str(root)


def _cfg(root, out_dir, **extra):
    over = {
        "model": {"hidden_dim": 32},
        "rendering": {"num_points": 8, "sample_option": "ndc", "dist_alpha": True,
                      "depth_range": [0.0, 1.0]},
        "dataloading": {"path": root, "scene": ["fern"], "resize_factor": 1},
        "training": {"n_training_points": 64, "out_dir": str(out_dir), "print_every": 0,
                     "checkpoint_every": 0, "backup_every": 0, "visualize_every": 0,
                     "vis_reprojection_every": 0, "vis_geo": False},
        "pose": {"learn_pose": True},
        "extract_images": {"N_novel_imgs": 2, "resolution": [12, 16]},
        "eval_pose": {"opt_pose_epoch": 2, "n_points": 64},
    }
    for k, v in extra.items():
        over.setdefault(k, {}).update(v)
    return load_config(overrides=over)


def test_train_resume_and_eval_chain_on_disk(disk_scene, tmp_path):
    cfg = _cfg(disk_scene, tmp_path / "a")
    state, _, scene = train(cfg, max_epochs=1, device="cpu")
    # 9 frames, every 8th from frame 4 held out: 8 train frames, one step each
    assert scene.n_frames == 8 and tuple(scene.imgs.shape[1:3]) == (24, 32)
    assert state.it == 7 and scene.c2ws_init is not None
    assert os.path.exists(tmp_path / "a" / "model.ckpt")
    state2, _, _ = train(cfg, max_epochs=2, device="cpu")    # resumes from model.ckpt
    assert state2.it == 15
    for group, d in state2.params.items():
        assert all(bool(torch.isfinite(v).all()) for v in d.values()), group

    metrics = evaluate_poses(cfg, vis=True, device="cpu")
    assert all(np.isfinite(v) for v in metrics.values())
    ply = tmp_path / "a" / "extraction" / "trajectory.ply"
    # the same trajectories through the JAX package's revert, alignment and writer
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    loaded, _ = load_checkpoint(str(tmp_path / "a"), "model.ckpt", create_train_state(0, mc, device="cpu"),
                                load_model_only=True)
    with torch.no_grad():
        learned = pose_c2w_all(loaded.params["pose"], mc.pose).numpy()
    gt = np.asarray(scene.c2ws_gt)
    gt_m = jax_revert(gt, scene.reverse)
    est_m = jax_align(jax_revert(learned, scene.reverse), gt_m)
    h, w = scene.imgs.shape[1:3]
    fx = float(scene.K[0, 0]) * w / 2.0
    fy = float(-scene.K[1, 1]) * h / 2.0
    ref = tmp_path / "jax.ply"
    jax_write_frustums_ply([gt_m, est_m], ["green", "red"], h, w, fx, fy, str(ref))
    assert ply.read_bytes() == ref.read_bytes()

    frames = render(cfg, device="cpu", save=False)
    assert len(frames) == 2 and frames[0]["rgb"].shape == (12, 16, 3)
    assert all(np.isfinite(f["rgb"]).all() for f in frames)

    summary = evaluate(cfg, device="cpu", save=False)
    assert np.isfinite(summary["mean_psnr"]) and np.isfinite(summary["mean_ssim"])
    assert os.path.exists(tmp_path / "a" / "extraction" / "evaluation.txt")

    out = visualize(cfg, device="cpu")
    assert os.path.exists(out) and os.path.exists(tmp_path / "a" / "poses_vis.ply")


def test_show_pose_only_and_colmap_init_on_disk(disk_scene, tmp_path):
    cfg = _cfg(disk_scene, tmp_path / "b", dataloading={"show_pose_only": True})
    out = train(cfg, device="cpu")
    assert out == str(tmp_path / "b" / "pose_check.png") and os.path.exists(out)
    # init_pose_type colmap takes the scene's poses_bounds.npy poses, which differ from GT
    cfg = _cfg(disk_scene, tmp_path / "c", pose={"init_pose": True, "init_pose_type": "colmap"})
    state, _, scene = train(cfg, max_epochs=1, device="cpu")
    assert not np.allclose(scene.c2ws_init, scene.c2ws_gt)
    # without COLMAP poses, an on-disk scene refuses colmap init instead of using GT
    cfg = _cfg(disk_scene, tmp_path / "d", pose={"init_pose": True, "init_pose_type": "colmap"},
               dataloading={"load_colmap_poses": False})
    with pytest.raises(ValueError, match="COLMAP"):
        train(cfg, max_epochs=1, device="cpu")


@pytest.mark.parametrize("name,path", [("fern", "configs/LLFF/fern.yaml"),
                                       ("Ballroom", "configs/Tanks/Ballroom.yaml"),
                                       ("straight_d4", "configs/V_KITTI/straight_d4.yaml")])
def test_chip_smoke_configs_equal_the_yaml_files(name, path):
    """chip_smoke.py's phase 7 reads the yaml itself (the port's load_config; the
    card's machine has no PyYAML), and its cuts go on top (chip_smoke.disk_cuts):
    the file's dict plus the listed cuts, nothing else."""
    from_yaml = jax_load_config(os.path.join(REPO, path))
    assert chip_smoke.CONFIG_FILES[name] == path
    assert chip_smoke.shipped_config(name) == load_config(os.path.join(REPO, path)) == from_yaml
    root = "/disk/root"
    cuts = chip_smoke.disk_cuts(name, root)
    cfg = chip_smoke.disk_config(name, root)
    assert cfg == jax_load_config(os.path.join(REPO, path), overrides=cuts)
    changed = {(sec, k) for sec, d in cfg.items() for k, v in d.items() if v != from_yaml[sec][k]}
    assert changed <= {(sec, k) for sec, d in cuts.items() for k in d}
    assert cfg["dataloading"]["path"] == os.path.join(
        root, os.path.basename(from_yaml["dataloading"]["path"]))
    assert cfg["dataloading"]["resize_factor"] == (1 if name == "fern" else
                                                    from_yaml["dataloading"]["resize_factor"])


def test_chip_smoke_mesh_config_is_the_file_plus_its_cuts(tmp_path):
    """Phase 10 (e) writes configs/V_KITTI/straight_d4.yaml with its cuts
    (chip_smoke.mesh_cuts) through save_config; each rank reads that file."""
    from nope_nerf_torch.config import save_config
    path = os.path.join(REPO, "configs", "V_KITTI", "straight_d4.yaml")
    from_yaml = jax_load_config(path)
    cuts = chip_smoke.mesh_cuts("/disk/root")
    written = str(tmp_path / "straight_d4_mesh.yaml")
    save_config(chip_smoke.shipped_config("straight_d4", cuts), written)
    cfg = load_config(written)
    assert cfg == jax_load_config(path, overrides=cuts) == jax_load_config(written)
    changed = {(sec, k) for sec, d in cfg.items() for k, v in d.items() if v != from_yaml[sec][k]}
    assert changed <= {(sec, k) for sec, d in cuts.items() for k in d}
    assert cfg["tpu"]["mesh_shape"] == [chip_smoke.PARALLEL_RANKS]
