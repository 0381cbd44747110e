"""The port's scene loading (nope_nerf_torch/data: llff.py, degrade.py,
fields.py, the V-KITTI writer) against nope_nerf_tpu.data on the CPU.

Poses are numpy in both packages, in the same dtypes: bit-equal. A scene on
disk is written once by each package's write_vkitti_scene (the same pixels),
then loaded by each package's DataField from its own copy: the minified and
cropped image caches are keyed by directory name alone, so a cache written by
one package would be read by the other. Every SceneData array and `reverse`
is then equal, the images within one step of 255 where they were resampled
(the port's resamplers round in float64, cv2's in fixed point; see
tests/test_torch_image_io.py) and exactly equal where both read the same PNG.
"""

import copy
import os
import shutil

import numpy as np
import pytest

import nope_nerf_tpu.data as J
from nope_nerf_tpu.data import degrade as jdegrade
from nope_nerf_tpu.data import llff as jllff

import nope_nerf_torch.data as T
from nope_nerf_torch.config import load_config
from nope_nerf_torch.data import degrade as tdegrade
from nope_nerf_torch.data import llff as tllff

FIELDS = ("imgs", "depths", "depth_masks", "c2ws_gt", "c2ws_init", "K", "gt_depths",
          "i_train", "i_test")


def _poses(seed, n=7):
    """An LLFF (3, 5, N) stack around a forward-facing rig, and its bounds."""
    rng = np.random.default_rng(seed)
    scene = T.make_driving_scene(n_frames=n, h=24, w=32, seed=seed)
    rows = np.stack([T.synthetic._c2w_to_llff_row(c, 24, 32, 30.0, 1.0 + rng.random(),
                                                  50.0 + rng.random())
                     for c in scene["c2ws_gt"]])
    return rows[:, :-2].reshape(-1, 3, 5).transpose(1, 2, 0), rows[:, -2:].T


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_preprocessing_is_bit_equal(seed):
    poses, bds = _poses(seed)
    p34 = np.moveaxis(poses, -1, 0).astype(np.float32)
    for a, b in zip(jllff.recenter_poses(p34), tllff.recenter_poses(p34)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jllff.spherify_poses(p34, bds.T), tllff.spherify_poses(p34, bds.T)):
        np.testing.assert_array_equal(a, b)
    for spherify in (False, True):
        ja = jllff.make_c2ws_from_llff(poses, bds, spherify)
        ta = tllff.make_c2ws_from_llff(poses, bds, spherify)
        for a, b in zip(ja[:4] + ja[5:], ta[:4] + ta[5:]):
            np.testing.assert_array_equal(a, b)
        assert ja[4].keys() == ta[4].keys()
        for k in ja[4]:
            np.testing.assert_array_equal(ja[4][k], ta[4][k])


@pytest.mark.parametrize("y,x", [(2, 3), (-1, -4), (0, 2), (3, 0)])
def test_offset_and_sparsify_are_exact(y, x):
    rng = np.random.default_rng(abs(y * 7 + x))
    d = rng.uniform(0, 5, size=(3, 11, 13)).astype(np.float32)
    m = rng.random((3, 11, 13)) > 0.2
    for a, b in zip(jdegrade.offset_depths(d, m, y, x), tdegrade.offset_depths(d, m, y, x)):
        np.testing.assert_array_equal(a, b)
    pattern = [1, abs(x), 2, abs(y)]
    for a, b in zip(jdegrade.sparsify_depths(d, m, pattern), tdegrade.sparsify_depths(d, m, pattern)):
        np.testing.assert_array_equal(a, b)


# three configurations as the shipped yamls set them, on a 10-frame 60x200 scene
CONFIGS = {
    # configs/LLFF/fern.yaml: spherify (default), COLMAP focal, DPT npz priors, minified
    "llff": {"dataloading": {"scene": ["fern"], "resize_factor": 2}},
    # configs/Tanks/*.yaml: spherify, customized_focal false, DPT npz priors, full size
    "tanks": {"dataloading": {"scene": ["Ballroom"], "customized_focal": False}},
    # configs/V_KITTI/straight_d4.yaml and its degradations, plus noise, offset,
    # sky removal and a border crop
    "vkitti": {"dataloading": {
        "scene": ["straight"], "resize_factor": 2, "customized_focal": True,
        "load_colmap_poses": True, "with_depth": True, "depth_scale": 0.06,
        "sparsify_depth": True, "sparsify_depth_pattern": [1, 3, 1, 3], "spherify": False,
        "noise_std": 0.05, "offset_x": 2, "offset_y": -1, "remove_sky": True,
        "crop_size": 4}},
}
H, W, N_FRAMES = 60, 200, 10


def _write(pkg, dest, name, cfg_over):
    scene = T.make_driving_scene(n_frames=N_FRAMES, h=H, w=W, seed=3)
    d = os.path.join(dest, name)
    pkg.write_vkitti_scene(d, scene, pose_noise_deg=1.0, pose_noise_trans=0.05, seed=5)
    if not cfg_over["dataloading"].get("with_depth"):
        rf = cfg_over["dataloading"].get("resize_factor") or 1
        os.makedirs(os.path.join(d, "dpt"))
        for i, depth in enumerate(scene["depths"]):
            pred = (1.0 / depth[::rf, ::rf]).astype(np.float32)[None]
            np.savez(os.path.join(d, "dpt", f"depth_{i:05d}.npz"), pred=pred)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_datafield_matches_jax(tmp_path, kind, writer):
    over = copy.deepcopy(CONFIGS[kind])
    name = over["dataloading"]["scene"][0]
    _write(J if writer == "jax" else T, str(tmp_path / "src"), name, over)
    shutil.copytree(tmp_path / "src", tmp_path / "jax")
    shutil.copytree(tmp_path / "src", tmp_path / "torch")
    resampled = (over["dataloading"].get("resize_factor") or 1) != 1
    for mode in ("train", "eval"):
        scenes = {}
        for pkg, mod in (("jax", J), ("torch", T)):
            o = copy.deepcopy(over)
            o["dataloading"]["path"] = str(tmp_path / pkg)
            o["dataloading"]["sample_rate"] = 4
            scenes[pkg] = mod.DataField.from_cfg(load_config(overrides=o), mode=mode).scene
        a, b = scenes["jax"], scenes["torch"]
        assert a.imgs.shape == b.imgs.shape
        for k in FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is None:
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, k
            if k == "imgs" and resampled:
                assert np.abs(x - y).max() <= 1.0 / 255 + 1e-7
                # measured: the minification alone moves no value (cv2's 2x2 box
                # rounds ties up, as the port does); the border crop's bilinear
                # resize moves about 12% of them by one step (cv2's fixed point)
                share = 0.2 if over["dataloading"].get("crop_size") else 1e-3
                assert (x != y).mean() < share, (x != y).mean()
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{kind} {mode} {k}")
        assert a.reverse.keys() == b.reverse.keys()
        for k in a.reverse:
            np.testing.assert_array_equal(a.reverse[k], b.reverse[k])
    if kind == "vkitti":
        # the degradations left something to check: sky removed, depths sparse
        assert (b.depth_masks.mean() < 0.25) and b.gt_depths.min() == 0.0


def test_writer_writes_the_same_scene(tmp_path):
    scene = T.make_driving_scene(n_frames=3, h=20, w=30, seed=1)
    J.write_vkitti_scene(str(tmp_path / "j"), scene, pose_noise_deg=2.0, seed=4)
    T.write_vkitti_scene(str(tmp_path / "t"), scene, pose_noise_deg=2.0, seed=4)
    import cv2
    for sub in ("images", "depth"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub))
        for f in names:
            np.testing.assert_array_equal(cv2.imread(str(tmp_path / "j" / sub / f), -1),
                                          cv2.imread(str(tmp_path / "t" / sub / f), -1))
    for f in ("poses_gt.npy", "poses_bounds.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "j" / f), np.load(tmp_path / "t" / f))
    np.testing.assert_array_equal(np.load(tmp_path / "j" / "intrinsics.npz")["K"],
                                  np.load(tmp_path / "t" / "intrinsics.npz")["K"])
