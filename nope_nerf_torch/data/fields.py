"""DataField: one scene, fully loaded and preprocessed into a SceneData.

Port of nope_nerf_tpu/data/fields.py, every branch of it, on the port's own
llff.py, degrade.py and image_io.py (no cv2). The depth noise is drawn from
the same np.random.RandomState(seed) in the same order, so a scene loads to
the same arrays as in the JAX package: bit-equal poses, `reverse`, depths and
masks; images equal where both read the same PNG files, within one step of
255 where they were resampled (image_io).

Capability parity with `dataloading/dataset.py:14-187` (DataField.__init__):
- LLFF COLMAP poses + GT LLFF poses with the full preprocessing chain and both
  `reverse` dicts;
- the normalized camera matrix K = [[2fx/W,0,0,0],[0,-2fy/H,0,0],[0,0,-1,0],[0,0,0,1]]
  (dataset.py:83-86), with customized_focal / focal_crop support;
- train/test split: every `sample_rate`-th image (offset sample_rate/2) is test
  (dataset.py:87-93);
- depth priors: precomputed DPT npzs OR degraded GT depths (noise / misalignment
  offset / sparsification / sky removal), plus clean GT depths for eval.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..geometry.camera import intrinsics_ndc_np
from .degrade import offset_depths, sparsify_depths
from .llff import (
    crop_factors,
    load_depths_npz,
    load_gt_depths,
    load_llff_data,
    make_c2ws_from_llff,
)
from .loader import SceneData


class DataField:
    def __init__(self, model_path: str, scene_name: List[str] = (" ",),
                 mode: str = "train", with_depth: bool = False,
                 use_DPT: bool = False, spherify: bool = False,
                 customized_poses: bool = False, customized_focal: bool = False,
                 resize_factor: Optional[int] = 2, depth_net: str = "dpt",
                 crop_size: int = 0, norm_depth: bool = False,
                 load_colmap_poses: bool = True, sample_rate: int = 8,
                 bd_factor: float = 0.75, depth_scale: float = 1.0,
                 sparsify_depth: bool = False,
                 sparsify_depth_pattern: List[int] = (1, 0, 1, 0),
                 noise_mean: float = 0.0, noise_std: float = 0.0,
                 offset_x: int = 0, offset_y: int = 0, remove_sky: bool = False,
                 seed: int = 42, **kwargs):
        load_dir = os.path.join(model_path, scene_name[0])
        self.load_dir = load_dir
        rng = np.random.RandomState(seed)
        if crop_size != 0:  # DPT priors computed on cropped images (dataset.py:56-57)
            depth_net = f"{depth_net}_{crop_size}"
        crop_ratio, focal_crop_factor = crop_factors(load_dir, crop_size)

        c2ws_colmap = None
        self.reverse_init = None
        if load_colmap_poses:
            poses, bds, imgs, img_names = load_llff_data(
                load_dir, factor=resize_factor, load_gt_llff=False,
                crop_size=crop_size)
            c2ws_colmap, H, W, focal, self.reverse_init, _ = make_c2ws_from_llff(
                poses, bds, spherify, bd_factor)
        else:
            _, _, imgs, img_names = load_llff_data(
                load_dir, factor=resize_factor, load_gt_llff=True,
                crop_size=crop_size)
            focal = None

        n, h, w, _ = imgs.shape
        if customized_focal:
            K_gt = np.load(os.path.join(load_dir, "intrinsics.npz"))["K"].astype(np.float32)
            rf = resize_factor or 1
            fx, fy = K_gt[0, 0] / rf, K_gt[1, 1] / rf
        elif load_colmap_poses:
            fx = fy = focal
        else:
            fx, fy = w, h  # no focal provided: image size default (dataset.py:77-78)
        # crop+resize zooms in: focal grows by 1/focal_crop_factor (dataset.py:79-80)
        fx, fy = fx / focal_crop_factor, fy / focal_crop_factor

        self.H, self.W, self.focal = h, w, fx
        self.K = intrinsics_ndc_np(fx, fy, w, h)

        # train/test split (dataset.py:87-93)
        ids = np.arange(n)
        i_test = ids[int(sample_rate / 2)::sample_rate]
        i_train = np.array([i for i in ids if i not in i_test])

        # GT LLFF poses (always loaded; dataset.py:108-112)
        poses_gt, bds_gt, _, _ = load_llff_data(load_dir, factor=resize_factor,
                                                load_gt_llff=True, load_imgs=False)
        c2ws_gt_llff, _, _, _, self.reverse_gt, _ = make_c2ws_from_llff(
            poses_gt, bds_gt, spherify, bd_factor)

        if customized_poses:
            c2ws = np.load(os.path.join(load_dir, "gt_poses.npz"))["poses"].astype(np.float32)
        elif load_colmap_poses:
            c2ws = c2ws_colmap
        else:
            c2ws = None

        if mode in ("train", "eval_trained", "render"):
            idx_list = i_train
        elif mode == "eval":
            idx_list = i_test
        else:  # 'all'
            idx_list = ids
        self.img_list = [img_names[i] for i in idx_list]

        imgs = imgs[idx_list]
        c2ws_gt_sel = c2ws_gt_llff[idx_list]
        c2ws_init = c2ws[idx_list] if c2ws is not None else None

        # clean GT depths for eval (sky removed only in eval mode; dataset.py:152-158)
        gt_depth = None
        if os.path.isdir(os.path.join(load_dir, "depth")):
            gt_depth, _ = load_gt_depths(self.img_list, load_dir,
                                         depth_scale=depth_scale, H=h, W=w,
                                         remove_sky=(mode == "eval"), rng=rng,
                                         crop_ratio=crop_ratio)

        # depth priors
        if not use_DPT and not with_depth:
            depths = load_depths_npz(self.img_list,
                                     os.path.join(load_dir, depth_net),
                                     H=None, W=None, norm=norm_depth)
            masks = np.ones(depths.shape, bool)
        elif with_depth:
            depths, masks = load_gt_depths(
                self.img_list, load_dir, depth_scale=depth_scale, H=h, W=w,
                reverse=self.reverse_gt, noise_mean=noise_mean, noise_std=noise_std,
                remove_sky=remove_sky, rng=rng, crop_ratio=crop_ratio)
            if offset_x or offset_y:
                depths, masks = offset_depths(depths, masks, offset_y, offset_x)
            if sparsify_depth:
                depths, masks = sparsify_depths(depths, masks,
                                                list(sparsify_depth_pattern))
        else:
            # online DPT mode: priors computed by the depth estimator at train time
            depths = np.ones((len(idx_list), h, w), np.float32)
            masks = np.ones(depths.shape, bool)

        self.scene = SceneData(
            imgs=imgs.astype(np.float32),
            depths=depths.astype(np.float32),
            depth_masks=masks,
            c2ws_gt=c2ws_gt_sel.astype(np.float32),
            K=self.K,
            c2ws_init=(None if c2ws_init is None else c2ws_init.astype(np.float32)),
            gt_depths=gt_depth,
            reverse=self.reverse_gt,
            i_train=i_train,
            i_test=i_test,
        )
        self.c2ws_colmap = (None if c2ws_colmap is None
                            else c2ws_colmap[i_train].astype(np.float32))

    @classmethod
    def from_cfg(cls, cfg: dict, mode: str = "train") -> "DataField":
        d = cfg["dataloading"]
        if not d["path"] or not d["scene"]:
            raise ValueError("dataloading.path and dataloading.scene name no scene on disk "
                             f"(path {d['path']!r}, scene {d['scene']!r})")
        return cls(
            model_path=d["path"], scene_name=d["scene"], mode=mode,
            with_depth=d["with_depth"], use_DPT=(cfg["depth"]["type"] == "DPT"),
            spherify=d["spherify"], customized_poses=d["customized_poses"],
            customized_focal=d["customized_focal"],
            resize_factor=d["resize_factor"], depth_net=d["depth_net"],
            crop_size=d["crop_size"], norm_depth=d["norm_depth"],
            load_colmap_poses=d["load_colmap_poses"], sample_rate=d["sample_rate"],
            bd_factor=d["bd_factor"], depth_scale=d["depth_scale"],
            sparsify_depth=d["sparsify_depth"],
            sparsify_depth_pattern=d["sparsify_depth_pattern"],
            noise_mean=d["noise_mean"], noise_std=d["noise_std"],
            offset_x=d["offset_x"], offset_y=d["offset_y"],
            remove_sky=d["remove_sky"],
        )
