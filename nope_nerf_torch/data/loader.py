"""Scene container and per-frame batch assembly.

Port of nope_nerf_tpu/data/loader.py (reference dataloading/dataloading.py:13-163):
one image per step with a forward reference frame attached. Frames live as
tensors on the device, and a batch is pure indexing. The reference-frame pick
draws from numpy on the host, as the reference's `random.randint`
(dataset.py:295-301).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device


@dataclasses.dataclass
class SceneData:
    """All frames of one scene: host numpy arrays, or tensors after to_device."""
    imgs: np.ndarray          # (N, H, W, 3) float32
    depths: np.ndarray        # (N, H, W) float32 — depth priors (DPT or degraded GT)
    depth_masks: np.ndarray   # (N, H, W) bool
    c2ws_gt: np.ndarray       # (N, 4, 4) float32 — GT poses (LLFF-preprocessed)
    K: np.ndarray             # (4, 4) float32 — normalized camera matrix
    c2ws_init: Optional[np.ndarray] = None  # optional init poses (e.g. colmap)
    gt_depths: Optional[np.ndarray] = None  # clean GT depths for eval
    reverse: Optional[dict] = None          # metric-revert bookkeeping
    i_train: Optional[np.ndarray] = None
    i_test: Optional[np.ndarray] = None

    @property
    def n_frames(self) -> int:
        return self.imgs.shape[0]

    def to_device(self, device: DeviceLike = None) -> "SceneData":
        """The per-frame arrays as tensors on `device` (CUDA unless told
        otherwise), uploaded once; a batch then slices them there."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{k: torch.as_tensor(getattr(self, k)).to(dev)
                     for k in ("imgs", "depths", "depth_masks", "c2ws_gt", "K")})

    @classmethod
    def from_dict(cls, d: dict) -> "SceneData":
        return cls(imgs=d["imgs"], depths=d["depths"], depth_masks=d["depth_masks"],
                   c2ws_gt=d["c2ws_gt"], K=d["K"], c2ws_init=d.get("c2ws_init"),
                   gt_depths=d.get("gt_depths"), reverse=d.get("reverse"),
                   i_train=d.get("i_train"), i_test=d.get("i_test"))


def pick_ref_idx(idx: int, n_frames: int, random_ref: int,
                 rng: np.random.RandomState) -> int:
    """Reference-frame choice (`DataField.load_ref_img`, dataset.py:295-301):
    a random frame up to `random_ref` steps forward; the last frame looks backward."""
    if idx == n_frames - 1:
        return idx - 1
    return idx + rng.randint(1, min(random_ref, n_frames - idx - 1) + 1)


def batch_for_frame(scene: SceneData, idx: int, ref_idx: Optional[int] = None,
                    rng: Optional[np.random.RandomState] = None,
                    random_ref: int = 1) -> Dict[str, object]:
    """The per-step batch dict train_step consumes; `idx` and `ref_idx` are
    Python ints (the step branches on them)."""
    if ref_idx is None:
        rng = rng or np.random.RandomState()
        ref_idx = pick_ref_idx(idx, scene.n_frames, random_ref, rng)
    return {
        "img": scene.imgs[idx],
        "depth": scene.depths[idx],
        "depth_mask": scene.depth_masks[idx],
        "camera_mat": scene.K,
        "pose_gt": scene.c2ws_gt[idx],
        "idx": int(idx),
        "ref_img": scene.imgs[ref_idx],
        "ref_depth": scene.depths[ref_idx],
        "ref_pose_gt": scene.c2ws_gt[ref_idx],
        "ref_idx": int(ref_idx),
    }


def frame_iterator(scene: SceneData, shuffle: bool = True, random_ref: int = 1,
                   seed: int = 0) -> Iterator[Dict[str, object]]:
    """One epoch of per-frame batches (the reference's DataLoader with
    batch_size=1), in epoch_order's order with its reference picks."""
    for idx, ref in zip(*epoch_order(scene.n_frames, shuffle, random_ref, seed)):
        yield batch_for_frame(scene, int(idx), ref_idx=int(ref))


def epoch_order(n_frames: int, shuffle: bool = True, random_ref: int = 1,
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The (frame, ref-frame) index sequence of one epoch: a permutation first,
    then one reference pick per frame, the JAX package's draws."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n_frames) if shuffle else np.arange(n_frames)
    refs = np.array([pick_ref_idx(int(i), n_frames, random_ref, rng)
                     for i in order], np.int32)
    return order.astype(np.int32), refs
