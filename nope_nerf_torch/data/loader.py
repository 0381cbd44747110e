"""Scene container (port of SceneData, nope_nerf_tpu/data/loader.py).

The per-frame batch assembly of the JAX module comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SceneData:
    """All frames of one scene, as host numpy arrays."""
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

    @classmethod
    def from_dict(cls, d: dict) -> "SceneData":
        return cls(imgs=d["imgs"], depths=d["depths"], depth_masks=d["depth_masks"],
                   c2ws_gt=d["c2ws_gt"], K=d["K"], c2ws_init=d.get("c2ws_init"),
                   gt_depths=d.get("gt_depths"), reverse=d.get("reverse"),
                   i_train=d.get("i_train"), i_test=d.get("i_test"))
