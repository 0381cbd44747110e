"""Per-frame SE(3) camera pose parameters.

Port of nope_nerf_tpu/models/poses.py (reference model/poses.py:6-34, LearnPose):
per-camera axis-angle r and translation t, optionally composed on top of a
frozen init pose. Gating of learn_R/learn_t detaches the frozen part.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import DeviceLike, resolve_device
from ..geometry.lie import make_c2w

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    num_cams: int
    learn_R: bool = True
    learn_t: bool = True
    use_init_c2w: bool = False

    @classmethod
    def from_cfg(cls, cfg: dict, num_cams: int) -> "PoseConfig":
        return cls(num_cams=num_cams,
                   learn_R=cfg["pose"]["learn_R"],
                   learn_t=cfg["pose"]["learn_t"],
                   use_init_c2w=cfg["pose"]["init_pose"])


def init_pose_params(cfg: PoseConfig, init_c2w: Optional[torch.Tensor] = None,
                     device: DeviceLike = None,
                     dtype: torch.dtype = torch.float32) -> Params:
    dev = resolve_device(device)
    params: Params = {
        "r": torch.zeros((cfg.num_cams, 3), dtype=dtype, device=dev),
        "t": torch.zeros((cfg.num_cams, 3), dtype=dtype, device=dev),
    }
    if cfg.use_init_c2w:
        if init_c2w is None:
            raise ValueError("use_init_c2w=True requires init poses")
        params["init_c2w"] = torch.as_tensor(init_c2w, dtype=dtype, device=dev)
    return params


def _gated(params: Params, cfg: PoseConfig):
    r = params["r"] if cfg.learn_R else params["r"].detach()
    t = params["t"] if cfg.learn_t else params["t"].detach()
    return r, t


def pose_c2w(params: Params, cam_id: int, cfg: PoseConfig) -> torch.Tensor:
    """c2w (4, 4) for one camera index (reference poses.py:23-31)."""
    r, t = _gated(params, cfg)
    c2w = make_c2w(r[cam_id], t[cam_id])
    if cfg.use_init_c2w:
        c2w = c2w @ params["init_c2w"].detach()[cam_id]
    return c2w


def pose_c2w_all(params: Params, cfg: PoseConfig) -> torch.Tensor:
    """All N c2ws as (N, 4, 4)."""
    r, t = _gated(params, cfg)
    c2ws = make_c2w(r, t)
    if cfg.use_init_c2w:
        c2ws = c2ws @ params["init_c2w"].detach()
    return c2ws


def pose_translations(params: Params, cfg: PoseConfig) -> torch.Tensor:
    """The raw t parameters (N, 3) of the trajectory-smoothness loss
    (reference `LearnPose.get_t`, poses.py:32-34)."""
    return _gated(params, cfg)[1]
