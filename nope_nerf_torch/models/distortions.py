"""Per-frame depth-prior distortion parameters (scale, shift).

Port of nope_nerf_tpu/models/distortions.py (reference model/distortions.py:4-27,
Learn_Distortion): per-camera learnable scale (init 1, clamped >= 0.01) and
shift (init 0); optionally the last frame's scale is pinned to 1 (fix_scaleN)
to remove the global gauge freedom.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .. import DeviceLike, resolve_device
from .poses import take_row

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistortionConfig:
    num_cams: int
    learn_scale: bool = True
    learn_shift: bool = True
    fix_scaleN: bool = True

    @classmethod
    def from_cfg(cls, cfg: dict, num_cams: int) -> "DistortionConfig":
        return cls(num_cams=num_cams,
                   learn_scale=cfg["distortion"]["learn_scale"],
                   learn_shift=cfg["distortion"]["learn_shift"],
                   fix_scaleN=cfg["distortion"]["fix_scaleN"])


def init_distortion_params(cfg: DistortionConfig, device: DeviceLike = None,
                           dtype: torch.dtype = torch.float32) -> Params:
    dev = resolve_device(device)
    return {"scale": torch.ones((cfg.num_cams, 1), dtype=dtype, device=dev),
            "shift": torch.zeros((cfg.num_cams, 1), dtype=dtype, device=dev)}


def distortion_scale_shift(params: Params, cam_id,
                           cfg: DistortionConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale (1,), shift (1,)) for a camera index, an integer or a
    one-element index tensor on the params' device (then the pinned last scale
    is a torch.where on it, and nothing is read back).

    The reference's `scale < 0.01 -> 0.01` replacement (distortions.py:21-22)
    cuts the gradient: a clamped scale gets none, as the constant branch of
    torch.where gives here."""
    scale = params["scale"] if cfg.learn_scale else params["scale"].detach()
    shift = params["shift"] if cfg.learn_shift else params["shift"].detach()
    s = take_row(scale, cam_id)
    s = torch.where(s < 0.01, torch.full_like(s, 0.01), s)
    if cfg.fix_scaleN:
        if torch.is_tensor(cam_id):
            s = torch.where(cam_id.reshape(()) == cfg.num_cams - 1, torch.ones_like(s), s)
        elif cam_id == cfg.num_cams - 1:
            s = torch.ones_like(s)
    return s, take_row(shift, cam_id)
