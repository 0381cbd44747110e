"""Learnable focal length parameters.

Port of nope_nerf_tpu/models/intrinsics.py (reference model/intrinsics.py:5-109,
LearnFocal): order-1 (a = f) or order-2 (a^2 = f, keeps f positive)
parametrization, optional shared fx=fy, optional init from a known focal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import torch

from .. import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FocalConfig:
    fx_only: bool = False
    order: int = 2
    learn: bool = True

    @classmethod
    def from_cfg(cls, cfg: dict) -> "FocalConfig":
        return cls(fx_only=cfg["pose"]["fx_only"],
                   order=cfg["pose"]["focal_order"],
                   learn=cfg["pose"]["update_focal"])


def init_focal_params(cfg: FocalConfig,
                      init_focal: Optional[Union[float, Sequence[float]]] = None,
                      device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> Params:
    if cfg.order not in (1, 2):
        raise ValueError("focal order must be 1 or 2")
    dev = resolve_device(device)

    def coe(f):
        f = torch.as_tensor(f, dtype=dtype, device=dev)
        return torch.sqrt(f) if cfg.order == 2 else f

    if init_focal is None:
        fx = fy = torch.ones((), dtype=dtype, device=dev)
    elif isinstance(init_focal, (list, tuple)):
        fx, fy = coe(init_focal[0]), coe(init_focal[1])
    else:
        fx = fy = coe(init_focal)

    params: Params = {"fx": fx.clone()}
    if not cfg.fx_only:
        params["fy"] = fy.clone()
    return params


def focal_fxfy(params: Params, cfg: FocalConfig) -> torch.Tensor:
    """(2,) [fx, fy] in the normalized convention (reference intrinsics.py:98-109)."""
    fx = params["fx"]
    fy = params["fx"] if cfg.fx_only else params["fy"]
    if not cfg.learn:
        fx, fy = fx.detach(), fy.detach()
    if cfg.order == 2:
        fx, fy = fx * fx, fy * fy
    return torch.stack([fx, fy])
