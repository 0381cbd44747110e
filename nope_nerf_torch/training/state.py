"""TrainState: every learnable group, its Adam moments, and the step's RNG.

Port of nope_nerf_tpu/training/state.py. The reference spreads this across
four nn.Modules and four torch Adam optimizers (train.py:59-154); here it is
one object of plain tensors by group, as in the JAX package. Learning rates
are inputs of the step (the host retunes them every epoch), so Adam is
written out here: `torch.optim.Adam` bakes the rate in. Its step count, rate
and bias corrections live on the device, so a step reads nothing back and can
be captured in a CUDA graph (training/graphs.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import DeviceLike, resolve_device
from ..losses import LossConfig
from ..models.distortions import DistortionConfig, init_distortion_params
from ..models.intrinsics import FocalConfig, init_focal_params
from ..models.nerf import NerfConfig, init_nerf_params
from ..models.poses import PoseConfig, init_pose_params
from ..ops.render import RenderConfig

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

Group = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelConfigs:
    """All static model/render/loss configuration of a train step. The JAX
    package's Chamfer tiling and kernel switch have no counterpart: on the card
    one hand-written kernel serves every cloud the step produces."""
    nerf: NerfConfig
    render: RenderConfig
    loss: LossConfig
    pose: Optional[PoseConfig]
    focal: Optional[FocalConfig]
    distortion: Optional[DistortionConfig]
    n_training_points: int = 1024
    pc_ratio: int = 4
    nearest_limit: float = 0.01
    shift_first: bool = False
    detach_ref_img: bool = True
    detach_gt_depth: bool = False
    detach_rgbs_scale: bool = False
    scale_pcs: bool = True
    use_sparse_depth_resample: bool = False  # GT-depth mode: the batch holds >= 1 valid ray
    weight_decay: float = 0.0
    stratified_noise: bool = True  # per-interval jitter during training renders

    @classmethod
    def from_cfg(cls, cfg: dict, num_cams: int) -> "ModelConfigs":
        t = cfg["training"]
        return cls(
            nerf=NerfConfig.from_cfg(cfg),
            render=RenderConfig.from_cfg(cfg),
            loss=LossConfig.from_cfg(cfg),
            pose=PoseConfig.from_cfg(cfg, num_cams) if cfg["pose"]["learn_pose"] else None,
            focal=FocalConfig.from_cfg(cfg) if cfg["pose"]["learn_focal"] else None,
            distortion=(DistortionConfig.from_cfg(cfg, num_cams)
                        if cfg["distortion"]["learn_distortion"] else None),
            n_training_points=t["n_training_points"],
            pc_ratio=t["pc_ratio"],
            nearest_limit=t["nearest_limit"],
            shift_first=t["shift_first"],
            detach_ref_img=t["detach_ref_img"],
            detach_gt_depth=t["detach_gt_depth"],
            detach_rgbs_scale=t["detach_rgbs_scale"],
            scale_pcs=t["scale_pcs"],
            use_sparse_depth_resample=cfg["dataloading"]["with_depth"],
            weight_decay=t["weight_decay"],
        )


@dataclasses.dataclass
class AdamState:
    """First and second moments shaped like the group, and the step count
    (optax.ScaleByAdamState): a 0-d int64 tensor beside the moments, which
    adam_step increments in place. A number given as the count becomes one."""
    mu: Group
    nu: Group
    count: torch.Tensor = 0

    def __post_init__(self):
        if not torch.is_tensor(self.count):
            dev = next(iter(self.mu.values())).device if self.mu else None
            self.count = torch.full((), int(self.count), dtype=torch.int64, device=dev)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Group]          # {'nerf': ..., 'pose': ..., 'focal': ..., 'distortion': ...}
    opt_state: Dict[str, AdamState]   # one per group
    it: int                           # iteration counter
    generator: torch.Generator        # ray draws and stratified jitter, on the params' device


def init_adam(group: Group) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in group.items()},
                     nu={k: torch.zeros_like(v) for k, v in group.items()})


@torch.no_grad()
def adam_step(group: Group, grads: Group, opt: AdamState, lr,
              weight_decay: float = 0.0) -> None:
    """One Adam update of `group`, in place: L2 decay added to the gradient
    before the moments (torch.optim.Adam semantics), bias correction as
    optax.scale_by_adam (eps outside the square root of the corrected second
    moment), then p -= lr * update.

    `lr` is a number or a 0-d tensor. Nothing is read back: the count is
    incremented on the device, and the two bias-correction factors are formed
    there in float64 and cast to float32, the value Python's double arithmetic
    cast to float32 gave when the count was a host integer."""
    names = sorted(group)
    p = [group[k] for k in names]
    g = [grads[k] for k in names]
    if weight_decay:
        g = torch._foreach_add(g, p, alpha=weight_decay)
    mu = [opt.mu[k] for k in names]
    nu = [opt.nu[k] for k in names]
    opt.count.add_(1)
    count = opt.count.to(torch.float64)
    rate = torch.as_tensor(lr, dtype=torch.float64, device=opt.count.device)
    second = (1.0 - torch.pow(ADAM_B2, count)).to(torch.float32)
    step = (-rate / (1.0 - torch.pow(ADAM_B1, count))).to(torch.float32)
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
    denom = torch._foreach_div(nu, second)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    update = torch._foreach_div(mu, denom)
    torch._foreach_mul_(update, step)
    torch._foreach_add_(p, update)


def create_train_state(seed: int, mc: ModelConfigs, init_c2w=None, init_focal=None,
                       device: DeviceLike = None) -> TrainState:
    """Seeded initial state on `device` (CUDA unless told otherwise). The
    numbers differ from jax.random's; tests share a state through
    convert.state_from_numpy instead."""
    dev = resolve_device(device)
    params: Dict[str, Group] = {
        "nerf": init_nerf_params(mc.nerf, torch.Generator().manual_seed(seed), device=dev)}
    if mc.pose is not None:
        params["pose"] = init_pose_params(mc.pose, init_c2w=init_c2w, device=dev)
    if mc.focal is not None:
        params["focal"] = init_focal_params(mc.focal, init_focal=init_focal, device=dev)
    if mc.distortion is not None:
        params["distortion"] = init_distortion_params(mc.distortion, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(params=params, opt_state={g: init_adam(params[g]) for g in params},
                      it=-1, generator=generator)
