"""The NoPe-NeRF loss family as plain functions.

Port of nope_nerf_tpu/losses.py (reference model/losses.py:17-228, Loss.forward):
RGB L1/L2, depth L1 or scale/shift-invariant, trajectory smoothness, the
bidirectional Chamfer term, photometric warp (rgb_s), depth consistency and
the transform cycle, as a weighted sum with each term gated by LossConfig.
Masked reductions are where-then-sum over full shapes, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .geometry.camera import rigid_inverse
from .ops.chamfer import chamfer_loss
from .ops.ssim import ssim_loss_map
from .utils.safemath import safe_norm


@dataclasses.dataclass(frozen=True)
class LossConfig:
    depth_loss_type: str = "l1"       # 'l1' | 'invariant'
    with_ssim: bool = False
    with_auto_mask: bool = False
    # Static enables: True if the term's annealed weight can ever be nonzero.
    use_rgb: bool = True
    use_depth: bool = True
    use_dist: bool = False
    use_pc: bool = True
    use_rgb_s: bool = True
    use_depth_consistency: bool = False
    use_t_cycle: bool = False

    @classmethod
    def from_cfg(cls, cfg: dict) -> "LossConfig":
        t = cfg["training"]

        def on(name):
            w = t[name]
            return bool(w[0] != 0.0 or w[1] != 0.0)

        return cls(
            depth_loss_type=t["depth_loss_type"],
            with_ssim=t["with_ssim"],
            with_auto_mask=t["with_auto_mask"],
            use_rgb=on("rgb_weight"),
            use_depth=on("depth_weight"),
            use_dist=on("weight_dist_1st_loss") or on("weight_dist_2nd_loss"),
            use_pc=on("pc_weight"),
            use_rgb_s=on("rgb_s_weight"),
            use_depth_consistency=on("depth_consistency_weight"),
            use_t_cycle=on("t_cycle_weight"),
        )


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(x[mask])/sum(mask), 0 when the mask is empty (`mean_on_mask`,
    losses.py:79-87). where-then-sum, not x*mask: a NaN under an invalid entry
    must not reach the loss."""
    maskb = mask.to(torch.bool)
    denom = maskb.to(x.dtype).sum()
    total = torch.where(maskb, x, torch.zeros_like(x)).sum()
    return torch.where(denom > 0, total / denom.clamp_min(1.0), torch.zeros_like(total))


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over masked entries; torch.median semantics (lower of two middles)."""
    big = torch.full_like(x, torch.finfo(x.dtype).max)
    order = torch.sort(torch.where(mask.to(torch.bool), x, big)).values
    count = int(mask.to(torch.int64).sum())
    return order[max((count - 1) // 2, 0)]


def rgb_loss(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor, loss_type: str) -> torch.Tensor:
    """sum(|d|^p) / n_rays (`get_rgb_full_loss`, losses.py:28-33)."""
    n = rgb_pred.shape[0]
    if loss_type == "l1":
        return (rgb_pred - rgb_gt).abs().sum() / n
    return ((rgb_pred - rgb_gt) ** 2).sum() / n


def depth_loss_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L1 over masked rays, normalized by the masked count (losses.py:60-63)."""
    maskb = mask.to(torch.bool)
    count = maskb.to(pred.dtype).sum()
    diff = torch.where(maskb, (pred - gt).abs(), torch.zeros_like(pred))
    return torch.where(count > 0, diff.sum() / count.clamp_min(1.0), torch.zeros_like(count))


def depth_loss_invariant(pred: torch.Tensor, gt: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Scale/shift-invariant depth loss (`depth_loss_dpt`, losses.py:35-58):
    median/MAD-normalize both, then masked MSE."""
    maskb = mask.to(torch.bool)
    m = maskb.to(pred.dtype)
    count = m.sum().clamp_min(1.0)
    pred = torch.where(maskb, pred, torch.zeros_like(pred))
    gt = torch.where(maskb, gt, torch.zeros_like(gt))
    t_pred = masked_median(pred, maskb)
    s_pred = ((pred - t_pred).abs() * m).sum() / count
    t_gt = masked_median(gt, maskb)
    s_gt = ((gt - t_gt).abs() * m).sum() / count
    pred_n = (pred - t_pred) / s_pred.clamp_min(1e-12)
    gt_n = (gt - t_gt) / s_gt.clamp_min(1e-12)
    return masked_mean((pred_n - gt_n) ** 2, maskb)


def weight_dist_loss(t_list: torch.Tensor):
    """Trajectory smoothness on camera translations (N, 3)
    (`get_weight_dist_loss`, losses.py:105-114)."""
    dist = t_list - torch.roll(t_list, 1, dims=0)
    dist = safe_norm(dist[1:], dim=1)                  # (N-1,)
    dist_diff = (dist - torch.roll(dist, 1))[1:]       # (N-2,)
    return dist.mean(), (dist_diff ** 2).mean()


def rgb_s_loss(rgb1: torch.Tensor, rgb2: torch.Tensor, valid: torch.Tensor,
               with_ssim: bool) -> torch.Tensor:
    """Photometric warp loss on an (H, W, 3) pair with (H, W, 1) validity
    (`get_rgb_s_loss`, losses.py:152-159)."""
    diff = (rgb1 - rgb2).abs().clamp(0.0, 1.0)
    if with_ssim:
        diff = 0.15 * diff + 0.85 * ssim_loss_map(rgb1, rgb2)
    return masked_mean(diff, valid.expand(diff.shape))


def _auto_mask(rgb, diff, rgb_ref_ori, valid):
    """Drop pixels where the warped reference matches worse than the unwarped one."""
    keep = diff.mean(dim=-1, keepdim=True) < (rgb - rgb_ref_ori).abs().mean(dim=-1, keepdim=True)
    return keep.to(rgb.dtype) * valid


def reprojection_loss(rgb: torch.Tensor, rgb_refs, valid_points: torch.Tensor,
                      rgb_refs_ori, with_auto_mask: bool = False) -> torch.Tensor:
    """Multi-reference photometric reprojection loss with optional auto-masking
    (`get_reprojection_loss`, losses.py:67-77)."""
    total = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    for rgb_ref, rgb_ref_ori in zip(rgb_refs, rgb_refs_ori):
        diff = (rgb - rgb_ref).abs()
        valid = _auto_mask(rgb, diff, rgb_ref_ori, valid_points) if with_auto_mask \
            else valid_points
        total = total + masked_mean(diff, valid.expand(diff.shape))
    return total / len(rgb_refs)


def dpt_reprojection_loss(rgb: torch.Tensor, rgb_refs, valid_points: torch.Tensor,
                          rgb_img_refs_ori, with_auto_mask: bool = False,
                          with_ssim: bool = False) -> torch.Tensor:
    """DPT-mode reprojection loss with clamp and optional SSIM mixing
    (`get_DPT_reprojection_loss`, losses.py:88-104)."""
    total = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    for rgb_ref, rgb_ref_ori in zip(rgb_refs, rgb_img_refs_ori):
        diff = (rgb - rgb_ref).abs().clamp(0.0, 1.0)
        valid = _auto_mask(rgb, diff, rgb_ref_ori, valid_points) if with_auto_mask \
            else valid_points
        if with_ssim:
            diff = 0.15 * diff + 0.85 * ssim_loss_map(rgb, rgb_ref)
        total = total + masked_mean(diff, valid.expand(diff.shape))
    return total / len(rgb_refs)


def depth_consistency_loss(d1_proj: torch.Tensor, d2: torch.Tensor,
                           d2_proj: Optional[torch.Tensor] = None,
                           d1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(`get_depth_consistency_loss`, losses.py:124-128): sum-L1 / N (+ symmetric)."""
    loss = (d1_proj - d2).abs().sum() / d1_proj.shape[0]
    if d2_proj is not None:
        loss = 0.5 * loss + 0.5 * (d2_proj - d1).abs().sum() / d2_proj.shape[0]
    return loss


def t_cycle_loss(rt_pred: torch.Tensor, rt_gt: torch.Tensor) -> torch.Tensor:
    """|| I - rt_gt^-1 @ rt_pred ||_F (`get_t_cycle_loss`, losses.py:161-162)."""
    eye = torch.eye(4, dtype=rt_pred.dtype, device=rt_pred.device)
    return safe_norm((eye - rigid_inverse(rt_gt) @ rt_pred).reshape(-1), dim=0)


def compute_losses(cfg: LossConfig,
                   weights: Dict[str, float],
                   rgb_pred: Optional[torch.Tensor] = None,
                   rgb_gt: Optional[torch.Tensor] = None,
                   rgb_loss_type: str = "l2",
                   depth_pred: Optional[torch.Tensor] = None,
                   depth_gt: Optional[torch.Tensor] = None,
                   depth_mask: Optional[torch.Tensor] = None,
                   t_list: Optional[torch.Tensor] = None,
                   pc_x: Optional[torch.Tensor] = None,
                   pc_y: Optional[torch.Tensor] = None,
                   rgb_pc1: Optional[torch.Tensor] = None,
                   rgb_pc1_proj: Optional[torch.Tensor] = None,
                   valid_points: Optional[torch.Tensor] = None,
                   d1_proj: Optional[torch.Tensor] = None,
                   d2: Optional[torch.Tensor] = None,
                   d2_proj: Optional[torch.Tensor] = None,
                   d1: Optional[torch.Tensor] = None,
                   rt_12: Optional[torch.Tensor] = None,
                   rt_12_gt: Optional[torch.Tensor] = None,
                   precomputed: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Weighted total + per-term dict (Loss.forward, losses.py:164-228).

    `weights` are the epoch's annealed scalars; which terms exist is static
    through LossConfig. `precomputed` carries already-reduced rgb/depth/l2
    scalars from the trainer and, on the fused route, `ray_total`: the rgb +
    depth term already weighted by the kernel that also produced its
    gradients (loss_rgb / loss_depth are then metrics without a gradient)."""
    given = (rgb_pred, pc_x, rgb_pc1, rt_12, t_list, d1_proj, *(precomputed or {}).values())
    device = next(t.device for t in given if t is not None)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    if precomputed is not None:
        l_rgb = precomputed["loss_rgb"]
        l_depth = precomputed["loss_depth"]
    else:
        l_rgb = rgb_loss(rgb_pred, rgb_gt, rgb_loss_type) if cfg.use_rgb else zero
        if cfg.use_depth:
            mask = depth_mask if depth_mask is not None \
                else torch.ones_like(depth_pred, dtype=torch.bool)
            if cfg.depth_loss_type == "l1":
                l_depth = depth_loss_l1(depth_pred, depth_gt, mask)
            else:
                l_depth = depth_loss_invariant(depth_pred, depth_gt, mask)
        else:
            l_depth = zero

    l_dist_1st, l_dist_2nd = weight_dist_loss(t_list) if cfg.use_dist else (zero, zero)
    l_pc = chamfer_loss(pc_x, pc_y) if cfg.use_pc else zero
    l_rgb_s = (rgb_s_loss(rgb_pc1, rgb_pc1_proj, valid_points, cfg.with_ssim)
               if cfg.use_rgb_s else zero)
    l_dc = (depth_consistency_loss(d1_proj, d2, d2_proj, d1)
            if cfg.use_depth_consistency else zero)
    l_cycle = t_cycle_loss(rt_12, rt_12_gt) if cfg.use_t_cycle else zero

    if precomputed is not None:
        l2_mean = precomputed["l2_mean"]
    elif cfg.use_rgb or cfg.use_depth:
        l2_mean = ((rgb_pred - rgb_gt) ** 2).mean()
    else:
        l2_mean = zero

    if precomputed is not None and "ray_total" in precomputed:
        ray_term = precomputed["ray_total"]
    else:
        ray_term = weights["rgb_weight"] * l_rgb + weights["depth_weight"] * l_depth
    total = (ray_term
             + weights["weight_dist_1st_loss"] * l_dist_1st
             + weights["weight_dist_2nd_loss"] * l_dist_2nd
             + weights["pc_weight"] * l_pc
             + weights["rgb_s_weight"] * l_rgb_s
             + weights["depth_consistency_weight"] * l_dc
             + weights["t_cycle_weight"] * l_cycle)

    return {
        "loss": total,
        "loss_rgb": l_rgb,
        "loss_depth": l_depth,
        "l2_mean": l2_mean,
        "loss_dist_1st": l_dist_1st,
        "loss_dist_2nd": l_dist_2nd,
        "loss_pc": l_pc,
        "loss_rgb_s": l_rgb_s,
        "loss_depth_consistency": l_dc,
        "loss_t_cycle": l_cycle,
    }
