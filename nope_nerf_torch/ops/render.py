"""Volume rendering: ray generation -> stratified sampling -> MLP -> compositing.

Port of nope_nerf_tpu/ops/render.py (reference model/rendering.py:36-198,
`nope_nerf` technique). `render_nope_nerf` takes the fused route
(ops/fused_render.py) when the config allows it, as the JAX package does:
on a CUDA tensor that is the hand-written kernel, on a CPU tensor its plain
version. Configs the kernel cannot serve run the unfused plain path on the
CPU only; on CUDA they raise until a later slice of the port brings them.
`fused_train_prepare` is the train step's share of it: the geometry that
feeds the train-fused kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.camera import get_ndc_rays_fxfy, rays_from_pixels, transform_to_world
from ..models.nerf import NerfConfig, nerf_apply
from ..utils.safemath import safe_norm
from .fused_render import pack_rays, render_rays_fused

EPSILON = 1e-6  # compositing epsilon, reference model/rendering.py:9


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    num_points: int = 128            # samples per ray
    outside_steps: int = 0
    depth_range: Tuple[float, float] = (0.01, 10.0)
    white_background: bool = False
    dist_alpha: bool = False
    use_ray_dir: bool = True
    normalise_ray: bool = True
    normal_loss: bool = False
    sample_option: str = "uniform"   # 'uniform' | 'ndc'
    n_importance: int = 0            # hierarchical samples (not ported yet)

    @classmethod
    def from_cfg(cls, cfg: dict) -> "RenderConfig":
        r = cfg["rendering"]
        return cls(num_points=r["num_points"],
                   outside_steps=r["outside_steps"],
                   depth_range=tuple(r["depth_range"]),
                   white_background=r["white_background"],
                   dist_alpha=r["dist_alpha"],
                   use_ray_dir=r["use_ray_dir"],
                   normalise_ray=r["normalise_ray"],
                   normal_loss=r["normal_loss"],
                   sample_option=r["sample_option"],
                   n_importance=r.get("n_importance", 0))


def fused_eligible(rcfg: RenderConfig, ncfg: NerfConfig) -> bool:
    """Can the fused kernel render this config (ops/render.py:275-277 of the
    JAX package)? The kernel masks its ragged edge itself, so unlike the TPU
    kernel it puts no condition on the ray count."""
    fg_steps = rcfg.num_points - rcfg.outside_steps
    return (ncfg.use_pallas and rcfg.n_importance == 0 and rcfg.outside_steps == 0
            and fg_steps % 128 == 0)


@functools.lru_cache(maxsize=16)
def _linspace01(steps: int, device: torch.device) -> torch.Tensor:
    """jnp.linspace(0, 1, steps) in f32: start + i * step, the end point exact.
    Built once per device: a constant, so callers never write to it."""
    z = np.arange(steps, dtype=np.float32) * np.float32(1.0 / max(steps - 1, 1))
    z[-1] = 1.0
    return torch.from_numpy(z).to(device)


def sample_uniform(n_rays: int, steps: int, depth_range: Tuple[float, float],
                   add_noise: bool, device: torch.device,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified z values (n_rays, steps) on [near, far] (reference
    Renderer.sample_uniform, rendering.py:183-198): linspace mapped by
    near*(1-z) + far*z, then per-interval jitter between bin midpoints by
    `noise` (uniform [0,1), drawn from `generator` when not given)."""
    z = _linspace01(steps, device)
    z = depth_range[0] * (1.0 - z) + depth_range[1] * z
    z = z.expand(n_rays, steps)
    if add_noise:
        if noise is None:
            if generator is None:
                raise ValueError("add_noise needs a generator or explicit noise")
            noise = torch.rand((n_rays, steps), generator=generator,
                               device=generator.device).to(device)
        mid = 0.5 * (z[:, 1:] + z[:, :-1])
        high = torch.cat([mid, z[:, -1:]], dim=-1)
        low = torch.cat([z[:, :1], mid], dim=-1)
        z = low + (high - low) * noise
    return z


def composite(rgb: torch.Tensor, alpha: torch.Tensor, z_val: torch.Tensor):
    """Alpha compositing with the epsilon inside the cumulative product
    (reference rendering.py:124-126) -> (rgb (N,3), dist (N,), weights (N,S))."""
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + EPSILON], dim=-1),
        dim=-1)[:, :-1]
    weights = alpha * trans
    return (weights[..., None] * rgb).sum(dim=-2), (weights * z_val).sum(dim=-1), weights


def _ray_geometry(pixels: torch.Tensor, depth_prior: Optional[torch.Tensor],
                  camera_mat: torch.Tensor, world_mat: torch.Tensor,
                  scale_mat: Optional[torch.Tensor], generator: Optional[torch.Generator],
                  rcfg: RenderConfig, add_noise: bool,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Pre-MLP ray work: ray generation, prior-depth surface distance and
    masks (rendering.py:53-65), z sampling (stratified or NDC)."""
    n_rays = pixels.shape[0]
    origin, ray_vec, ray_norm = rays_from_pixels(
        pixels, camera_mat, world_mat, scale_mat, normalize=rcfg.normalise_ray)
    if depth_prior is None:
        depth_prior = torch.ones((n_rays, 1), dtype=pixels.dtype, device=pixels.device)
    points_world = transform_to_world(pixels, depth_prior, camera_mat, world_mat, scale_mat)
    d_i_src = safe_norm(points_world - origin, dim=-1)
    if not rcfg.normalise_ray:
        d_i_src = d_i_src / ray_norm
    mask_zero = d_i_src == 0.0
    mask_pred = torch.isfinite(d_i_src)
    dists = torch.where(mask_pred, d_i_src, torch.ones_like(d_i_src))
    dists = torch.where(mask_zero, torch.zeros_like(dists), dists)
    object_mask = mask_pred & ~mask_zero

    fg_steps = rcfg.num_points - rcfg.outside_steps
    ndc_o = ndc_d = None
    if rcfg.sample_option == "ndc":
        fxfy = torch.stack([camera_mat[0, 0], camera_mat[1, 1]])
        ndc_o, ndc_d = get_ndc_rays_fxfy(fxfy, 1.0, origin[None, :], ray_vec)
        z_val = _linspace01(fg_steps, pixels.device).expand(n_rays, fg_steps)
    else:
        z_val = sample_uniform(n_rays, fg_steps, rcfg.depth_range, add_noise,
                               pixels.device, generator, noise)
    return {"origin": origin, "ray_vec": ray_vec, "ray_norm": ray_norm,
            "d_i_src": d_i_src, "dists": dists, "object_mask": object_mask,
            "z_val": z_val, "ndc_o": ndc_o, "ndc_d": ndc_d}


def fused_inputs(geo: Dict[str, torch.Tensor], rcfg: RenderConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ray table (N,9), contiguous z (N,S)) for the fused render."""
    ray_vec = geo["ray_vec"]
    mlp_dir = -ray_vec if rcfg.use_ray_dir else torch.ones_like(ray_vec)
    if rcfg.sample_option == "ndc":
        table = pack_rays(geo["ndc_o"], geo["ndc_d"], mlp_dir)
    else:
        table = pack_rays(geo["origin"], ray_vec, mlp_dir)
    return table, geo["z_val"].to(torch.float32).contiguous()


def fused_train_eligible(rcfg: RenderConfig, ncfg: NerfConfig) -> bool:
    """Can the train step take the single-kernel fused loss path
    (ops/fused_render.render_ray_loss_fused)? As fused_eligible, the kernel
    masks its own ragged edge, so the JAX package's condition on the ray
    count (ops/render.py:201-208) is dropped."""
    return fused_eligible(rcfg, ncfg) and not rcfg.normal_loss


def fused_train_prepare(pixels: torch.Tensor, depth_prior: Optional[torch.Tensor],
                        camera_mat: torch.Tensor, world_mat: torch.Tensor,
                        scale_mat: Optional[torch.Tensor],
                        generator: Optional[torch.Generator], rcfg: RenderConfig,
                        add_noise: bool, noise: Optional[torch.Tensor] = None):
    """Geometry for the train-fused kernel: (ray table (N,9), z (N,S),
    depth_gt (N,) in loss space, object_mask (N,) bool): what
    render_nope_nerf would feed render_rays_fused."""
    geo = _ray_geometry(pixels, depth_prior, camera_mat, world_mat, scale_mat,
                        generator, rcfg, add_noise, noise)
    table, z = fused_inputs(geo, rcfg)
    depth_gt = geo["d_i_src"]
    if rcfg.sample_option == "ndc":
        depth_gt = 1.0 - 1.0 / depth_gt  # rendering.py:158-159
    return table, z, depth_gt, geo["object_mask"]


def _render_unfused(nerf_params, geo, rcfg: RenderConfig, ncfg: NerfConfig):
    """Plain sample -> nerf_apply -> composite path (JAX unfused branch)."""
    z_val, ray_vec = geo["z_val"], geo["ray_vec"]
    n_rays, steps = z_val.shape
    if rcfg.sample_option == "ndc":
        pts = geo["ndc_o"][:, None, :] + geo["ndc_d"][:, None, :] * z_val[..., None]
    else:
        pts = geo["origin"][None, None, :] + ray_vec[:, None, :] * z_val[..., None]
    # the MLP sees the negated ray (rendering.py:179,196)
    dirs = (-ray_vec[:, None, :]).expand(pts.shape) if rcfg.use_ray_dir \
        else torch.ones_like(pts)
    rgb, density = nerf_apply(nerf_params, pts.reshape(-1, 3), dirs.reshape(-1, 3), ncfg)
    rgb = rgb.reshape(n_rays, steps, 3)
    alpha = density.reshape(n_rays, steps)
    if rcfg.dist_alpha:
        # delta-scaled opacity with forced last-sample hit (rendering.py:116-122)
        deltas = torch.cat([z_val[:, 1:] - z_val[:, :-1],
                            torch.full_like(z_val[:, :1], 1e10)], dim=-1)
        alpha = 1.0 - torch.exp(-alpha * deltas)
        alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], dim=-1)
    rgb_values, dist_pred, weights = composite(rgb, alpha, z_val)
    return rgb_values, dist_pred, weights, alpha


def render_nope_nerf(nerf_params: Dict[str, torch.Tensor],
                     pixels: torch.Tensor,
                     depth_prior: Optional[torch.Tensor],
                     camera_mat: torch.Tensor,
                     world_mat: torch.Tensor,
                     scale_mat: Optional[torch.Tensor],
                     generator: Optional[torch.Generator],
                     rcfg: RenderConfig,
                     ncfg: NerfConfig,
                     add_noise: bool = True,
                     eval_: bool = False,
                     need_aux: bool = True,
                     noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Render N rays of one frame on the pixels' device.

    Output keys (rendering.py:160-167, masks instead of gathers): rgb (N,3),
    z_vals (N,S), alpha (N,S), weights (N,S), depth_pred (N,), depth_gt (N,),
    object_mask (N,) bool. need_aux=False skips the (N,S) weights/alpha of
    the fused route (None in the dict). `noise` pins the stratified jitter.
    Gradients flow to the nerf params and, through the ray table, to the
    camera and world matrices; on CUDA the backward is the render-backward
    kernel."""
    if rcfg.n_importance > 0:
        raise NotImplementedError("hierarchical sampling (n_importance > 0) comes with the "
                                  "point-query MLP kernels (K5/K6) in a later slice of the port")
    if rcfg.normal_loss and not eval_:
        raise NotImplementedError("the normal loss comes with the point-query MLP kernels "
                                  "(K5/K6) in a later slice of the port")
    use_fused = fused_eligible(rcfg, ncfg)
    if pixels.device.type != "cpu" and not use_fused:
        raise NotImplementedError(
            "on CUDA the port renders only through the fused kernels (use_pallas, "
            "n_importance == 0, outside_steps == 0, num_points % 128 == 0); the unfused "
            "path runs on the CPU only until the point-query MLP kernels (K5/K6) are ported")
    if rcfg.outside_steps:
        raise NotImplementedError("outside_steps > 0 is not supported")

    geo = _ray_geometry(pixels, depth_prior, camera_mat, world_mat, scale_mat,
                        generator, rcfg, add_noise, noise)
    if use_fused:
        table, z = fused_inputs(geo, rcfg)
        rgb_values, dist_pred, weights, alpha = render_rays_fused(
            nerf_params, table, z, ncfg, rcfg.dist_alpha,
            want_aux=need_aux or rcfg.white_background)
    else:
        rgb_values, dist_pred, weights, alpha = _render_unfused(nerf_params, geo, rcfg, ncfg)

    if rcfg.white_background:
        rgb_values = rgb_values + (1.0 - weights.sum(dim=-1))[:, None]

    d_i_src = geo["d_i_src"]
    if eval_ and rcfg.normalise_ray:
        # dist -> depth so predictions compare with GT depth (rendering.py:144-148)
        dist_pred = dist_pred / geo["ray_norm"]
        d_i_src = d_i_src / geo["ray_norm"]
    depth_gt = d_i_src
    if rcfg.sample_option == "ndc":
        depth_gt = 1.0 - 1.0 / depth_gt  # rendering.py:158-159
    return {
        "rgb": rgb_values,
        "z_vals": geo["z_val"],
        "alpha": alpha,
        "weights": weights,
        "depth_pred": dist_pred,
        "depth_gt": depth_gt,
        "object_mask": geo["object_mask"],
    }
