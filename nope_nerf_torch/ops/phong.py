"""Phong geometry view: sphere-bounded ray marching, secant refinement of the
first surface crossing and Lambertian shading.

Port of nope_nerf_tpu/ops/phong.py (reference `Renderer.phong_renderer`,
model/rendering.py:203-275, `ray_marching` :278-387, `secant` :389-419,
`get_sphere_intersection` :440-459). The reference's masked gathers are
static-shape masked computation, as in the JAX package; its fori_loop of
secant steps is a Python loop. The density queries, the normals
(nerf_gradient) and the surface colour (nerf_apply) are the model's plain
functions on the tensors' device, as the JAX package computes them outside
its kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..geometry.camera import rays_from_pixels
from ..models.nerf import NerfConfig, nerf_apply, nerf_density, nerf_gradient


def get_sphere_intersection(cam_loc: torch.Tensor, ray_directions: torch.Tensor,
                            r: float = 1.0):
    """Near/far sphere hits per ray ((N,2) clamped >= 0, (N,) hit mask)
    (rendering.py:440-459)."""
    ray_cam_dot = ray_directions @ cam_loc
    under_sqrt = ray_cam_dot ** 2 - ((cam_loc ** 2).sum() - r ** 2)
    mask = under_sqrt > 0
    sq = torch.sqrt(under_sqrt.clamp_min(0.0))
    hits = torch.stack([-sq - ray_cam_dot, sq - ray_cam_dot], dim=-1)
    hits = torch.where(mask[:, None], hits, torch.zeros_like(hits))
    return hits.clamp_min(0.0), mask


@torch.no_grad()
def ray_marching(nerf_params, origin: torch.Tensor, ray_dirs: torch.Tensor, ncfg: NerfConfig,
                 tau: float = 0.5, n_steps: int = 512, n_secant_steps: int = 8,
                 radius: float = 4.0, depth_range0: float = 0.0):
    """First-crossing surface depth per ray: +inf where no surface, 0 where the
    first sample is already occupied (rendering.py:278-387); and the hit mask."""
    from .render import linspace_f32

    n = ray_dirs.shape[0]
    d_far = get_sphere_intersection(origin, ray_dirs, r=radius)[0][:, 1]
    t = linspace_f32(0.0, 1.0, n_steps, ray_dirs.device)
    d_prop = depth_range0 * (1.0 - t)[None, :] + d_far[:, None] * t[None, :]
    pts = origin[None, None, :] + ray_dirs[:, None, :] * d_prop[..., None]
    val = nerf_density(nerf_params, pts.reshape(-1, 3), ncfg).reshape(n, n_steps) - tau

    first_free = val[:, 0] < 0  # camera not inside the surface
    # first sign change from free to occupied (rendering.py:336-345)
    sign_change = torch.sign(val[:, :-1] * val[:, 1:]) < 0
    crossing = sign_change & (val[:, :-1] < 0)
    any_cross = crossing.any(dim=1)
    idx = torch.argmax(crossing.to(torch.uint8), dim=1)  # the first True
    mask = any_cross & first_free

    def take(a, i):
        return torch.gather(a, 1, i[:, None])[:, 0]

    d_low, f_low = take(d_prop, idx), take(val, idx)
    idx_hi = (idx + 1).clamp_max(n_steps - 1)
    d_high, f_high = take(d_prop, idx_hi), take(val, idx_hi)

    # secant iterations on every ray (rendering.py:389-419); misses are masked after
    d_pred = -f_low * (d_high - d_low) / (f_high - f_low + 1e-12) + d_low
    for _ in range(n_secant_steps):
        p_mid = origin[None, :] + d_pred[:, None] * ray_dirs
        f_mid = nerf_density(nerf_params, p_mid, ncfg)[:, 0] - tau
        low = f_mid < 0
        d_low = torch.where(low, d_pred, d_low)
        f_low = torch.where(low, f_mid, f_low)
        d_high = torch.where(low, d_high, d_pred)
        f_high = torch.where(low, f_high, f_mid)
        d_pred = -f_low * (d_high - d_low) / (f_high - f_low + 1e-12) + d_low

    d_out = torch.where(mask, d_pred, torch.full_like(d_pred, float("inf")))
    d_out = torch.where(first_free, d_out, torch.zeros_like(d_out))  # rendering.py:386
    return d_out, mask


def phong_render(nerf_params, pixels: torch.Tensor, camera_mat: torch.Tensor,
                 world_mat: torch.Tensor, scale_mat: Optional[torch.Tensor], ncfg: NerfConfig,
                 radius: float = 4.0, n_steps: int = 512) -> Dict[str, torch.Tensor]:
    """Lambertian shading of the implicit surface (rendering.py:203-275):
    {'rgb': (N,3) shaded, 'rgb_surf': (N,3) model colour at the surface,
    'mask': (N,) hit mask, 'depth': (N,)}."""
    origin, ray_dirs, _ = rays_from_pixels(pixels, camera_mat, world_mat, scale_mat,
                                           normalize=True)
    frozen = {k: v.detach() for k, v in nerf_params.items()}
    d_i, mask = ray_marching(frozen, origin, ray_dirs, ncfg, radius=radius, n_steps=n_steps)

    dists = torch.where(torch.isfinite(d_i), d_i, torch.ones_like(d_i))
    points = origin[None, :] + ray_dirs * dists[:, None]

    # light co-located with the camera (rendering.py:215-217)
    light = origin / torch.linalg.norm(origin)
    diffuse_per = torch.full((3,), 0.7, dtype=points.dtype, device=points.device)
    ambient = torch.full((3,), 0.3, dtype=points.dtype, device=points.device)

    grad = nerf_gradient(nerf_params, points, ncfg)
    normals = grad / (torch.linalg.norm(grad, dim=-1, keepdim=True) + 1e-12)
    diffuse = (normals @ light).clamp_min(0.0)[:, None] * diffuse_per[None, :]
    shaded = (ambient[None, :] + diffuse).clamp_max(1.0)
    rgb = torch.where(mask[:, None], shaded, torch.ones_like(shaded))

    surf_rgb, _ = nerf_apply(nerf_params, points, -ray_dirs, ncfg)
    rgb_surf = torch.where(mask[:, None], surf_rgb, torch.zeros_like(surf_rgb))
    return {"rgb": rgb, "rgb_surf": rgb_surf, "mask": mask,
            "depth": torch.where(mask, dists, torch.zeros_like(dists))}
