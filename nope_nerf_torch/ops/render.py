"""Volume rendering: ray generation -> stratified sampling -> MLP -> compositing.

Port of nope_nerf_tpu/ops/render.py (reference model/rendering.py:36-198,
`nope_nerf` technique). `render_nope_nerf` takes the fused route
(ops/fused_render.py) when the config allows it, as the JAX package does:
on a CUDA tensor that is the hand-written kernel, on a CPU tensor its plain
version. Configs the fused render cannot serve (hierarchical sampling,
num_points % 128 != 0) take the unfused route: sample points -> MLP query
-> composite, the query through the point-query MLP kernels
(ops/fused_mlp.py) when use_pallas is set, else through the model's own
nerf_apply, on the tensors' device either way. `fused_train_prepare` is the
train step's share of it: the geometry that feeds the train-fused kernel.
The normals of the normal output come from nerf_gradient, plain torch on
every device, as the JAX package computes them outside its kernels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.camera import get_ndc_rays_fxfy, rays_from_pixels, transform_to_world
from ..models.nerf import NerfConfig, nerf_apply, nerf_gradient
from ..utils.safemath import safe_norm
from .fused_mlp import point_mlp
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
    # hierarchical (importance) sampling: extra fine samples per ray drawn from
    # the coarse weights (no reference counterpart; the JAX package's extension)
    n_importance: int = 0
    # occupancy-grid guided sampling (ops/occupancy.py); the grid itself is a
    # runtime tensor passed as `occ_grid`
    occ_radius: float = 4.0
    occ_floor: float = 0.01

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
                   n_importance=r.get("n_importance", 0),
                   occ_radius=r.get("radius", 4.0),
                   occ_floor=r.get("occupancy_floor", 0.01))


def fused_eligible(rcfg: RenderConfig, ncfg: NerfConfig) -> bool:
    """Can the fused kernel render this config (ops/render.py:275-277 of the
    JAX package)? The kernel masks its ragged edge itself, so unlike the TPU
    kernel it puts no condition on the ray count."""
    fg_steps = rcfg.num_points - rcfg.outside_steps
    return (ncfg.use_pallas and rcfg.n_importance == 0 and rcfg.outside_steps == 0
            and fg_steps % 128 == 0)


@functools.lru_cache(maxsize=32)
def linspace_f32(start: float, stop: float, steps: int, device: torch.device) -> torch.Tensor:
    """jnp.linspace(start, stop, steps) in f32: start + i * delta with delta =
    (stop - start) / (steps - 1) in f32, the end point exact. Built once per
    device: a constant, so callers never write to it."""
    start32, stop32 = np.float32(start), np.float32(stop)
    delta = (stop32 - start32) / np.float32(max(steps - 1, 1))
    z = start32 + np.arange(steps, dtype=np.float32) * delta
    z[-1] = stop32
    return torch.from_numpy(z).to(device)


def sample_uniform(n_rays: int, steps: int, depth_range: Tuple[float, float],
                   add_noise: bool, device: torch.device,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified z values (n_rays, steps) on [near, far] (reference
    Renderer.sample_uniform, rendering.py:183-198): linspace mapped by
    near*(1-z) + far*z, then per-interval jitter between bin midpoints by
    `noise` (uniform [0,1), drawn from `generator` when not given)."""
    z = linspace_f32(0.0, 1.0, steps, device)
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


def sample_pdf(z_vals: torch.Tensor, weights: torch.Tensor, n_importance: int,
               deterministic: bool = False, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling of n_importance extra depths per ray
    (ops/render.py:93-127 of the JAX package; no reference counterpart): a
    piecewise-constant pdf over the z-interval midpoints from the interior
    weights + 1e-5, inverted by searchsorted (side left, as jnp.searchsorted).
    `u` (N, n_importance) in [0, 1 - 1e-5) pins the draw; without it the draw
    is linspace(0, 1 - 1e-5) when `deterministic`, else uniform from
    `generator`. Returns (N, n_importance), unsorted."""
    mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])              # (N, S-1)
    w = weights[:, 1:-1] + 1e-5                                # interior weights
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1).contiguous()  # (N, S-1)
    n = z_vals.shape[0]
    if u is None:
        if deterministic:
            u = linspace_f32(0.0, 1.0 - 1e-5, n_importance, z_vals.device).expand(n, n_importance)
        elif generator is None:
            raise ValueError("a random fine draw needs a generator or an explicit u")
        else:
            u = torch.rand((n, n_importance), generator=generator,
                           device=generator.device).to(z_vals.device) * (1.0 - 1e-5)
    u = u.to(cdf.dtype).contiguous()
    idx = torch.searchsorted(cdf, u)                           # right bin edge
    below = (idx - 1).clamp(0, cdf.shape[1] - 1)
    above = idx.clamp(0, cdf.shape[1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    mid_b = torch.gather(mids, 1, below.clamp(0, mids.shape[1] - 1))
    mid_a = torch.gather(mids, 1, above.clamp(0, mids.shape[1] - 1))
    denom = torch.where(cdf_a - cdf_b < 1e-8, torch.ones_like(cdf_a), cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return mid_b + t * (mid_a - mid_b)


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
                  noise: Optional[torch.Tensor] = None,
                  occ_grid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Pre-MLP ray work: ray generation, prior-depth surface distance and
    masks (rendering.py:53-65), z sampling (stratified, NDC, or guided by the
    occupancy grid `occ_grid`). `noise` (N, S) uniform in [0, 1) pins the
    random draw of either sampler."""
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
        z_val = linspace_f32(0.0, 1.0, fg_steps, pixels.device).expand(n_rays, fg_steps)
    elif occ_grid is not None:
        from .occupancy import occupancy_z_samples
        z_val = occupancy_z_samples(origin, ray_vec, occ_grid, fg_steps, rcfg.depth_range,
                                    rcfg.occ_radius, rcfg.occ_floor, add_noise, generator, noise)
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
                        add_noise: bool, noise: Optional[torch.Tensor] = None,
                        occ_grid: Optional[torch.Tensor] = None):
    """Geometry for the train-fused kernel: (ray table (N,9), z (N,S),
    depth_gt (N,) in loss space, object_mask (N,) bool): what
    render_nope_nerf would feed render_rays_fused."""
    geo = _ray_geometry(pixels, depth_prior, camera_mat, world_mat, scale_mat,
                        generator, rcfg, add_noise, noise, occ_grid)
    table, z = fused_inputs(geo, rcfg)
    depth_gt = geo["d_i_src"]
    if rcfg.sample_option == "ndc":
        depth_gt = 1.0 - 1.0 / depth_gt  # rendering.py:158-159
    return table, z, depth_gt, geo["object_mask"]


def _render_unfused(nerf_params, geo, rcfg: RenderConfig, ncfg: NerfConfig,
                    generator: Optional[torch.Generator] = None,
                    fine_u: Optional[torch.Tensor] = None):
    """Sample points -> MLP query -> composite (the JAX package's unfused
    branch, ops/render.py:296-351), with the hierarchical pass when
    n_importance > 0: the coarse weights, without gradient, give
    n_importance fine depths (sample_pdf: `fine_u` pins the draw, else the
    generator's, else the deterministic one), and the merged, sorted samples
    are queried again. The query is the point-query MLP (ops/fused_mlp.py)
    with use_pallas, else nerf_apply. Returns (rgb (N,3), dist (N,),
    weights, alpha, z (N,S'))."""
    z_val, ray_vec = geo["z_val"], geo["ray_vec"]
    n_rays = z_val.shape[0]

    def query(z):
        if rcfg.sample_option == "ndc":
            pts = geo["ndc_o"][:, None, :] + geo["ndc_d"][:, None, :] * z[..., None]
        else:
            pts = geo["origin"][None, None, :] + ray_vec[:, None, :] * z[..., None]
        # the MLP sees the negated ray (rendering.py:179,196)
        dirs = (-ray_vec[:, None, :]).expand(pts.shape) if rcfg.use_ray_dir \
            else torch.ones_like(pts)
        mlp = point_mlp if ncfg.use_pallas else nerf_apply
        rgb, density = mlp(nerf_params, pts.reshape(-1, 3), dirs.reshape(-1, 3), ncfg)
        return rgb.reshape(n_rays, -1, 3), density.reshape(n_rays, -1)

    def deltas(z):
        return torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)

    if rcfg.n_importance > 0 and rcfg.sample_option != "ndc":
        with torch.no_grad():      # the coarse weights carry no gradient (ops/render.py:331)
            rgb_c, alpha_c = query(z_val)
            if rcfg.dist_alpha:    # no forced last-sample hit here (:323-327)
                alpha_c = 1.0 - torch.exp(-alpha_c * deltas(z_val))
            _, _, w_coarse = composite(rgb_c, alpha_c, z_val)
            z_fine = sample_pdf(z_val, w_coarse, rcfg.n_importance,
                                deterministic=generator is None, u=fine_u, generator=generator)
        z_val = torch.sort(torch.cat([z_val, z_fine], dim=-1), dim=-1).values

    rgb, alpha = query(z_val)
    if rcfg.dist_alpha:
        # delta-scaled opacity with forced last-sample hit (rendering.py:116-122)
        alpha = 1.0 - torch.exp(-alpha * deltas(z_val))
        alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], dim=-1)
    rgb_values, dist_pred, weights = composite(rgb, alpha, z_val)
    return rgb_values, dist_pred, weights, alpha, z_val


def _normal_diff(nerf_params, geo, ncfg: NerfConfig, generator: Optional[torch.Generator],
                 normal_noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Perturbed-point normal smoothness (rendering.py:127-137): |n(x) - n(x')|
    per ray at its prior surface point x and a neighbour x' jittered by
    (normal_noise - 0.5) * 0.01, normal_noise (N,3) uniform in [0, 1) or drawn
    from the generator. No loss of the JAX package reads it."""
    surface = geo["origin"][None, :] + geo["ray_vec"] * geo["dists"][:, None]
    if normal_noise is None:
        if generator is None:
            raise ValueError("the normal output needs a generator or explicit normal_noise")
        normal_noise = torch.rand(surface.shape, generator=generator,
                                  device=generator.device).to(surface.device)
    neigh = surface + (normal_noise.to(surface.dtype) - 0.5) * 0.01
    g = nerf_gradient(nerf_params, torch.cat([surface, neigh], dim=0), ncfg)
    normals = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-5)
    n = surface.shape[0]
    return safe_norm(normals[:n] - normals[n:], dim=-1)


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
                     noise: Optional[torch.Tensor] = None,
                     occ_grid: Optional[torch.Tensor] = None,
                     fine_u: Optional[torch.Tensor] = None,
                     normal_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Render N rays of one frame on the pixels' device.

    Output keys (rendering.py:160-167, masks instead of gathers): rgb (N,3),
    z_vals (N,S), alpha (N,S), weights (N,S), depth_pred (N,), depth_gt (N,),
    object_mask (N,) bool, and with rcfg.normal_loss outside eval
    normal (N,). need_aux=False skips the (N,S) weights/alpha of the fused
    route (None in the dict). `noise` pins the stratified (or occupancy)
    jitter, `fine_u` the hierarchical fine draw (N, n_importance) and
    `normal_noise` the normal output's neighbour jitter (N,3); what is not
    pinned comes from `generator`, and without one the fine draw is the
    deterministic one, as the JAX package's with key None. Gradients flow to
    the nerf params and, through the rays, to the camera and world matrices;
    on CUDA the backward is the render-backward kernel on the fused route and
    the point-query MLP backward kernel on the unfused one with use_pallas."""
    if rcfg.outside_steps:
        raise NotImplementedError(
            "rendering.outside_steps > 0 is not supported: the JAX package's renderer cannot "
            "run it either (ROADMAP Queue 3), so no slice of the port brings it")
    geo = _ray_geometry(pixels, depth_prior, camera_mat, world_mat, scale_mat,
                        generator, rcfg, add_noise, noise, occ_grid)
    z_val = geo["z_val"]
    if fused_eligible(rcfg, ncfg):
        table, z = fused_inputs(geo, rcfg)
        rgb_values, dist_pred, weights, alpha = render_rays_fused(
            nerf_params, table, z, ncfg, rcfg.dist_alpha,
            want_aux=need_aux or rcfg.white_background)
    else:
        rgb_values, dist_pred, weights, alpha, z_val = _render_unfused(
            nerf_params, geo, rcfg, ncfg, generator, fine_u)

    normal = None
    if rcfg.normal_loss and not eval_:
        normal = _normal_diff(nerf_params, geo, ncfg, generator, normal_noise)

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
    out = {
        "rgb": rgb_values,
        "z_vals": z_val,
        "alpha": alpha,
        "weights": weights,
        "depth_pred": dist_pred,
        "depth_gt": depth_gt,
        "object_mask": geo["object_mask"],
    }
    if normal is not None:
        out["normal"] = normal
    return out
