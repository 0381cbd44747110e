"""Occupancy-grid guided ray sampling.

Port of nope_nerf_tpu/ops/occupancy.py (no reference counterpart: the JAX
package's extension, after NerfAcc's occupancy grids). The fixed per-ray
budget of S samples is redistributed toward occupied cells by inverse-CDF
sampling over a per-ray occupancy profile, with a uniform floor so that
unexplored space keeps coverage; the z it gives feeds the same renderers
(the fused train kernel takes any sorted z). The grid update is one batch of
plain `nerf_density` queries over jittered cell centres, on the grid's
device, as the JAX package runs it outside its kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import DeviceLike, resolve_device
from ..models.nerf import NerfConfig, nerf_density


def make_occupancy_grid(res: int, device: DeviceLike = None) -> torch.Tensor:
    """Fresh (res, res, res) f32 grid, fully occupied (1.0): early training
    sees plain stratified coverage until real densities take over the EMA."""
    return torch.ones((res, res, res), dtype=torch.float32, device=resolve_device(device))


def grid_lookup(grid: torch.Tensor, points: torch.Tensor, radius: float) -> torch.Tensor:
    """Nearest-cell occupancy for world points (..., 3) in the [-radius,
    radius]^3 cube; points outside the cube read 0.0 (the sampler's floor
    keeps them covered, as learned-empty interior cells)."""
    res = grid.shape[0]
    ijk = torch.floor((points + radius) * (res / (2.0 * radius))).to(torch.int64)
    inside = ((ijk >= 0) & (ijk < res)).all(dim=-1)
    ijk = ijk.clamp(0, res - 1)
    flat = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
    occ = grid.reshape(-1)[flat.reshape(-1)].reshape(flat.shape)
    return torch.where(inside, occ, torch.zeros_like(occ))


def cell_centers(res: int, radius: float, device: torch.device) -> torch.Tensor:
    """(res^3, 3) f32 cell centres in the grid's (i, j, k) order."""
    idx = torch.arange(res, device=device)
    ijk = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1).reshape(-1, 3)
    cell = 2.0 * radius / res
    return (ijk.to(torch.float32) + 0.5) * cell - radius


@torch.no_grad()
def update_occupancy_grid(grid: torch.Tensor, nerf_params, ncfg: NerfConfig,
                          radius: float = 4.0, decay: float = 0.95,
                          generator: Optional[torch.Generator] = None,
                          jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EMA update: grid' = max(grid * decay, alpha(cell)), one density query at
    a jittered point per cell. `jitter` (res^3, 3) uniform in [-0.5, 0.5)
    pins the draw, else it comes from `generator`. With the head's dist_alpha
    the density is sigma and becomes opacity over one cell diagonal; without,
    the head already emits occupancy in [0, 1) and is used as it is."""
    res = grid.shape[0]
    cell = 2.0 * radius / res
    centers = cell_centers(res, radius, grid.device)
    if jitter is None:
        if generator is None:
            raise ValueError("the occupancy update needs a generator or an explicit jitter")
        jitter = torch.rand(centers.shape, generator=generator,
                            device=generator.device).to(grid.device) - 0.5
    pts = centers + jitter.to(centers.dtype) * cell
    density = nerf_density(nerf_params, pts, ncfg)[..., 0]
    alpha = (1.0 - torch.exp(-density * cell * 3.0 ** 0.5)) if ncfg.dist_alpha else density
    return torch.maximum(grid * decay, alpha.reshape(grid.shape))


def occupancy_z_samples(origin: torch.Tensor, ray_vec: torch.Tensor, grid: torch.Tensor,
                        steps: int, depth_range: Tuple[float, float], radius: float,
                        floor: float, add_noise: bool,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, steps) sorted z concentrated where the grid is occupied: probe the
    grid at steps + 2 depths (the ladder extended by one step past each end of
    depth_range, so every in-range probe weight takes part in sample_pdf),
    form the pdf w = occ + floor and inverse-CDF sample `steps` depths, clipped
    back to depth_range. The draw is u = noise * (1 - 1e-5) with `noise` (N,
    steps) uniform in [0, 1) (from `generator` when not given), the JAX
    package's uniform(key, 0, 1 - 1e-5); add_noise=False gives the
    deterministic draw."""
    from .render import linspace_f32, sample_pdf

    n = ray_vec.shape[0]  # origin is the shared camera centre (3,)
    near, far = depth_range
    h = (far - near) / (steps - 1)
    z_probe = linspace_f32(near - h, far + h, steps + 2, ray_vec.device).expand(n, steps + 2)
    pts = origin[None, None, :] + z_probe[..., None] * ray_vec[:, None, :]
    w = grid_lookup(grid, pts, radius) + floor
    u = None
    if add_noise:
        if noise is None:
            if generator is None:
                raise ValueError("add_noise needs a generator or explicit noise")
            noise = torch.rand((n, steps), generator=generator,
                               device=generator.device).to(ray_vec.device)
        u = noise * (1.0 - 1e-5)
    z = sample_pdf(z_probe, w, steps, deterministic=not add_noise, u=u)
    return torch.sort(z.clamp(near, far), dim=-1).values
