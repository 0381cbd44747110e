"""Camera model and pixel/world transforms.

Port of nope_nerf_tpu/geometry/camera.py (reference model/common.py:13-237).
The composition P = scale^-1 @ world^-1 @ K^-1 is formed once per frame and
applied to all pixels as one (N,4)x(4,4) product. Products are exact float32
(the JAX package pins them with `mm_exact`): the package switches TF32 off
when it loads, so a plain `@` is the exact product here.

Conventions (identical to the reference):
- pixels live in [-1, 1]^2 with x = 2*px/(W-1) - 1;
- K = [[2fx/W,0,0,0],[0,-2fy/H,0,0],[0,0,-1,0],[0,0,0,1]];
- world_mat = inverse(c2w); scale_mat is usually identity.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _pixel_grid_np(resolution: Tuple[int, int], image_range: Tuple[float, float],
                   dtype_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side pixel grid, the JAX package's numpy formula verbatim so the
    rays match bit for bit."""
    h, w = resolution
    dtype = np.dtype(dtype_name)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    loc = np.stack([xs, ys], axis=-1).reshape(-1, 2)
    scale = dtype.type(image_range[1] - image_range[0])
    shift = dtype.type(scale / 2.0)
    px = scale * loc[:, 0].astype(dtype) / dtype.type(w - 1) - shift
    py = scale * loc[:, 1].astype(dtype) / dtype.type(h - 1) - shift
    return loc.astype(np.int32), np.stack([px, py], axis=-1)


def pixel_grid(resolution: Tuple[int, int],
               image_range: Tuple[float, float] = (-1.0, 1.0),
               dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """(locations (H*W, 2) int32 as (x, y), scaled (H*W, 2)) as numpy arrays,
    row-major with x fastest (reference arange_pixels, model/common.py:13-40).
    The cached arrays are shared: callers copy before writing."""
    return _pixel_grid_np(tuple(resolution), tuple(image_range), np.dtype(dtype).name)


@functools.lru_cache(maxsize=8)
def pixel_grid_on(resolution: Tuple[int, int], device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """pixel_grid's scaled pixels (H*W, 2) as a tensor on `device`, uploaded
    once per resolution: a constant, so callers never write to it."""
    return torch.from_numpy(pixel_grid(tuple(resolution))[1]).to(device=device, dtype=dtype)


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 [R|t; 0 0 0 1]: [R^T | -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t)], dim=-1)
    return torch.cat([top, T[..., 3:4, :]], dim=-2)


def diag4_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of a diagonal 4x4 (the camera/scale matrix convention)."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    return M * 0.0 + (1.0 / d)[..., None, :] * torch.eye(4, dtype=M.dtype, device=M.device)


def camera_matrix_from_focal(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """K = diag(fx', -fy', -1, 1) from focals in the [-1,1] pixel convention
    (reference model/training.py:266-271)."""
    fx = torch.as_tensor(fx)
    fy = torch.as_tensor(fy, dtype=fx.dtype, device=fx.device)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    rows = [
        torch.stack([fx, zero, zero, zero], -1),
        torch.stack([zero, -fy, zero, zero], -1),
        torch.stack([zero, zero, -one, zero], -1),
        torch.stack([zero, zero, zero, one], -1),
    ]
    return torch.stack(rows, -2)


def intrinsics_ndc_np(fx: float, fy: float, w: int, h: int) -> np.ndarray:
    """Pixel-unit focals -> the [-1,1] normalized camera matrix (numpy;
    reference dataloading/dataset.py:83-86)."""
    return np.array([[2.0 * fx / w, 0, 0, 0],
                     [0, -2.0 * fy / h, 0, 0],
                     [0, 0, -1, 0],
                     [0, 0, 0, 1]], np.float32)


def _compose_cam_to_world(camera_mat: torch.Tensor, world_mat: torch.Tensor,
                          scale_mat: Optional[torch.Tensor], invert: bool) -> torch.Tensor:
    """P with p_world_h = P @ p_cam_h: scale^-1 @ world^-1 @ K^-1 when invert,
    else scale @ world @ K."""
    if scale_mat is None:
        scale_mat = torch.eye(4, dtype=camera_mat.dtype, device=camera_mat.device)
    if invert:
        camera_mat = diag4_inverse(camera_mat)
        world_mat = rigid_inverse(world_mat)
        scale_mat = diag4_inverse(scale_mat)
    return (scale_mat @ world_mat) @ camera_mat


def transform_to_world(pixels: torch.Tensor, depth: torch.Tensor, camera_mat: torch.Tensor,
                       world_mat: Optional[torch.Tensor] = None,
                       scale_mat: Optional[torch.Tensor] = None,
                       invert: bool = True) -> torch.Tensor:
    """Lift [-1,1]-pixels (N, 2) with depth (N, 1) or (N,) to world points (N, 3)
    through homogeneous [px*d, py*d, d, 1] (reference model/common.py:112-160)."""
    if world_mat is None:
        world_mat = torch.eye(4, dtype=pixels.dtype, device=pixels.device)
    P = _compose_cam_to_world(camera_mat, world_mat, scale_mat, invert)
    d = depth.reshape(-1, 1)
    hom = torch.cat([pixels * d, d, torch.ones_like(d)], dim=-1)
    return (hom @ P.T)[:, :3]


def origin_to_world(camera_mat: torch.Tensor, world_mat: torch.Tensor,
                    scale_mat: Optional[torch.Tensor] = None,
                    invert: bool = True) -> torch.Tensor:
    """Camera center in world coordinates, shape (3,) (reference
    model/common.py:186-215)."""
    return _compose_cam_to_world(camera_mat, world_mat, scale_mat, invert)[:3, 3]


def transform_to_camera_space(p_world: torch.Tensor, camera_mat: torch.Tensor,
                              world_mat: torch.Tensor,
                              scale_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World points (N, 3) -> camera space (N, 3) (reference model/common.py:163-183)."""
    if scale_mat is None:
        scale_mat = torch.eye(4, dtype=p_world.dtype, device=p_world.device)
    M = (camera_mat @ world_mat) @ scale_mat
    hom = torch.cat([p_world, torch.ones_like(p_world[:, :1])], dim=-1)
    return (hom @ M.T)[:, :3]


def rays_from_pixels(pixels: torch.Tensor, camera_mat: torch.Tensor, world_mat: torch.Tensor,
                     scale_mat: Optional[torch.Tensor] = None,
                     normalize: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(origin (3,), ray_vector (N, 3), ray_norm (N,)) for a frame; ray_vector
    is un-normalized when normalize=False (reference rendering.py:59-65)."""
    P = _compose_cam_to_world(camera_mat, world_mat, scale_mat, invert=True)
    origin = P[:3, 3]
    ones = torch.ones_like(pixels[:, :1])
    pixels_world = (torch.cat([pixels, ones, ones], dim=-1) @ P.T)[:, :3]
    ray_vec = pixels_world - origin
    ray_norm = torch.linalg.norm(ray_vec, dim=-1)
    if normalize:
        ray_vec = ray_vec / ray_norm[:, None]
    return origin, ray_vec, ray_norm


def project_to_cam(points: torch.Tensor,
                   camera_mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project camera-space points (N, 3) through K -> ([-1,1] xy (N, 2), valid
    mask (N, 1) bool) (reference model/common.py:436-457)."""
    hom = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    xy = (hom @ camera_mat.T)[:, :3]
    xy = xy[:, :2] / xy[:, 2:]
    valid = (xy.abs().amax(dim=-1) <= 1.0)[:, None]
    return xy, valid


def reprojection(pixels: torch.Tensor, depth: torch.Tensor, Rt_ref: torch.Tensor,
                 world_mat: torch.Tensor,
                 camera_mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp pixels of frame A into frame B: K @ Rt_ref @ world^-1 @ K^-1 ->
    ([-1,1] xy (N, 2), valid float mask (N, 1)) (reference common.py:405-435)."""
    d = depth.reshape(-1, 1)
    hom = torch.cat([pixels * d, d, torch.ones_like(d)], dim=-1)
    M = ((camera_mat @ Rt_ref) @ rigid_inverse(world_mat)) @ diag4_inverse(camera_mat)
    xy = (hom @ M.T)[:, :3]
    xy = xy[:, :2] / xy[:, 2:]
    valid = (xy.abs().amax(dim=-1) <= 1.0)[:, None].to(pixels.dtype)
    return xy, valid


def get_ndc_rays_fxfy(fxfy: torch.Tensor, near: float, rays_o: torch.Tensor,
                      rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World rays -> NDC rays (reference common.py:632-675)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -fxfy[0] * ox_oz
    o1 = -fxfy[1] * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -fxfy[0] * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -fxfy[1] * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
