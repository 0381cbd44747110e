"""Novel-view trajectory generation and rendering.

Port of nope_nerf_tpu/evaluation/extract.py (reference vis/render.py,
model/extracting_images.py and the trajectory builders of
model/common.py:511-615). Trajectory math is host-side numpy/scipy, copied
from the JAX module; rendering goes through ops/render.render_nope_nerf in
ray chunks on the chosen device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import scipy.interpolate as si
import torch
from scipy.spatial.transform import Rotation as R
from scipy.spatial.transform import Slerp

from .. import DeviceLike, resolve_device
from ..data.image_io import write_png


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _to44(poses34: np.ndarray) -> np.ndarray:
    out = np.tile(np.eye(4, dtype=np.float32), (poses34.shape[0], 1, 1))
    out[:, :3, :4] = poses34[:, :3, :4]
    return out


def interp_poses(c2ws: np.ndarray, n_views: int) -> np.ndarray:
    """Slerp + linear translation interpolation (common.py:511-522)."""
    n_in = c2ws.shape[0]
    slerp = Slerp(np.linspace(0, 1, n_in), R.from_matrix(c2ws[:, :3, :3]))
    times = np.linspace(0, 1, n_views)
    rots = slerp(times).as_matrix().astype(np.float32)
    # torch F.interpolate(mode='linear', align_corners=False) on the translation
    # track — reproduced via np.interp over the source grid positions
    src = np.arange(n_in)
    # align_corners=False linear resize: x_src = (i + 0.5) * n_in/n_views - 0.5
    pos = np.clip((np.arange(n_views) + 0.5) * (n_in / n_views) - 0.5, 0, n_in - 1)
    trans = np.stack([np.interp(pos, src, c2ws[:, k, 3]) for k in range(3)], -1)
    out = np.concatenate([rots, trans[:, :, None].astype(np.float32)], -1)
    return _to44(out)


def scipy_bspline(cv: np.ndarray, n: int = 100, degree: int = 3,
                  periodic: bool = False) -> np.ndarray:
    """B-spline through control vertices (common.py:563-589)."""
    cv = np.asarray(cv)
    count = cv.shape[0]
    if periodic:
        kv = np.arange(-degree, count + degree + 1)
        factor, fraction = divmod(count + degree + 1, count)
        cv = np.roll(np.concatenate((cv,) * factor + (cv[:fraction],)), -1, axis=0)
    else:
        degree = int(np.clip(degree, 1, count - 1))
        kv = np.clip(np.arange(count + degree + 1) - degree, 0, count - degree)
    max_param = count - (degree * (1 - periodic))
    spl = si.BSpline(kv, cv, degree)
    return spl(np.linspace(0, max_param, n))


def interp_poses_bspline(c2ws: np.ndarray, n_novel: int, input_times: np.ndarray,
                         degree: int) -> np.ndarray:
    """B-spline translations + slerp rotations (common.py:523-531)."""
    trans = scipy_bspline(c2ws[:, :3, 3], n=n_novel, degree=degree,
                          periodic=False).astype(np.float32)
    slerp = Slerp(input_times, R.from_matrix(c2ws[:, :3, :3]))
    times = np.linspace(input_times[0], input_times[-1], n_novel)
    rots = slerp(times).as_matrix().astype(np.float32)
    out = np.concatenate([rots, trans[:, :, None]], -1)
    return _to44(out)


def _poses_avg(poses: np.ndarray) -> np.ndarray:
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def render_path_spiral(c2w, up, rads, focal, zrate, rots, n):
    """common.py:381-392."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([0.2 * np.cos(theta), -0.2 * np.sin(theta),
                             -np.sin(theta * zrate) * 0.1, 1.0]) * rads)
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return render_poses


def generate_spiral_nerf(learned_poses: np.ndarray, bds: np.ndarray,
                         n_novel: int, hwf: np.ndarray) -> np.ndarray:
    """NeRF-style spiral about the average learned pose (common.py:591-615)."""
    learned = np.concatenate([learned_poses[:, :3, :4],
                              hwf[:len(learned_poses)]], axis=-1)
    c2w = _poses_avg(learned)
    up = _normalize(learned[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = learned[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0)
    c2ws = render_path_spiral(c2w, up, rads, focal, zrate=0.5, rots=2, n=n_novel)
    return _to44(np.stack(c2ws).astype(np.float32)[:, :3, :4])




def _write_frames(frames: List[Dict[str, np.ndarray]], out_dir: str,
                  save_video: bool) -> None:
    """img/depth/disp pngs (the port's own PNG writer), and, where imageio is
    installed, mp4s (GIF without an ffmpeg backend)."""
    for sub in ("img", "depth", "disp"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    def norm8(x):
        return np.clip(255.0 / x.max() * (x - x.min()), 0, 255).astype(np.uint8)

    for vi, f in enumerate(frames):
        write_png(os.path.join(out_dir, "img", f"{vi:04d}.png"), (f["rgb"] * 255).astype(np.uint8))
        write_png(os.path.join(out_dir, "depth", f"{vi:04d}.png"), norm8(f["depth"]))
        write_png(os.path.join(out_dir, "disp", f"{vi:04d}.png"), norm8(f["disp"]))
    if save_video:
        try:
            import imageio
        except ImportError:
            print(f"saved the frames under {out_dir} (no imageio: no videos)")
            return
        for sub, key in (("img", "rgb"), ("depth", "depth"), ("disp", "disp")):
            arr = [((f[key] * 255).astype(np.uint8) if key == "rgb" else norm8(f[key]))
                   for f in frames]
            try:  # mp4 needs an ffmpeg backend
                imageio.mimwrite(os.path.join(out_dir, f"{sub}.mp4"), arr, fps=30, quality=8)
            except (ImportError, ValueError, RuntimeError):
                imageio.mimwrite(os.path.join(out_dir, f"{sub}.gif"), arr, duration=33, loop=0)


def render_trajectory(nerf_params, c2ws: np.ndarray, camera_mat, resolution, ncfg, rcfg,
                      chunk: int = 131072, out_dir: Optional[str] = None,
                      save_video: bool = True,
                      device: DeviceLike = None) -> List[Dict[str, np.ndarray]]:
    """Render every pose of a trajectory at `resolution` -> one
    {"rgb" (H,W,3), "depth" (H,W), "disp" (H,W)} numpy dict per view; writes
    pngs and videos under `out_dir` when given (vis/render.py:95-121). Rays go
    through render_nope_nerf in chunks of `chunk`: with the default, one chunk
    (one kernel launch) per 188x621 frame."""
    from ..geometry.camera import pixel_grid, rigid_inverse
    from ..ops.render import render_nope_nerf

    dev = resolve_device(device)
    h, w = resolution
    n = h * w
    chunk = min(chunk, n)
    pixels_all = torch.from_numpy(pixel_grid((h, w))[1]).to(dev)
    ones = torch.ones((chunk, 1), dtype=torch.float32, device=dev)
    params = {k: v.to(dev) for k, v in nerf_params.items()}
    camera_mat = torch.as_tensor(np.asarray(camera_mat, np.float32), device=dev)

    frames = []
    with torch.no_grad():
        for c2w in c2ws:
            world_mat = rigid_inverse(torch.as_tensor(np.asarray(c2w, np.float32), device=dev))
            rgbs, depths = [], []
            for i in range(0, n, chunk):
                px = pixels_all[i:i + chunk]
                out = render_nope_nerf(params, px, ones[:px.shape[0]], camera_mat, world_mat,
                                       None, None, rcfg, ncfg, add_noise=False, eval_=True,
                                       need_aux=False)
                rgbs.append(out["rgb"])
                depths.append(out["depth_pred"])
            rgb = torch.cat(rgbs).cpu().numpy().reshape(h, w, 3)
            depth = torch.cat(depths).cpu().numpy().reshape(h, w)
            frames.append({"rgb": rgb, "depth": depth,
                           "disp": 1.0 / np.maximum(depth, 1e-6)})
    if out_dir is not None:
        _write_frames(frames, out_dir, save_video)
    return frames
