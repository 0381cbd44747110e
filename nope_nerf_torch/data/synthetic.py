"""Synthetic scenes for tests and the chip check (numpy only).

Copy of make_synthetic_scene / make_driving_scene from
nope_nerf_tpu/data/synthetic.py: a disk-free stand-in with the exact batch
schema of a loaded scene. The V-KITTI writer (which needs cv2) is not ported:
on-disk scenes come with the data slice of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..geometry.camera import intrinsics_ndc_np as _intrinsics_ndc_np


def _texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth RGB texture over world-plane coordinates."""
    return np.stack([
        0.5 + 0.35 * np.sin(1.3 * x) * np.cos(0.9 * y),
        0.5 + 0.35 * np.cos(1.1 * x + 0.5),
        0.5 + 0.35 * np.sin(0.7 * y - 0.3),
    ], -1).astype(np.float32)


def _cast_primitives(pos: np.ndarray, dir_world: np.ndarray, prims) -> tuple:
    """Nearest-hit ray cast against a list of primitive dicts.

    Each primitive: {axis: 0|1|2, c: plane coordinate, bounds: ((a0,a1),(b0,b1))
    over the other two axes or None, tex: fn(u, v) -> rgb}. Returns (rgb (H,W,3),
    depth (H,W)) where depth is the ray parameter t (camera z-depth, since the
    camera-space direction has z = -1)."""
    h, w = dir_world.shape[:2]
    best_t = np.full((h, w), np.inf, np.float32)
    rgb = np.zeros((h, w, 3), np.float32)
    for p in prims:
        a = p["axis"]
        da = dir_world[..., a]
        t = (p["c"] - pos[a]) / np.where(np.abs(da) < 1e-9, 1e-9, da)
        hit = pos[None, None, :] + t[..., None] * dir_world
        others = [i for i in range(3) if i != a]
        valid = t > 0.05
        if p.get("bounds") is not None:
            (a0, a1), (b0, b1) = p["bounds"]
            valid &= ((hit[..., others[0]] >= a0) & (hit[..., others[0]] <= a1)
                      & (hit[..., others[1]] >= b0) & (hit[..., others[1]] <= b1))
        closer = valid & (t < best_t)
        col = p["tex"](hit[..., others[0]], hit[..., others[1]])
        rgb = np.where(closer[..., None], col, rgb)
        best_t = np.where(closer, t, best_t)
    return rgb, best_t


def make_driving_scene(n_frames: int = 20, h: int = 96, w: int = 160,
                       seed: int = 0, step: float = 1.0) -> Dict[str, np.ndarray]:
    """A V-KITTI-shaped synthetic world: a camera driving forward (-z) past a
    ground plane, two building walls, textured billboards at staggered depths,
    and a far background — all analytic, so GT depths are exact and the scene is
    multi-view consistent. Same schema as make_synthetic_scene, plus 'fx'/'fy'
    pixel-unit intrinsics for writers.

    Unlike the single-plane scene this has real depth structure (0.05–120 m),
    occlusions, and parallax — enough for the Chamfer/warp losses and depth
    metrics to be meaningfully exercised.
    """
    rng = np.random.RandomState(seed)
    fx = fy = 0.8 * w
    K = _intrinsics_ndc_np(fx, fy, w, h)

    def tex(fr, fg, fb, pr, pg, pb):
        return lambda u, v: np.stack([
            0.5 + 0.4 * np.sin(fr * u + pr) * np.cos(fr * 0.7 * v),
            0.5 + 0.4 * np.sin(fg * v + pg),
            0.5 + 0.4 * np.cos(fb * (u + v) + pb),
        ], -1).astype(np.float32)

    travel = step * n_frames
    prims = [
        # ground plane (y = -1.6) and two walls flanking the "road"
        dict(axis=1, c=-1.6, bounds=None, tex=tex(2.1, 1.3, 0.9, 0.0, 1.0, 2.0)),
        dict(axis=0, c=-6.0, bounds=None, tex=tex(0.8, 1.7, 1.1, 2.0, 0.0, 1.0)),
        dict(axis=0, c=7.0, bounds=None, tex=tex(1.2, 0.6, 1.9, 1.0, 2.0, 0.0)),
        # far background "sky line" closing the frustum
        dict(axis=2, c=-(travel + 100.0), bounds=None,
             tex=tex(0.15, 0.2, 0.1, 0.3, 1.2, 2.5)),
    ]
    # billboards at staggered depths on both sides of the road
    for i in range(6):
        z = -6.0 - (travel + 40.0) * i / 5.0 - 2.0 * rng.rand()
        x0 = (-4.5 if i % 2 == 0 else 1.5) + 0.8 * rng.randn()
        prims.append(dict(axis=2, c=z,
                          bounds=((x0, x0 + 3.0), (-1.6, 1.2 + 0.8 * rng.rand())),
                          tex=tex(2.5 + 0.5 * i, 1.4 + 0.3 * i, 1.0, i, 0.4 * i, 1.7)))

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = 2.0 * xs / (w - 1) - 1.0
    py = 2.0 * ys / (h - 1) - 1.0
    dir_cam = np.stack([px * w / (2 * fx), -py * h / (2 * fy), -np.ones_like(px)],
                       -1).astype(np.float32)

    imgs, depths, c2ws = [], [], []
    for i in range(n_frames):
        yaw = 0.02 * np.sin(0.45 * i)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                      [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
        pos = np.array([0.25 * np.sin(0.3 * i), 0.05 * np.cos(0.7 * i),
                        -step * i], np.float32)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R
        c2w[:3, 3] = pos
        rgb, depth = _cast_primitives(pos, dir_cam @ R.T, prims)
        imgs.append(rgb)
        depths.append(depth.astype(np.float32))
        c2ws.append(c2w)

    return {
        "imgs": np.stack(imgs),
        "depths": np.stack(depths),
        "depth_masks": np.ones((n_frames, h, w), bool),
        "c2ws_gt": np.stack(c2ws),
        "K": K,
        "fx": np.float32(fx),
        "fy": np.float32(fy),
    }


def make_synthetic_scene(n_frames: int = 4, h: int = 48, w: int = 64,
                         seed: int = 0, plane_z: float = -6.0,
                         motion: float = 0.15) -> Dict[str, np.ndarray]:
    """Returns imgs (N,H,W,3), depths (N,H,W) — *exact* depth priors in the
    framework's convention (pixel*d through K^-1), depth_masks, c2ws_gt (N,4,4),
    K (4,4)."""
    rng = np.random.RandomState(seed)
    fx = fy = 0.7 * w
    K = _intrinsics_ndc_np(fx, fy, w, h)

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = 2.0 * xs / (w - 1) - 1.0
    py = 2.0 * ys / (h - 1) - 1.0
    # camera-space ray directions at depth 1 (through K^-1; camera looks along -z)
    dir_cam = np.stack([px * w / (2 * fx), -py * h / (2 * fy), -np.ones_like(px)], -1)

    imgs, depths, c2ws = [], [], []
    for i in range(n_frames):
        ang = 0.02 * i + 0.005 * rng.randn()
        R = np.array([[np.cos(ang), 0, np.sin(ang)],
                      [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        pos = np.array([motion * i, 0.05 * np.sin(i), motion * 2 * i], np.float32)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R
        c2w[:3, 3] = pos

        dir_world = dir_cam @ R.T  # (H, W, 3)
        # ray-plane intersection: pos_z + d * dir_z = plane_z
        d = (plane_z - pos[2]) / dir_world[..., 2]
        hit = pos[None, None, :] + d[..., None] * dir_world
        imgs.append(_texture(hit[..., 0], hit[..., 1]))
        depths.append(d.astype(np.float32))
        c2ws.append(c2w)

    return {
        "imgs": np.stack(imgs),
        "depths": np.stack(depths),
        "depth_masks": np.ones((n_frames, h, w), bool),
        "c2ws_gt": np.stack(c2ws),
        "K": K,
    }
