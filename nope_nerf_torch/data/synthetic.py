"""Synthetic scenes for tests and the chip check (numpy only).

Copy of make_synthetic_scene / make_driving_scene from
nope_nerf_tpu/data/synthetic.py: a disk-free stand-in with the exact batch
schema of a loaded scene; and of its write_vkitti_scene, which writes such a
scene as a scene directory on disk through data/image_io.py (no cv2): the
same files, pixel for pixel, as the JAX package's writer.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..geometry.camera import intrinsics_ndc_np as _intrinsics_ndc_np
from .image_io import write_png


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


def _c2w_to_llff_row(c2w: np.ndarray, h: int, w: int, f: float,
                     dmin: float, dmax: float) -> np.ndarray:
    """OpenGL c2w -> 17-float LLFF row [R|t|hwf] + bounds, such that the loader's
    (x,y,z)->(y,-x,z) column swizzle (llff.make_c2ws_from_llff) recovers c2w.
    Same permutation as cli/get_vkitti.convert_pose."""
    r, t = c2w[:3, :3], c2w[:3, 3:4]
    r_llff = np.hstack([-r[:, 1:2], r[:, 0:1], r[:, 2:3]])
    m35 = np.hstack([r_llff, t, np.array([[h], [w], [f]], np.float64)])
    return np.hstack([m35.flatten(), dmin, dmax])


def write_vkitti_scene(dest: str, scene: Dict[str, np.ndarray],
                       pose_noise_deg: float = 0.0,
                       pose_noise_trans: float = 0.0,
                       seed: int = 1) -> None:
    """Write a scene dict as a V-KITTI-format LLFF scene directory, the exact
    layout cli/get_vkitti produces from raw V-KITTI (and the reference's
    get_kittivirtual.py emits): images/*.png, depth/*.png (uint16 centimetres),
    intrinsics.npz, poses_gt.npy, poses_bounds.npy.

    poses_bounds.npy (the "COLMAP" initialization the d-variant configs start
    from) can be perturbed with rotation/translation noise to simulate an
    imperfect reconstruction, making joint pose refinement non-trivial.
    """
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(dest, "images"), exist_ok=True)
    os.makedirs(os.path.join(dest, "depth"), exist_ok=True)

    imgs, depths, c2ws = scene["imgs"], scene["depths"], scene["c2ws_gt"]
    n, h, w = depths.shape
    fx, fy = float(scene["fx"]), float(scene["fy"])
    K3 = np.array([[fx, 0, (w - 1) / 2.0], [0, fy, (h - 1) / 2.0], [0, 0, 1]])
    np.savez(os.path.join(dest, "intrinsics.npz"), K=K3)

    rows_gt, rows_init = [], []
    for i in range(n):
        name = f"{i:05d}.png"
        rgb = np.clip(imgs[i] * 255.0, 0, 255).astype(np.uint8)
        write_png(os.path.join(dest, "images", name), rgb)
        depth_cm = np.clip(np.round(depths[i] * 100.0), 0, 65535).astype(np.uint16)
        write_png(os.path.join(dest, "depth", name), depth_cm)

        dmin, dmax = float(depths[i].min()), float(depths[i].max())
        rows_gt.append(_c2w_to_llff_row(c2ws[i], h, w, fx, dmin, dmax))

        noisy = np.array(c2ws[i], np.float64)
        if pose_noise_deg or pose_noise_trans:
            dr = Rotation.from_rotvec(
                np.deg2rad(pose_noise_deg) * rng.randn(3) / np.sqrt(3)).as_matrix()
            noisy[:3, :3] = dr @ noisy[:3, :3]
            noisy[:3, 3] += pose_noise_trans * rng.randn(3)
        rows_init.append(_c2w_to_llff_row(noisy, h, w, fx, dmin, dmax))

    np.save(os.path.join(dest, "poses_gt.npy"), np.stack(rows_gt))
    np.save(os.path.join(dest, "poses_bounds.npy"), np.stack(rows_init))


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
