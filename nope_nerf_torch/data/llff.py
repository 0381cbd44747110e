"""LLFF pose/image loading and preprocessing (host-side numpy).

Port of nope_nerf_tpu/data/llff.py, in numpy with the same dtypes, so poses
and the `reverse` dict are bit-equal to the JAX package's. Where that module
calls cv2 (imread, imwrite, resize), this one calls data/image_io.py: PNG
files only, the same resampling weights, uint8 results within one step of
cv2's (see image_io). The minified and cropped image caches are keyed by
directory name alone, as there: a cache another program wrote is read as it
is.

Capability parity with `dataloading/common.py:82-266` and
`dataloading/dataset.py:230-278`:
- poses_bounds.npy / poses_gt.npy parsing (3x5 LLFF matrices + depth bounds);
- the (x,y,z)->(y,-x,z) column swizzle, bd_factor rescale sc = 1/(bds.min()*bd_factor),
  recentering about the average pose, optional spherification;
- the `reverse` dict recording every scale/transform so learned poses and depths can
  be reverted to metric units at eval time (`evaluation/eval_poses.py:22-37`).

Pure numpy on the host: this runs once at startup. Image minification is
done in-process with area resampling (the reference shells out to ImageMagick
`mogrify`, dataloading/common.py:9-58).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .image_io import (image_shape, read_png, read_rgb8, resize_area, resize_linear,
                       resize_nearest_exact, write_png)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".PNG")


def list_images(img_dir: str) -> List[str]:
    """The image files of a directory, sorted by name."""
    return sorted(f for f in os.listdir(img_dir) if f.endswith(IMAGE_EXTS))


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average pose of an (N, 3, 5) LLFF stack (dataloading/common.py:189-197)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Express all poses relative to the average pose (common.py:176-188).
    Returns (recentered (N,3,5), the 4x4 average c2w used — needed for revert)."""
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom_n = np.tile(bottom[None], [poses.shape[0], 1, 1])
    poses_44 = np.concatenate([poses[:, :3, :4], bottom_n], -2)
    poses_44 = np.linalg.inv(c2w) @ poses_44
    poses_[:, :3, :4] = poses_44[:, :3, :4]
    return poses_, c2w


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Recenter about the point of minimal ray distance + unit-radius rescale
    (common.py:209-266). Returns (poses, render_poses, bds, sc, c2w_44)."""
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1], [1, 1, 4]), [p.shape[0], 1, 1])], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -A_i @ rays_o
        return np.squeeze(-np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0))
                          @ (b_i).mean(0))

    center = min_line_dist(rays_o, rays_d)
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)
    c2w_44 = p34_to_44(c2w[None])

    poses_reset = np.linalg.inv(c2w_44) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(max(rad ** 2 - zh ** 2, 0.0))
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1)
    return poses_reset, new_poses, bds, sc, c2w_44


def make_c2ws_from_llff(poses: np.ndarray, bds: np.ndarray, spherify: bool,
                        bd_factor: float = 0.75
                        ) -> Tuple[np.ndarray, int, int, float, Dict]:
    """LLFF (3, 5, N) + bounds (2, N) -> (c2ws (N,4,4), H, W, focal, reverse dict).

    The exact preprocessing chain of `DataField.make_c2ws_from_llff`
    (dataset.py:230-278): column swizzle, sc rescale, recenter, optional spherify,
    with every step recorded in `reverse` for the metric revert at eval.
    """
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None or bd_factor == "None" else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc
    poses, avg_c2w = recenter_poses(poses)

    reverse: Dict = {"sc": sc, "recenter": avg_c2w}
    if spherify:
        poses, _, bds, sc_sph, c2w_sph = spherify_poses(poses, bds)
        reverse["sc_spherify"] = sc_sph
        reverse["c2w_spherify"] = c2w_sph

    poses = poses.astype(np.float32)
    hwf = poses[0, :3, -1]
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    c2ws = np.concatenate(
        [poses[:, :3, :4],
         np.tile(np.asarray([[[0, 0, 0, 1]]], np.float32), [poses.shape[0], 1, 1])], 1)
    return c2ws, H, W, focal, reverse, bds


def load_llff_data(basedir: str, factor: Optional[int] = None,
                   load_gt_llff: bool = False, load_imgs: bool = True,
                   crop_size: int = 0):
    """Read poses_bounds.npy / poses_gt.npy + the image directory.

    Parity with `_load_data` (dataloading/common.py:82-174): LLFF rows are 3x5
    matrices [R|t|hwf] column-stacked; the last two floats per row are depth bounds.
    Minified image sets (images_{factor}/) are generated on demand with area
    resampling. With crop_size != 0 (black-border removal, common.py:96-114) an
    images_cropped/ set is generated first: crop_size rows (and crop_size*W/H
    columns) are cut from each border and the result is resized back to (W, H);
    minification then applies to the cropped set. Returns (poses (3,5,N),
    bds (2,N), imgs (N,H,W,3) float [0,1], img_names) — use `crop_factors` for
    the (crop_ratio, focal_crop_factor) pair of a crop_size.
    """
    fname = "poses_gt.npy" if load_gt_llff else "poses_bounds.npy"
    poses_arr = np.load(os.path.join(basedir, fname))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])  # 3x5xN
    bds = poses_arr[:, -2:].transpose([1, 0])

    img_dir = os.path.join(basedir, "images")
    names = list_images(img_dir)
    if crop_size != 0 and names:
        # keyed by crop_size: a cache generated under a different
        # dataloading.crop_size must not be silently reused (the K and depth
        # adjustments from crop_factors would no longer match the pixels)
        crop_dir = os.path.join(basedir, f"images_cropped_{crop_size}")
        if not os.path.isdir(crop_dir) or len(os.listdir(crop_dir)) < len(names):
            os.makedirs(crop_dir, exist_ok=True)
            for f in names:
                img = read_rgb8(os.path.join(img_dir, f))
                h0, w0 = img.shape[:2]
                ch, cw = crop_size, int(crop_size * w0 / h0)
                cropped = img[ch:h0 - ch, cw:w0 - cw]
                # resized back to the original size (common.py:110-111)
                write_png(os.path.join(crop_dir, f), resize_linear(cropped, (h0, w0)))
        img_dir = crop_dir
        names = list_images(img_dir)
    if not names:
        raise FileNotFoundError(f"no images under {img_dir}")

    factor = factor or 1
    if factor != 1:
        min_dir = f"{img_dir}_{factor}"  # images_{f} or images_cropped_{f}
        if not os.path.isdir(min_dir) or len(os.listdir(min_dir)) < len(names):
            os.makedirs(min_dir, exist_ok=True)
            for f in names:
                img = read_rgb8(os.path.join(img_dir, f))
                h, w = img.shape[:2]
                # Python's round, as the JAX package: 375 / 2 -> 188
                small = resize_area(img, (round(h / factor), round(w / factor)))
                out = os.path.splitext(f)[0] + ".png"
                write_png(os.path.join(min_dir, out), small)
        img_dir = min_dir
        names = list_images(img_dir)

    if poses.shape[-1] != len(names):
        raise ValueError(f"mismatch: {len(names)} images vs {poses.shape[-1]} poses")

    imgs = None
    if load_imgs:
        imgs = []
        for f in names:
            imgs.append(read_rgb8(os.path.join(img_dir, f)).astype(np.float32) / 255.0)
        imgs = np.stack(imgs)
        sh = imgs.shape[1:3]
        poses[:2, 4, :] = np.asarray(sh).reshape(2, 1)
        poses[2, 4, :] = poses[2, 4, :] / factor
    return poses, bds, imgs, names


def crop_factors(basedir: str, crop_size: int) -> Tuple[float, float]:
    """(crop_ratio, focal_crop_factor) for a border crop (common.py:112-114):
    crop_ratio = crop_size/H_orig drives the matching depth-map crop;
    focal_crop_factor = (H-2*crop)/H rescales the focal (crop+resize zooms in)."""
    if crop_size == 0:
        return 1.0, 1.0
    img_dir = os.path.join(basedir, "images")
    names = list_images(img_dir)
    if not names:
        raise FileNotFoundError(f"no images under {img_dir}")
    h0 = image_shape(os.path.join(img_dir, names[0]))[0]
    return crop_size / h0, (h0 - 2 * crop_size) / h0


def load_gt_depths(image_list: List[str], datadir: str, depth_scale: float = 1.0,
                   H: Optional[int] = None, W: Optional[int] = None,
                   reverse: Optional[Dict] = None, noise_mean: float = 0.0,
                   noise_std: float = 0.0, remove_sky: bool = False,
                   rng: Optional[np.random.RandomState] = None,
                   crop_ratio: float = 1.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """16-bit depth PNGs -> metric depths (+ validity masks), with the reference's
    degradation pipeline (dataloading/common.py:268-312): px->m conversion, additive
    gaussian noise (clamped >= 0), preprocessing rescale via `reverse`, sky removal
    at 600m, nearest-exact resize."""
    rng = rng or np.random.RandomState()
    depths, masks = [], []
    for image_name in image_list:
        frame_id = image_name.split(".")[0]
        depth_path = os.path.join(datadir, "depth", f"{frame_id}.png")
        if not os.path.exists(depth_path):
            raise FileNotFoundError(depth_path)
        depth = read_png(depth_path).astype(np.float32) * depth_scale

        if noise_std or noise_mean:
            depth = depth + rng.normal(noise_mean, noise_std, size=depth.shape)
        depth = np.maximum(depth, 0)

        factor = 1.0
        if reverse is not None:
            depth *= reverse["sc"]
            factor *= reverse["sc"]
            if reverse.get("sc_spherify") is not None:
                depth *= reverse["sc_spherify"]
                factor *= reverse["sc_spherify"]

        if crop_ratio != 1.0:
            # match the border crop applied to the images (common.py:293-297);
            # the H/W resize below restores the full resolution
            dh, dw = depth.shape
            ch, cw = int(dh * crop_ratio), int(dw * crop_ratio)
            depth = depth[ch:dh - ch, cw:dw - cw]

        if remove_sky:
            depth[depth > (600 * factor)] = 0

        mask = (depth > 0).astype(np.uint8)
        if H is not None:
            depth_r = resize_nearest_exact(depth, (H, W))
            mask_r = resize_nearest_exact(mask, (H, W))
            depth_r[mask_r < 0.5] = 0
            depths.append(depth_r)
            masks.append(mask_r > 0.5)
        else:
            depths.append(depth)
            masks.append(mask > 0.5)
    return np.stack(depths).astype(np.float32), np.stack(masks)


def load_depths_npz(image_list: List[str], datadir: str,
                    H: Optional[int] = None, W: Optional[int] = None,
                    norm: bool = False) -> np.ndarray:
    """Precomputed DPT depth npzs (depth_<frame>.npz['pred']) with optional global
    median/MAD renormalization (dataloading/common.py:340-365); with H, W set,
    bilinear resize (the default of cv2's resize)."""
    depths = []
    for image_name in image_list:
        frame_id = image_name.split(".")[0]
        d = np.load(os.path.join(datadir, f"depth_{frame_id}.npz"))["pred"]
        if d.ndim == 3 and d.shape[0] == 1:
            d = d[0]
        if H is not None:
            d = resize_linear(d, (H, W))
        depths.append(d)
    depths = np.stack(depths).astype(np.float32)
    if norm:
        t_all = np.median(depths)
        s_all = np.mean(np.abs(depths - t_all))
        out = []
        for d in depths:
            t_i = np.median(d)
            s_i = np.mean(np.abs(d - t_i))
            out.append(s_all * (d - t_i) / s_i + t_all)
        depths = np.stack(out)
    return depths
