"""Per-view evaluation artifacts on disk.

Port of nope_nerf_tpu/evaluation/artifacts.py, used only when the eval CLI
saves. Every PNG goes through the port's own writer (data/image_io.py);
cv2 (the INFERNO disparity maps), matplotlib (the error scatter) and imageio
(the video) are imported inside the functions, and where one is missing its
artifact is skipped with a printed message, so evaluation saves its images on
a machine without them.

The reference's evaluation outputs: per-view rendered/GT
image pngs, min-max-normalized depth pngs, INFERNO-colormapped disparity pngs,
validity-mask pngs (rendered/gt/combined) plus green-highlighted masked depth
images, a depth-error classification scatter for the first view
(`model/eval_images.py:104-198`), and the eval video
(`evaluation/eval.py:215-227`, mp4 with GIF fallback when no ffmpeg backend).

All inputs are host numpy arrays; nothing here touches the accelerator.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..data.image_io import write_png


def _norm8(x: np.ndarray) -> np.ndarray:
    """255/max * (x - min), clipped to [0, 255] (eval_images.py:132-133)."""
    m = float(x.max())
    scale = 255.0 / m if m > 0 else 0.0
    return np.clip(scale * (x - x.min()), 0, 255).astype(np.uint8)


def write_view_artifacts(render_dir: str, idx: int,
                         img_out: np.ndarray, img_gt: np.ndarray,
                         depth_out: Optional[np.ndarray] = None,
                         depth_gt: Optional[np.ndarray] = None,
                         min_depth: float = 0.1, max_depth: float = 20.0,
                         show_errors: bool = False) -> np.ndarray:
    """Write one view's png set under `render_dir` (eval_images.py:109-198).

    `depth_out` must already be at metric scale and GT resolution. Returns the
    uint8 rendered image for video assembly.
    """
    img_out8 = (np.clip(img_out, 0.0, 1.0) * 255).astype(np.uint8)
    img_gt8 = (np.clip(img_gt, 0.0, 1.0) * 255).astype(np.uint8)
    name = f"{idx:04d}.png"

    def _dir(sub: str) -> str:
        d = os.path.join(render_dir, sub)
        os.makedirs(d, exist_ok=True)
        return d

    write_png(os.path.join(_dir("img_out"), name), img_out8)
    write_png(os.path.join(_dir("img_gt_out"), name), img_gt8)
    if depth_out is None or depth_gt is None:
        return img_out8

    depth_img = _norm8(depth_out)
    depth_img_gt = _norm8(depth_gt)
    write_png(os.path.join(_dir("depth_out"), name), depth_img)
    write_png(os.path.join(_dir("depth_gt_out"), name), depth_img_gt)

    # disparity frames for better contrast (eval_images.py:139-150); guard the
    # reference's bare 1/depth against zero-depth pixels
    try:
        import cv2
    except ImportError:
        print(f"view {idx}: no cv2, no INFERNO disparity maps")
    else:
        disp_out = np.where(depth_out > 0, 1.0 / np.maximum(depth_out, 1e-12), 0.0)
        disp_gt = np.where(depth_gt > 0, 1.0 / np.maximum(depth_gt, 1e-12), 0.0)
        cv2.imwrite(os.path.join(_dir("disp_out"), name),
                    cv2.applyColorMap(_norm8(disp_out), cv2.COLORMAP_INFERNO))
        cv2.imwrite(os.path.join(_dir("disp_gt_out"), name),
                    cv2.applyColorMap(_norm8(disp_gt), cv2.COLORMAP_INFERNO))

    mask_rendered = (depth_out >= min_depth) & (depth_out <= max_depth)
    mask_gt = (depth_gt >= min_depth) & (depth_gt <= max_depth)
    mask = mask_rendered & mask_gt
    mdir = _dir("depth_mask")
    stem = f"{idx:04d}"
    write_png(os.path.join(mdir, stem + "_mask_rendered.png"),
              (255 * mask_rendered).astype(np.uint8))
    write_png(os.path.join(mdir, stem + "_mask_gt.png"), (255 * mask_gt).astype(np.uint8))
    write_png(os.path.join(mdir, stem + "_mask_combined.png"), (255 * mask).astype(np.uint8))

    # unused pixels green, used pixels keep grayscale (eval_images.py:180-193)
    def _masked_green(d8: np.ndarray) -> np.ndarray:
        rb = d8.copy()
        g = d8.copy()
        rb[~mask] = 0
        g[~mask] = 255
        return np.stack((rb, g, rb), axis=-1)

    write_png(os.path.join(mdir, stem + "_gt.png"), _masked_green(depth_img_gt))
    write_png(os.path.join(mdir, stem + ".png"), _masked_green(depth_img))

    if show_errors:
        _write_error_scatter(render_dir, stem, depth_out, depth_gt,
                             mask_rendered, mask_gt)
    return img_out8


def _write_error_scatter(render_dir: str, stem: str,
                         depth_out: np.ndarray, depth_gt: np.ndarray,
                         mask_rendered: np.ndarray, mask_gt: np.ndarray) -> None:
    """Per-pixel depth-error scatter colored by the validity confusion class
    (eval_images.py:164-177); reference writes it only for the first view."""
    try:
        import matplotlib
    except ImportError:
        print(f"view {stem}: no matplotlib, no depth-error scatter")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    err = (depth_gt - depth_out).reshape(-1)
    px = np.arange(err.size)
    tp = (mask_rendered & mask_gt).reshape(-1)
    tn = (~mask_rendered & ~mask_gt).reshape(-1)
    fp = (mask_rendered & ~mask_gt).reshape(-1)
    fn = (~mask_rendered & mask_gt).reshape(-1)
    plt.figure()
    plt.xlim(0, max(err.size - 1, 1))
    plt.scatter(px[tp], err[tp], 1, "r")
    plt.scatter(px[tn], err[tn], 1, "g")
    plt.scatter(px[fp], err[fp], 1, "b")
    plt.scatter(px[fn], err[fn], 1, "k")
    plt.legend(["True Positive", "True Negative",
                "False Positive", "False Negative"])
    plt.xlabel("Pixel Index")
    plt.ylabel("GT Depth - Predicted Depth (m)")
    plt.title("Classification of Depth Errors")
    plt.savefig(os.path.join(render_dir, stem + "_conf.png"))
    plt.close()


def write_eval_video(render_dir: str, frames: List[np.ndarray],
                     fps: int = 30) -> Optional[str]:
    """`video_out/img.mp4` over the eval views (evaluation/eval.py:222-227);
    falls back to GIF when imageio has no ffmpeg backend, and writes nothing
    (None) without imageio."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        print("no imageio: no eval video")
        return None

    vdir = os.path.join(render_dir, "video_out")
    os.makedirs(vdir, exist_ok=True)
    arr = np.stack(frames, axis=0)
    try:
        path = os.path.join(vdir, "img.mp4")
        imageio.mimwrite(path, arr, fps=fps, quality=9)
    except Exception:
        path = os.path.join(vdir, "img.gif")
        # integer milliseconds, like extract.py's duration=33 — a float here is
        # read as seconds-per-frame by some installed imageio GIF writers
        imageio.mimwrite(path, arr, duration=int(round(1000.0 / fps)), loop=0)
    return path
