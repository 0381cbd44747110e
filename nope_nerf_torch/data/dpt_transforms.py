"""DPT input transforms: keep-aspect lower-bound resize to 384 px, multiple-of-32
snap, [-1, 1] normalisation.

Port of nope_nerf_tpu/data/dpt_transforms.py (reference DPT/dpt/transforms.py
Resize with resize_method 'lower_bound' and keep_aspect_ratio, NormalizeImage
with mean and std 0.5, as dataloading/dataloading.py:84-104 configures it).
The bicubic resize is data/image_io.py::resize_cubic, cv2's INTER_CUBIC on a
float32 image, since the card's machine has no cv2. V-KITTI's 188x621 frames
go into the net at 384x1280, fern's 756x1008 at 384x512.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .image_io import resize_cubic

DPT_MEAN = 0.5
DPT_STD = 0.5


def _constrain_to_multiple_of(x: float, multiple_of: int = 32,
                              min_val: float = 0, max_val: float = None) -> int:
    y = (np.round(x / multiple_of) * multiple_of).astype(int)
    if max_val is not None and y > max_val:
        y = (np.floor(x / multiple_of) * multiple_of).astype(int)
    if y < min_val:
        y = (np.ceil(x / multiple_of) * multiple_of).astype(int)
    return int(y)


def dpt_target_size(h: int, w: int, target: int = 384) -> Tuple[int, int]:
    """lower_bound keep-aspect target (transforms.py:108-152): scale so the
    smaller side reaches `target`, then snap both to multiples of 32 (never
    below target)."""
    scale_h = target / h
    scale_w = target / w
    if scale_w > scale_h:
        scale_h = scale_w
    else:
        scale_w = scale_h
    new_h = _constrain_to_multiple_of(scale_h * h, min_val=target)
    new_w = _constrain_to_multiple_of(scale_w * w, min_val=target)
    return new_h, new_w


def prepare_dpt_input(img: np.ndarray, target: int = 384) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> (h, w, 3) normalised float32 for the DPT net
    (transposed to (3, h, w) by its caller)."""
    h, w = img.shape[:2]
    resized = resize_cubic(img.astype(np.float32), dpt_target_size(h, w, target))
    return ((resized - DPT_MEAN) / DPT_STD).astype(np.float32)
