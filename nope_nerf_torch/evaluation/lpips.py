"""LPIPS (VGG16 backbone), the reference's perceptual image metric, in PyTorch.

Port of nope_nerf_tpu/evaluation/lpips.py: `lpips_lib.LPIPS(net='vgg')` as the
reference builds it (evaluation/eval.py:166) and calls it
(model/eval_images.py:99-101), lpips package version 0.1:

  1. ScalingLayer: x -> (x - shift) / scale with the package's constants. The
     reference feeds [0, 1] images without lpips' normalize flag, so the
     scaling layer sees [0, 1], not [-1, 1]; so does this.
  2. The VGG16 conv stack (13 3x3 convs, a floor-mode 2x2/2 max pool before
     conv positions 2, 4, 7 and 10), tapped after the ReLUs at relu1_2,
     relu2_2, relu3_3, relu4_3 and relu5_3 (64/128/256/512/512 channels).
  3. Per tap: unit normalisation along channels (1e-10 added to the norm,
     outside the sqrt), squared difference, the learned 1x1 lin head as a
     weighted channel sum, spatial mean.
  4. The sum over the five taps.

The convs are F.conv2d in float32 (TF32 off): the JAX package computes them
with lax.conv_general_dilated, no Pallas kernel. The two images go through
the stack one at a time, so identical images give exactly 0.

Weights come from `extract_images.lpips_weights`: an .npz that
`convert_torch_lpips` merged from torchvision's VGG16 state dict and the lpips
package's lin weights, or a torch .pt / .pth holding one merged state dict
(`features.<i>.weight/bias` and `lin<k>.weight` or `lin<k>.model.1.weight`).
Without a weight file `get_lpips_fn` returns None and LPIPS is reported as
n/a. The JAX package then falls back to torchvision's pretrained VGG16 with
unit lin weights; that needs weights no machine of this repo has (and
torchvision, which neither has), so the port does not carry that fallback.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device

# torchvision `features` indices of the 13 VGG16 convolutions.
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
# positions (in conv order) preceded by a 2x2/2 max-pool
_POOL_BEFORE = (2, 4, 7, 10)
# positions (in conv order) whose relu output is an LPIPS tap
_TAPS = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)

# lpips.ScalingLayer constants (lpips/lpips.py).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

Params = Dict[str, torch.Tensor]


def _vgg_taps(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    for j, idx in enumerate(VGG16_CONV_IDX):
        if j in _POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(F.conv2d(x, params[f"features.{idx}.weight"],
                            params[f"features.{idx}.bias"], padding=1))
        if j in _TAPS:
            feats.append(x)
    return feats


def lpips_pair(params: Params, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [0, 1] (the reference's
    input convention), on the device of `params`. Returns a 0-d tensor."""
    w0 = params["features.0.weight"]
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=w0.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=w0.device).reshape(1, 3, 1, 1)

    def prep(img):
        x = img.to(device=w0.device, dtype=torch.float32).permute(2, 0, 1)[None]
        return (x - shift) / scale

    fa = _vgg_taps(params, prep(img_a))
    fb = _vgg_taps(params, prep(img_b))
    dist = torch.zeros((), dtype=torch.float32, device=w0.device)
    for k, (xa, xb) in enumerate(zip(fa, fb)):
        na = xa / (torch.sqrt(torch.sum(xa * xa, dim=1, keepdim=True)) + 1e-10)
        nb = xb / (torch.sqrt(torch.sum(xb * xb, dim=1, keepdim=True)) + 1e-10)
        w = params[f"lin{k}.weight"].reshape(1, -1, 1, 1)
        dist = dist + torch.mean(torch.sum(w * (na - nb) ** 2, dim=1))
    return dist


def lpips_flops(h: int, w: int) -> int:
    """Multiply-add FLOPs (2 per product) of the VGG16 convs of one LPIPS pair of
    h x w images (both images through the 13 convs); the normalisation and
    the lin heads' channel sums are left out."""
    total, c_in = 0, 3
    for j, c_out in enumerate(VGG16_CHANNELS):
        if j in _POOL_BEFORE:
            h, w = h // 2, w // 2
        total += 2 * 2 * c_in * c_out * 9 * h * w
        c_in = c_out
    return total


def _as_numpy_state_dict(obj) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in dict(obj).items()}


def load_lpips_params(path: str, device: DeviceLike = None) -> Params:
    """LPIPS params from an .npz or a merged torch state dict (.pt / .pth), as
    float32 tensors on `device`. Lin keys may be `lin<k>.weight` or the lpips
    package's `lin<k>.model.1.weight`."""
    dev = resolve_device(device)
    if path.endswith(".npz"):
        with np.load(path) as data:
            raw = {k: data[k] for k in data.files}
    else:
        raw = _as_numpy_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    params = {k.replace(".model.1.weight", ".weight"):
              torch.as_tensor(np.asarray(v, np.float32), device=dev) for k, v in raw.items()}
    _validate(params)
    return params


def _validate(params: Params) -> None:
    for idx in VGG16_CONV_IDX:
        for suffix in ("weight", "bias"):
            key = f"features.{idx}.{suffix}"
            if key not in params:
                raise KeyError(f"LPIPS weights missing {key}")
    for k, c in enumerate(TAP_CHANNELS):
        key = f"lin{k}.weight"
        if key not in params:
            raise KeyError(f"LPIPS weights missing {key}")
        if int(np.prod(params[key].shape)) != c:
            raise ValueError(f"{key} must have {c} elements, "
                             f"got shape {tuple(params[key].shape)}")


def convert_torch_lpips(vgg16_path: str, lpips_path: str, out_npz: str) -> None:
    """Merge a torchvision VGG16 state dict and the lpips package's vgg.pth lin
    weights into the .npz this module loads."""
    vgg = _as_numpy_state_dict(torch.load(vgg16_path, map_location="cpu", weights_only=True))
    lin = _as_numpy_state_dict(torch.load(lpips_path, map_location="cpu", weights_only=True))
    merged: Dict[str, np.ndarray] = {}
    for idx in VGG16_CONV_IDX:
        for suffix in ("weight", "bias"):
            merged[f"features.{idx}.{suffix}"] = vgg[f"features.{idx}.{suffix}"]
    for k in range(5):
        src = (f"lin{k}.model.1.weight" if f"lin{k}.model.1.weight" in lin
               else f"lin{k}.weight")
        merged[f"lin{k}.weight"] = lin[src]
    np.savez(out_npz, **merged)


# --- the metric the eval pipeline calls (image_eval.eval_image) --------------

_WEIGHTS_PATH: Optional[str] = None
_DEVICE: DeviceLike = None


def set_lpips_weights(path: Optional[str], device: DeviceLike = None) -> None:
    """Point the eval pipeline at an LPIPS weight file (config
    extract_images.lpips_weights) and the device the metric runs on (CUDA
    unless told otherwise). Clears the cached metric."""
    global _WEIGHTS_PATH, _DEVICE
    _WEIGHTS_PATH, _DEVICE = path, device
    get_lpips_fn.cache_clear()


@functools.lru_cache(maxsize=1)
def get_lpips_fn() -> Optional[Callable[[np.ndarray, np.ndarray], float]]:
    """Callable (a, b) -> float on two (H, W, 3) host images, or None when no
    weight file is configured (or it does not exist)."""
    if not (_WEIGHTS_PATH and os.path.exists(_WEIGHTS_PATH)):
        return None
    params = load_lpips_params(_WEIGHTS_PATH, _DEVICE)

    def fn(a: np.ndarray, b: np.ndarray) -> float:
        with torch.inference_mode():
            return float(lpips_pair(params, torch.from_numpy(np.ascontiguousarray(a)),
                                    torch.from_numpy(np.ascontiguousarray(b))))

    return fn
