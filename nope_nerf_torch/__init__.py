"""PyTorch/CUDA port of nope_nerf_tpu.

The JAX package `nope_nerf_tpu` stays the reference; this package computes the
same functions with PyTorch tensors and, on an NVIDIA Hopper card, with
kernels written by hand for it (`csrc/`). It imports neither JAX nor
`nope_nerf_tpu`.

Entry points run on CUDA unless the caller passes ``device="cpu"``; they never
fall back to the CPU on their own. Geometry products must be exact float32,
so TF32 is switched off for matmuls and convolutions when the package loads.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device; raises when no CUDA device is present.

    A caller that wants the CPU says so with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
