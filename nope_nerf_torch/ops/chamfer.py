"""Bidirectional Chamfer (point-to-point) loss.

Port of nope_nerf_tpu/ops/chamfer.py::chamfer_loss and of the nearest-neighbour
sweep nope_nerf_tpu/ops/pallas_chamfer.py::_bidir_kernel (K2). For each point
of one cloud the nearest point of the other is found by one sweep over the
(S, D) squared distances that serves both directions; the loss then recomputes
the exact f32 distance of every matched pair, and the gradient flows through
that gather alone (the indices are constants).

On a CUDA tensor `nearest_idx_bidirectional` launches the hand-written kernel
`nope_nerf_torch/csrc/chamfer_bidir.cu`, or raises; on a CPU tensor it runs
`nearest_idx_bidirectional_plain`, the same packed-integer formulation in
plain PyTorch. On this card the one kernel stands for both JAX routes (the
Pallas kernel and the XLA scan of ops/chamfer.py).

Near-ties: d^2 keeps 10 of its 23 mantissa bits in the packed key, so among
candidates whose d^2 agree to 2^-10 the lower index wins. The loss is exact
for whichever winner, and its error is bounded by the tie gap.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.safemath import safe_norm
from ._build import CudaLibrary, runs_plain

IDX_BITS = 13                    # index field of the packed (d2, idx) int32
IDX_MASK = (1 << IDX_BITS) - 1
MAX_POINTS = 1 << IDX_BITS       # 8,192 points per cloud
INT_MAX = 2 ** 31 - 1
PLAIN_CHUNK = 512                # y rows per block of the plain version


def _setup(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.chamfer_bidir.argtypes = [p, p, p, p, i, i, p]
    lib.chamfer_bidir.restype = ctypes.c_int
    lib.chamfer_error_string.argtypes = [ctypes.c_int]
    lib.chamfer_error_string.restype = ctypes.c_char_p


CHAMFER_BIDIR = CudaLibrary("chamfer_bidir.cu", _setup)


def _check_clouds(x: torch.Tensor, y: torch.Tensor) -> None:
    for name, t in (("x", x), ("y", y)):
        if t.ndim != 2 or t.shape[1] != 3 or t.shape[0] == 0:
            raise ValueError(f"{name} must be a non-empty (N, 3) cloud, got {tuple(t.shape)}")
    if x.device != y.device:
        raise ValueError("both clouds must be on the same device")


def _packed_d2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(S, T) int32: the f32 bits of max(d2, 0) with the low IDX_BITS cleared.
    d2 = |x|^2 + |y|^2 - 2<x,y> summed in the order of the augmented product
    [x, |x|^2, 1] . [-2y, 1, |y|^2] (pallas_chamfer.py::_aug8)."""
    xsq = (x * x).sum(dim=1, keepdim=True)
    ysq = (y * y).sum(dim=1)
    y2 = -2.0 * y
    d2 = x[:, 0:1] * y2[:, 0]
    d2 = d2 + x[:, 1:2] * y2[:, 1]
    d2 = d2 + x[:, 2:3] * y2[:, 2]
    d2 = (d2 + xsq) + ysq
    return d2.clamp_min(0.0).view(torch.int32) & ~IDX_MASK


def nearest_idx_bidirectional_plain(x: torch.Tensor, y: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sweep, on any device and for any cloud
    size: (argmin_y d(x_i, y) (S,), argmin_x d(y_j, x) (D,)) as int64. Min and
    argmin are one integer min of (d2 bits | index) per direction, in chunks
    of y; beyond 8,192 points the index no longer fits beside the d2 bits in
    32 bits, so the key is widened to int64 with the same d2 bits."""
    _check_clouds(x, y)
    x = x.detach().to(torch.float32)
    y = y.detach().to(torch.float32)
    s, d = x.shape[0], y.shape[0]
    shift = max(IDX_BITS, (max(s, d) - 1).bit_length())
    row_id = torch.arange(s, device=x.device, dtype=torch.int64)[:, None]
    best_row = torch.full((s,), torch.iinfo(torch.int64).max, device=x.device)
    cols = []
    for c0 in range(0, d, PLAIN_CHUNK):
        yc = y[c0:c0 + PLAIN_CHUNK]
        key = (_packed_d2(x, yc).to(torch.int64) >> IDX_BITS) << shift
        col_id = torch.arange(c0, c0 + yc.shape[0], device=x.device, dtype=torch.int64)
        best_row = torch.minimum(best_row, (key | col_id).amin(dim=1))
        cols.append((key | row_id).amin(dim=0))
    mask = (1 << shift) - 1
    return best_row & mask, torch.cat(cols) & mask


def _nearest_idx_cuda(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s, d = x.shape[0], y.shape[0]
    if max(s, d) > MAX_POINTS:
        raise NotImplementedError(
            f"the CUDA Chamfer kernel takes clouds of at most {MAX_POINTS} points, got "
            f"{s} and {d}; the sweep for larger clouds comes with the slice of the port that "
            "brings K7 (pallas_chamfer.py::_kernel)")
    x = x.detach().to(torch.float32).contiguous()
    y = y.detach().to(torch.float32).contiguous()
    lib = CHAMFER_BIDIR.lib()
    row = torch.full((s,), INT_MAX, dtype=torch.int32, device=x.device)
    col = torch.full((d,), INT_MAX, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.chamfer_bidir(x.data_ptr(), y.data_ptr(), row.data_ptr(), col.data_ptr(),
                                s, d, stream)
    if err != 0:
        raise RuntimeError("chamfer kernel launch failed: "
                           + lib.chamfer_error_string(err).decode())
    CHAMFER_BIDIR.launches += 1
    return (row & IDX_MASK).to(torch.int64), (col & IDX_MASK).to(torch.int64)


def nearest_idx_bidirectional(x: torch.Tensor, y: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmin_y d(x_i, y) (S,), argmin_x d(y_j, x) (D,)) as int64 index
    tensors, without gradient. A CUDA tensor goes through the hand-written
    kernel (clouds of at most 8,192 points); a CPU tensor, and any tensor
    inside `plain_versions()`, through the plain version."""
    _check_clouds(x, y)
    if runs_plain(x):
        return nearest_idx_bidirectional_plain(x, y)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no Chamfer kernel for device {x.device}")
    return _nearest_idx_cuda(x, y)


def chamfer_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean_nn(x->y) + mean_nn(y->x), scalar (reference `get_pc_loss`,
    losses.py:116-123, match_method='dense'). safe_norm: exactly coincident
    pairs would otherwise NaN the pose and distortion gradients."""
    idx_xy, idx_yx = nearest_idx_bidirectional(x, y)
    d_x = safe_norm(x - y[idx_xy], dim=-1)
    d_y = safe_norm(y - x[idx_yx], dim=-1)
    return d_x.mean() + d_y.mean()
