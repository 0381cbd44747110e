"""Bidirectional Chamfer (point-to-point) loss and the one-direction
nearest-neighbour distance.

Port of nope_nerf_tpu/ops/chamfer.py::chamfer_loss and nearest_dists, and of
the two nearest-neighbour sweeps of nope_nerf_tpu/ops/pallas_chamfer.py:
`_bidir_kernel` (K2) and `_kernel` (K7). The loss recomputes the exact f32
distance of every matched pair, and the gradient flows through that gather
alone (the indices are constants).

Two sweeps, chosen by cloud size on every device (the JAX gate of
ops/chamfer.py:202), so that the CPU runs the route the card runs:
- clouds of at most 8,192 points: `nearest_idx_bidirectional`, one sweep over
  the (S, D) squared distances that serves both directions; on a CUDA tensor
  the hand-written kernel `csrc/chamfer_bidir.cu` (K2), on a CPU tensor
  `nearest_idx_bidirectional_plain`, the same packed-integer formulation.
  Near-ties: d^2 keeps 10 of its 23 mantissa bits in the packed key, so among
  candidates whose d^2 agree to 2^-10 the lower index wins. The loss is exact
  for whichever winner, and its error is bounded by the tie gap.
- larger clouds: `nearest_idx` once per direction; on a CUDA tensor the
  hand-written kernel `csrc/chamfer_nearest.cu` (K7), on a CPU tensor
  `nearest_idx_plain`. d^2 is f32 with the lowest index winning exact ties,
  and the kernel's d^2 is bit-equal to the plain version's. The JAX package
  picks these winners from bf16 distances, so on general clouds the two differ
  among near-ties; on clouds without near-ties they agree.
A CUDA tensor never falls back to a plain version: the wrapper launches its
kernel or raises. Both kernels split their sweep over the whole card and merge
per-block partials in a second, small launch; the launch geometry is computed
here (`nearest_geometry`, `bidir_geometry`), where the CPU tests reach it, and
checked again by the C entry points. On this card the two kernels stand for
the Pallas kernels and the XLA scans alike, and `nearest_dists` for both JAX
routes of the one-direction distance (ops/chamfer.py:53 and
nearest_dists_pallas).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..utils.safemath import safe_norm
from ._build import CudaLibrary, runs_plain

IDX_BITS = 13                    # index field of the packed (d2, idx) int32
IDX_MASK = (1 << IDX_BITS) - 1
MAX_POINTS = 1 << IDX_BITS       # 8,192 points per cloud
PLAIN_CHUNK = 512                # y rows per block of the plain versions

# Launch geometry of the two kernels; the tiles are their sources' constants
# (chamfer_nearest.cu: kSrcTile, kSegMax; chamfer_bidir.cu: kTileX, kTileY, kSubMax),
# which the C entry points check.
CARD_SMS = 132                   # SMs of an H100 SXM
TARGET_BLOCKS = 8 * CARD_SMS     # grids of about 8 blocks per SM
NEAREST_SRC_TILE = 1024          # src points per K7 sweep block: 128 threads x 8
NEAREST_SEG_MAX = 1024           # dst points per K7 segment (16 KB of shared memory)
NEAREST_SEG_MIN = 64             # ... and at least this many, where the cloud has them
NEAREST_SEGS_MAX = 2 * CARD_SMS  # segments the merge walks at most, per src point
BIDIR_X_TILE = 128               # x rows per K2 block: 16 threads x 8 rows
BIDIR_Y_TILE = 128               # y points per K2 sub-tile: 16 threads x 8 columns
BIDIR_SUB_MAX = 8                # sub-tiles per K2 y segment (16 KB of shared memory)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class NearestGeometry(NamedTuple):
    """K7's grid: src in tiles of `src_tile` points (blockIdx.x), dst in
    `n_segs` segments of `seg_len` points, the last one ragged (blockIdx.y);
    the merge reads `n_segs` x S partials of (d2, index)."""
    src_tile: int
    src_tiles: int
    seg_len: int
    n_segs: int

    @property
    def blocks(self) -> int:
        return self.src_tiles * self.n_segs

    def scratch(self, s: int) -> int:
        """Entries of each partial array (f32 d2 and int32 index)."""
        return self.n_segs * s


def nearest_geometry(s: int, d: int) -> NearestGeometry:
    """Segments short enough for about TARGET_BLOCKS blocks, at most
    NEAREST_SEGS_MAX of them (a small src cloud gets its blocks from the
    segments alone: 264 at 5 x 40,000), none longer than NEAREST_SEG_MAX nor,
    unless dst is shorter, than NEAREST_SEG_MIN (a segment amortises its
    staging and the merge's step over that many points at least)."""
    if s <= 0 or d <= 0:
        raise ValueError(f"empty cloud: {s} x {d}")
    src_tiles = _cdiv(s, NEAREST_SRC_TILE)
    want = min(_cdiv(TARGET_BLOCKS, src_tiles), NEAREST_SEGS_MAX)
    seg_len = min(NEAREST_SEG_MAX, d, max(NEAREST_SEG_MIN, _cdiv(d, want)))
    return NearestGeometry(NEAREST_SRC_TILE, src_tiles, seg_len, _cdiv(d, seg_len))


class BidirGeometry(NamedTuple):
    """K2's grid: x in tiles of `x_tile` rows (blockIdx.x), y in `n_segs`
    segments of `sub_per_seg` sub-tiles of `y_tile` points (blockIdx.y).
    Scratch: n_segs x S row partials, then x_tiles x D column partials (int32)."""
    x_tile: int
    y_tile: int
    x_tiles: int
    sub_per_seg: int
    n_segs: int

    @property
    def blocks(self) -> int:
        return self.x_tiles * self.n_segs

    def scratch(self, s: int, d: int) -> int:
        return self.n_segs * s + self.x_tiles * d


def bidir_geometry(s: int, d: int) -> BidirGeometry:
    """As many sub-tiles per segment as keep about TARGET_BLOCKS blocks (at
    least 1, at most BIDIR_SUB_MAX): 57 x 19 blocks of 3 sub-tiles at 7,285^2."""
    if s <= 0 or d <= 0:
        raise ValueError(f"empty cloud: {s} x {d}")
    x_tiles, y_tiles = _cdiv(s, BIDIR_X_TILE), _cdiv(d, BIDIR_Y_TILE)
    sub = max(1, min(BIDIR_SUB_MAX, x_tiles * y_tiles // TARGET_BLOCKS))
    return BidirGeometry(BIDIR_X_TILE, BIDIR_Y_TILE, x_tiles, sub, _cdiv(y_tiles, sub))


def _setup(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.chamfer_bidir.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.chamfer_bidir.restype = ctypes.c_int
    lib.chamfer_error_string.argtypes = [ctypes.c_int]
    lib.chamfer_error_string.restype = ctypes.c_char_p


def _setup_nearest(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.chamfer_nearest.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.chamfer_nearest.restype = ctypes.c_int
    lib.chamfer_nearest_error_string.argtypes = [ctypes.c_int]
    lib.chamfer_nearest_error_string.restype = ctypes.c_char_p


CHAMFER_BIDIR = CudaLibrary("chamfer_bidir.cu", _setup)
CHAMFER_NEAREST = CudaLibrary("chamfer_nearest.cu", _setup_nearest)


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


def _bidir_buffers(x: torch.Tensor, y: torch.Tensor):
    """What K2's C entry point takes besides the clouds: its geometry, the
    int32 partials (no fill: the sweep writes every entry) and the int64
    output, argmin_y for each x then argmin_x for each y."""
    s, d = x.shape[0], y.shape[0]
    geo = bidir_geometry(s, d)
    scratch = torch.empty((geo.scratch(s, d),), dtype=torch.int32, device=x.device)
    out = torch.empty((s + d,), dtype=torch.int64, device=x.device)
    return geo, scratch, out


def _check_launchable(*clouds: torch.Tensor) -> None:
    for t in clouds:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the Chamfer kernels take contiguous float32 clouds")


def _bidir_launch(x: torch.Tensor, y: torch.Tensor, geo: BidirGeometry,
                  scratch: torch.Tensor, out: torch.Tensor) -> None:
    """The bare C call: K2's sweep and finishing launch on the current stream;
    counts nothing."""
    _check_launchable(x, y)
    lib = CHAMFER_BIDIR.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.chamfer_bidir(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                                x.shape[0], y.shape[0], geo.x_tile, geo.y_tile, geo.sub_per_seg,
                                stream)
    if err != 0:
        raise RuntimeError("chamfer kernel launch failed: "
                           + lib.chamfer_error_string(err).decode())


def _nearest_idx_cuda(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s, d = x.shape[0], y.shape[0]
    if max(s, d) > MAX_POINTS:
        raise NotImplementedError(
            f"the bidirectional CUDA Chamfer kernel takes clouds of at most {MAX_POINTS} "
            f"points, got {s} and {d}; chamfer_loss sends larger clouds through nearest_idx "
            "(the one-direction kernel, chamfer_nearest.cu) once per direction")
    x = x.detach().to(torch.float32).contiguous()
    y = y.detach().to(torch.float32).contiguous()
    geo, scratch, out = _bidir_buffers(x, y)
    _bidir_launch(x, y, geo, scratch, out)
    CHAMFER_BIDIR.launches += 1
    return out[:s], out[s:]


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


def nearest_idx_plain(src: torch.Tensor, dst: torch.Tensor, chunk: int = PLAIN_CHUNK
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7, on any device and for any cloud size:
    (min_j d2(src_i, dst_j) (S,) f32, its argmin (S,) int64), with
    d2 = (|x|^2 + |y|^2) - 2<x,y> not clamped. Each product and sum is its own
    elementwise op, in the kernel's order (no reduction or matmul, whose order
    is unspecified), so the kernel's d2 is bit-equal to this one's. In chunks
    of `chunk` dst points: the lowest index wins within a chunk (min's first
    index) and a strict < keeps the earlier chunk's winner across chunks, so
    the result is the same at every chunk length, the kernel's segments
    included."""
    _check_clouds(src, dst)
    x = src.detach().to(torch.float32)
    y = dst.detach().to(torch.float32)
    x0, x1, x2 = x[:, 0:1], x[:, 1:2], x[:, 2:3]
    xsq = (x0 * x0 + x1 * x1) + x2 * x2
    best = torch.full((x.shape[0],), float("inf"), device=x.device)
    best_i = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    for c0 in range(0, y.shape[0], chunk):
        yc = y[c0:c0 + chunk]
        y0, y1, y2 = yc[:, 0], yc[:, 1], yc[:, 2]
        ysq = (y0 * y0 + y1 * y1) + y2 * y2
        dot = (x0 * y0 + x1 * y1) + x2 * y2
        m, a = ((xsq + ysq) - 2.0 * dot).min(dim=1)
        take = m < best
        best = torch.where(take, m, best)
        best_i = torch.where(take, a + c0, best_i)
    return best, best_i


def _nearest_buffers(src: torch.Tensor, dst: torch.Tensor):
    """What K7's C entry point takes besides the clouds: its geometry, the
    partials (d2 f32, index int32; no fill: the sweep writes every entry) and
    the outputs d2 (S,) f32, index (S,) int64."""
    s, d = src.shape[0], dst.shape[0]
    geo = nearest_geometry(s, d)
    part_d2 = torch.empty((geo.scratch(s),), dtype=torch.float32, device=src.device)
    part_idx = torch.empty((geo.scratch(s),), dtype=torch.int32, device=src.device)
    d2 = torch.empty((s,), dtype=torch.float32, device=src.device)
    idx = torch.empty((s,), dtype=torch.int64, device=src.device)
    return geo, part_d2, part_idx, d2, idx


def _nearest_launch(src: torch.Tensor, dst: torch.Tensor, geo: NearestGeometry,
                    part_d2: torch.Tensor, part_idx: torch.Tensor, d2: torch.Tensor,
                    idx: torch.Tensor) -> None:
    """The bare C call: K7's sweep and merge launches on the current stream;
    counts nothing."""
    _check_launchable(src, dst)
    lib = CHAMFER_NEAREST.lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.chamfer_nearest(src.data_ptr(), dst.data_ptr(), part_d2.data_ptr(),
                                  part_idx.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                                  src.shape[0], dst.shape[0], geo.src_tile, geo.seg_len,
                                  geo.n_segs, stream)
    if err != 0:
        raise RuntimeError("chamfer_nearest kernel launch failed: "
                           + lib.chamfer_nearest_error_string(err).decode())


def _nearest_one_cuda(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    src = src.detach().to(torch.float32).contiguous()
    dst = dst.detach().to(torch.float32).contiguous()
    geo, part_d2, part_idx, d2, idx = _nearest_buffers(src, dst)
    _nearest_launch(src, dst, geo, part_d2, part_idx, d2, idx)
    CHAMFER_NEAREST.launches += 1
    return d2, idx


def nearest_idx(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min squared distance (S,) f32, argmin (S,) int64) of each src point
    over the dst cloud, without gradient. A CUDA tensor goes through the
    hand-written kernel (K7, any cloud size); a CPU tensor, and any tensor
    inside `plain_versions()`, through `nearest_idx_plain`."""
    _check_clouds(src, dst)
    if runs_plain(src):
        return nearest_idx_plain(src, dst)
    if src.device.type != "cuda":
        raise NotImplementedError(f"no Chamfer kernel for device {src.device}")
    return _nearest_one_cuda(src, dst)


class _NearestDists(torch.autograd.Function):
    """The custom VJP of pallas_chamfer.py:205-217: the index is a constant;
    d(src) = g * diff / max(|diff|, 1e-12), and d(dst) the scatter-add of
    -d(src) by index (index_add_, as JAX's segment_sum outside its kernel)."""

    @staticmethod
    def forward(ctx, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        _, idx = nearest_idx(src, dst)
        diff = src - dst[idx]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
        ctx.save_for_backward(diff, dist, idx)
        ctx.n_dst = dst.shape[0]
        return dist

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        diff, dist, idx = ctx.saved_tensors
        dsrc = diff / torch.clamp_min(dist, 1e-12)[:, None] * g[:, None]
        ddst = torch.zeros((ctx.n_dst, 3), dtype=dsrc.dtype, device=dsrc.device)
        ddst.index_add_(0, idx, -dsrc)
        return dsrc, ddst


def nearest_dists(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """For each src point (S, 3): the euclidean distance to its nearest dst
    point (D, 3), (S,), differentiable in both clouds (see _NearestDists)."""
    return _NearestDists.apply(src, dst)


def chamfer_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean_nn(x->y) + mean_nn(y->x), scalar (reference `get_pc_loss`,
    losses.py:116-123, match_method='dense'). Clouds of at most 8,192 points
    take the bidirectional sweep (K2), larger ones the one-direction sweep
    (K7) once per direction. safe_norm: exactly coincident pairs would
    otherwise NaN the pose and distortion gradients."""
    if max(x.shape[0], y.shape[0]) > MAX_POINTS:
        _, idx_xy = nearest_idx(x, y)
        _, idx_yx = nearest_idx(y, x)
    else:
        idx_xy, idx_yx = nearest_idx_bidirectional(x, y)
    d_x = safe_norm(x - y[idx_xy], dim=-1)
    d_y = safe_norm(y - x[idx_yx], dim=-1)
    return d_x.mean() + d_y.mean()
