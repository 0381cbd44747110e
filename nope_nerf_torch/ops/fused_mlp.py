"""Point-query NeRF MLP: points + directions -> encode -> MLP -> heads, one kernel.

Port of nope_nerf_tpu/ops/pallas_mlp.py's `nerf_apply_fused` and its custom
VJP: the forward kernel `_fwd_kernel` (K5) and the backward kernel
`_bwd_kernel` (K6), with the head VJP and the encoding VJP that the JAX
package runs around them. `point_mlp` is the MLP query of the unfused render
(ops/render.py: the coarse and fine passes of hierarchical sampling, and any
sample count the fused render does not take).

On a CUDA tensor `point_mlp` launches the hand-written Hopper kernels in
`nope_nerf_torch/csrc/point_mlp_fwd.cu` and `csrc/point_mlp_bwd.cu` (past
512 `csrc/point_mlp_bwd_xwide.cu`; or, when no nerf parameter wants a
gradient, K6's frozen-network variant `csrc/point_mlp_bwd_frozen.cu`), or
raises. Each takes hidden_dim 128 to 1024 (past 512 on
`csrc/mlp_fwd_xwide_sm90.cuh`'s trunk, with a per-CTA staging scratch the
wrapper allocates). Both backward variants run the
wgmma dX chain (`csrc/mlp_dx_sm90.cuh`; at hidden_dim 384 and 512 the
64-point chain of `csrc/mlp_dx_wide_sm90.cuh`; at 640 to 1024 that of
`csrc/mlp_dx_xwide_sm90.cuh`); the full one also writes every operand of a
weight-gradient product to device memory and forms the dW blocks with the
generic weight-gradient kernel `csrc/dw_sm90.cuh` (dW = X^T G over the
points, split into chunks of points summed in order, blocks wider than 256
columns in column pieces, `point_dw_pieces`, at most DW_MAX_PIECES a launch
of it; standalone as `dw_sm90`, plain version `dw_plain`). On a CPU
tensor, and on any tensor inside `with plain_versions():`, it runs
`point_mlp_fwd_plain` and `point_mlp_bwd_plain`, the same arithmetic in
plain PyTorch:
- the f32 dense-lane encodings (fused_render.encode_lanes) rounded to bf16;
- bf16 matmul operands with f32 accumulation, whatever `compute_dtype` says
  (pallas_mlp.py:395-399), activations rounded to bf16 after each ReLU,
  `feat` rounded without one, heads f32;
- in the backward, every cotangent rounded to bf16 before it enters a
  product, ReLU masks from the bf16 activations, bias gradients summed from
  the f32 cotangents (fused_render.mlp_backward), and the encodings'
  cotangents pulled to the points and directions with the forward's f32
  sin/cos.
The packed weights are fused_render.pack_weights' (the forward kernel takes
them as pack_tiles' pre-swizzled slices); the TPU's (M, 64) / (M, 32)
encodings and (M, 128) padded outputs are layouts of that machine and are not
carried over: the kernels take (M, 3) and write (M, 3) and (M, 1).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models.nerf import NerfConfig, _occupancy, bf16_round, softplus
from ._build import CudaLibrary, runs_plain
from .fused_render import (DE_DIM, PE_DIM, SWIZZLE_COLS, _backward_ctas, _enc_deriv_to_coords,
                           _grad_blocks, _mlp_forward, _packed_tiles_on, _ptr, _scratch_bytes,
                           _spill, check_kernel_width, encode_lanes, mlp_backward, pack_tiles,
                           pack_weights, tile_rows, unpack_grads, x_operands)

PTS_PER_PASS = 128        # the kernels' pass over consecutive points
PLAIN_BLOCK_POINTS = 65536  # points per block of the plain versions (bounds their memory)
DW_ROWS = 128             # rows (points) of a row tile of a dW operand
DW_TILE_ROWS = 128        # dW rows of one CTA tile of the dW kernel


def _setup_fwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_point_mlp_fwd.argtypes = [p] * 7 + [ctypes.c_longlong, i, i, i, p]
    lib.nerf_point_mlp_fwd.restype = ctypes.c_int
    lib.nerf_point_mlp_fwd_operands.argtypes = [p] * 8 + [ctypes.c_longlong, i, i, i, p]
    lib.nerf_point_mlp_fwd_operands.restype = ctypes.c_int
    lib.nerf_point_mlp_fwd_stage.argtypes = [ctypes.c_longlong, i]
    lib.nerf_point_mlp_fwd_stage.restype = ctypes.c_longlong
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


def _setup_bwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_point_mlp_grad_layout.argtypes = [i, p]
    lib.nerf_point_mlp_grad_layout.restype = ctypes.c_int
    lib.nerf_point_mlp_bwd_scratch.argtypes = [i, ctypes.c_longlong, i, p]
    lib.nerf_point_mlp_bwd_scratch.restype = ctypes.c_int
    lib.nerf_point_mlp_bwd.argtypes = [p] * 15 + [ctypes.c_longlong] + [i] * 6 + [p, p]
    lib.nerf_point_mlp_bwd.restype = ctypes.c_int
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


def _setup_bwd_frozen(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_point_mlp_bwd_frozen.argtypes = [p] * 10 + [ctypes.c_longlong] + [i] * 4 + [p]
    lib.nerf_point_mlp_bwd_frozen.restype = ctypes.c_int
    lib.nerf_point_mlp_bwd_frozen_scratch.argtypes = [i, i]
    lib.nerf_point_mlp_bwd_frozen_scratch.restype = ctypes.c_longlong
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


def _setup_dw(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_dw_sm90.argtypes = [i] + [p] * 6 + [ctypes.c_longlong, i, p, p]
    lib.nerf_dw_sm90.restype = ctypes.c_int
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


POINT_MLP_FWD = CudaLibrary("point_mlp_fwd.cu", _setup_fwd)
POINT_MLP_BWD = CudaLibrary("point_mlp_bwd.cu", _setup_bwd)
# K6 full at hidden_dim 640 to 1024: the same C entries in a translation unit of its own
# (csrc/point_mlp_bwd_xwide.cu). Its launches count in POINT_MLP_BWD.launches, which
# counts every launch of K6 at every width.
POINT_MLP_BWD_XWIDE = CudaLibrary("point_mlp_bwd_xwide.cu", _setup_bwd)
# The weight-gradient kernel (csrc/dw_sm90.cuh). Its `launches` counts every
# launch of it: by K6 full (point_mlp_bwd.cu's and point_mlp_bwd_xwide.cu's
# entry) once per launch of K6 full up to hidden_dim 512 and twice past it
# (point_dw_launches), by K1
# and K4 full (render_train.cu's and render_bwd.cu's, and their _xwide twins') once per
# chunk of rays (fused_render.render_chunks) up to 512 and twice past it
# (render_dw_launches), and by `dw_sm90`, the kernel on its own (dw_sm90.cu).
DW_SM90 = CudaLibrary("dw_sm90.cu", _setup_dw)
# K6's frozen-network variant (d(points), d(directions) only) on the wgmma dX
# chain. Its `launches` counts those launches; each also counts in
# POINT_MLP_BWD.launches, which counts every launch of K6, either variant.
POINT_MLP_BWD_FROZEN = CudaLibrary("point_mlp_bwd_frozen.cu", _setup_bwd_frozen)


def _check_inputs(pts: torch.Tensor, dirs: torch.Tensor) -> None:
    if pts.ndim != 2 or pts.shape[1] != 3 or tuple(dirs.shape) != tuple(pts.shape):
        raise ValueError(f"pts and dirs must both be (M, 3), got {tuple(pts.shape)} and "
                         f"{tuple(dirs.shape)}")


def _check_width(cfg: NerfConfig, kernel: str) -> None:
    """The point-query MLP `kernel` ("forward": K5, "backward (frozen
    network)": K6's frozen-network variant, "backward": K6 full; each 128 to
    1024) takes cfg's width and the reference 10/4 encoding levels, or this
    raises NotImplementedError before any device work."""
    if cfg.pos_enc_levels != 10 or cfg.dir_enc_levels != 4:
        raise NotImplementedError(
            "the CUDA point-query MLP kernels are built for the reference 10/4 encoding "
            f"levels, got {cfg.pos_enc_levels}/{cfg.dir_enc_levels}")
    check_kernel_width(f"point-query MLP {kernel}", cfg.hidden_dim)


def _heads(rgb_raw: torch.Tensor, sig_raw: torch.Tensor, cfg: NerfConfig):
    """(rgb (M,3), density (M,1)) from the raw heads (pallas_mlp.py:381)."""
    return torch.sigmoid(rgb_raw), _occupancy(sig_raw, cfg)[:, None]


def _plain_forward(Wf, B, pts, dirs):
    """(rgb_raw (T,3), sig_raw (T,), activations, pe, de) of one block, summed
    in the weights' dtype (the encodings formed from the coordinates' f32)."""
    pe = bf16_round(encode_lanes(pts, 10, PE_DIM)).to(Wf[0].dtype)
    de = bf16_round(encode_lanes(dirs, 4, DE_DIM)).to(Wf[0].dtype)
    rgb_raw, sig_raw, acts = _mlp_forward(Wf, B, pe, de, pts.shape[0], 1)
    return rgb_raw, sig_raw, acts, pe, de


def point_mlp_fwd_plain(params: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                        cfg: NerfConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, on any device:
    (rgb (M,3), density (M,1)) f32."""
    _check_inputs(pts, dirs)
    with torch.no_grad():
        W, B = pack_weights(params, cfg)
        Wf = [w.to(torch.float32) for w in W]
        pts, dirs = pts.to(torch.float32), dirs.to(torch.float32)
        outs = []
        for i in range(0, max(pts.shape[0], 1), PLAIN_BLOCK_POINTS):
            sl = slice(i, i + PLAIN_BLOCK_POINTS)
            rgb_raw, sig_raw, _, _, _ = _plain_forward(Wf, B, pts[sl], dirs[sl])
            outs.append(_heads(rgb_raw, sig_raw, cfg))
        return tuple(torch.cat(t, dim=0) for t in zip(*outs))


def _head_vjp(rgb_raw, sig_raw, g_rgb, g_density, cfg: NerfConfig):
    """Cotangents of the raw heads (g_rgb_raw (T,3), g_sig_raw (T,)) from those
    of rgb and density, in f32 (pallas_mlp.py:421-425)."""
    sigma = softplus(sig_raw) if cfg.occ_activation == "softplus" else torch.relu(sig_raw)
    g_sigma = g_density[:, 0] if cfg.dist_alpha else g_density[:, 0] * torch.exp(-sigma)
    if cfg.occ_activation == "softplus":
        g_sig = g_sigma * torch.sigmoid(sig_raw)
    else:
        g_sig = g_sigma * (sig_raw > 0.0)
    s = torch.sigmoid(rgb_raw)
    return g_rgb * (s * (1.0 - s)), g_sig


# K6's weight-gradient blocks on the dW kernel (point_mlp_bwd.cu's
# point_dw_table): (pack_weights index, X operand, G operand, K, N). The head
# blocks dW[9] and dW[13] are formed in the chain.
def point_dw_table(D: int) -> List[Tuple[int, str, str, int, int]]:
    H = D // 2
    return [(0, "pe", "g0", PE_DIM, D), (1, "x0", "g1", D, D), (2, "x1", "g2", D, D),
            (3, "x2", "g3", D, D), (4, "x3", "g4", D, D), (5, "pe", "g4", PE_DIM, D),
            (6, "x4", "g5", D, D), (7, "x5", "g6", D, D), (8, "x6", "g7", D, D),
            (10, "x7", "g_feat", D, D), (11, "feat", "g_h", D, H), (12, "de", "g_h", DE_DIM, H)]


DW_MAX_N = 256            # the dW kernel's widest block (its wgmma's N)
DW_MAX_PIECES = 24        # the blocks of one launch of the dW kernel (dw_sm90.cuh's kDwMaxBlocks)


def _dw_pieces(table) -> List[Tuple[int, str, str, int, int, int]]:
    """Each block of a dW table in column pieces of 256, then 128, then 64
    columns, as (pack_weights index, X operand, G operand, K, first column, N)."""
    pieces = []
    for idx, x, g, K, N in table:
        c0 = 0
        while c0 < N:
            rest = N - c0
            n = DW_MAX_N if rest >= DW_MAX_N else (128 if rest >= 128 else 64)
            pieces.append((idx, x, g, K, c0, n))
            c0 += n
    return pieces


def point_dw_pieces(D: int) -> List[Tuple[int, str, str, int, int, int]]:
    """The dW kernel's work table for K6 full at width D
    (mlp_dw_chain_sm90.cuh's chain_dw_pieces): each block of point_dw_table
    in column pieces of 256, then 128, then 64 columns, as (pack_weights
    index, X operand, G operand, K, first column, N). At 128 and 256 every
    block is one piece; 24 pieces at 384, 22 at 512, 34 at 640 and 768, 46
    at 896, 44 at 1024."""
    return _dw_pieces(point_dw_table(D))


def point_dw_launches(D: int) -> int:
    """Launches of the dW kernel in one call of K6 full at width D: its
    pieces in table order, at most DW_MAX_PIECES a launch
    (mlp_dw_chain_sm90.cuh's chain_dw_launch); 1 up to 512, 2 past it."""
    return -(-len(point_dw_pieces(D)) // DW_MAX_PIECES)


# K1's and K4 full's (render_full_sm90.cuh): K6's table without its direction
# block. The render kernels fold the direction into a per-ray bias, so the
# right factor of dW[12] is a per-ray f32 sum of bf16 g_h, not a bf16 operand:
# they form dW[12] in the chain, with dW[9] and dW[13].
def render_dw_table(D: int) -> List[Tuple[int, str, str, int, int]]:
    return point_dw_table(D)[:11]


def render_dw_pieces(D: int) -> List[Tuple[int, str, str, int, int, int]]:
    """K1's and K4 full's work table for the dW kernel at width D
    (chain_dw_pieces without the direction block): render_dw_table in
    point_dw_pieces' column pieces; 11 at 128 and 256, 22 at 384, 21 at 512,
    32 at 640 and 768, 43 at 896, 42 at 1024."""
    return _dw_pieces(render_dw_table(D))


def render_dw_launches(D: int) -> int:
    """Launches of the dW kernel for one chunk of rays of K1 or K4 full at
    width D (render_dw_pieces at most DW_MAX_PIECES a launch,
    chain_dw_launch): 1 up to 512, 2 past it."""
    return -(-len(render_dw_pieces(D)) // DW_MAX_PIECES)


def dw_cta_tiles(Ks) -> int:
    """CTA tiles of the dW kernel over blocks of K rows: 128 dW rows each."""
    return sum(-(-K // DW_TILE_ROWS) for K in Ks)


def dw_chunks(cta_tiles: int, M: int, sms: int) -> int:
    """The number of contiguous chunks of row tiles the dW kernel splits M
    points into: as many as one wave of CTA tiles x chunks fills the SMs
    with, at least 1 and at most the row tiles. From M and the SM count
    only, so two launches split alike."""
    return max(1, min(-(-M // DW_ROWS), sms // cta_tiles))


# Past hidden_dim 512: the row tiles one chunk of K6 full's dW kernel sums at most. The
# kernel's wgmma accumulator truncates, so a run of 1,537 row tiles (196,608 points, one
# chunk: the table's CTA tiles pass the SM count there) drifts from an f32 sum of the
# same products by 4.5 to 6.0 x the f32 plain version's distance from the f64 sum
# (tools/backward_noise.py --full, PERF.md section 6); the chunks' partials are
# summed in f32 in chunk order.
DW_XWIDE_CHUNK_TILES = 64


def point_dw_chunks(D: int, cta_tiles: int, M: int, sms: int) -> int:
    """The chunks of the dW kernel of K6 full, and of K1 and K4 full over a
    chunk of rays (M samples), at width D: dw_chunks', and past 512 at least
    enough that none sums more than DW_XWIDE_CHUNK_TILES row tiles (at most
    the row tiles)."""
    chunks = dw_chunks(cta_tiles, M, sms)
    if D > 512:
        nt = -(-M // DW_ROWS)
        chunks = max(chunks, min(nt, -(-nt // DW_XWIDE_CHUNK_TILES)))
    return chunks


def _chunk_bounds(M: int, chunks: int) -> List[Tuple[int, int]]:
    """Row ranges of the chunks: chunk c holds row tiles [c nt / C, (c+1) nt / C)."""
    nt = -(-M // DW_ROWS)
    return [(c * nt // chunks * DW_ROWS, min(M, (c + 1) * nt // chunks * DW_ROWS))
            for c in range(chunks)]


def dw_plain(X: torch.Tensor, G: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the dW kernel, on any device: dW (K, N) f32 =
    X^T G for X (M, K) and G (M, N) holding bf16 values (any float type),
    each chunk of rows (the kernel's split) summed in f32 from exact f32
    products, then the chunks summed in order."""
    if X.ndim != 2 or G.ndim != 2 or X.shape[0] != G.shape[0]:
        raise ValueError(f"X and G must be (M, K) and (M, N), got {tuple(X.shape)} and "
                         f"{tuple(G.shape)}")
    x = bf16_round(X.to(torch.float32))
    g = bf16_round(G.to(torch.float32))
    out = None
    for a, b in _chunk_bounds(X.shape[0], chunks):
        part = x[a:b].t() @ g[a:b]
        out = part if out is None else out + part
    return out


def tile_operand(X: torch.Tensor) -> torch.Tensor:
    """An (M, C) operand in the dW kernel's tiled bf16 layout: (ceil(M/128),
    ceil(C/64), 128, 64), each 128-row, 64-column block with the 16-byte chunk
    c of row r stored at chunk c ^ (r % 8), padding rows and columns zero."""
    M, C = X.shape
    nt, cb = -(-M // DW_ROWS), -(-C // SWIZZLE_COLS)
    pad = X.new_zeros((nt * DW_ROWS, cb * SWIZZLE_COLS), dtype=torch.bfloat16)
    pad[:M, :C] = X.to(torch.bfloat16)
    t = pad.view(nt, DW_ROWS, cb, 8, 8).permute(0, 2, 1, 3, 4)       # (nt, cb, r, chunk, 8)
    r = torch.arange(DW_ROWS, device=X.device)[:, None]
    src = (torch.arange(8, device=X.device)[None, :] ^ (r % 8))      # stored chunk k holds k ^ (r % 8)
    idx = src[None, None, :, :, None].expand(nt, cb, DW_ROWS, 8, 8)
    return torch.gather(t, 3, idx).reshape(nt, cb, DW_ROWS, SWIZZLE_COLS).contiguous()


def untile_operand(T: torch.Tensor, C: int) -> torch.Tensor:
    """tile_operand undone: (nt, cb, 128, 64) tiled bf16 -> (nt * 128, C), the
    first C columns (padding rows kept)."""
    nt, cb = T.shape[:2]
    t = T.reshape(nt, cb, DW_ROWS, 8, 8)
    r = torch.arange(DW_ROWS, device=T.device)[:, None]
    src = (torch.arange(8, device=T.device)[None, :] ^ (r % 8))     # logical chunk c at c ^ (r % 8)
    idx = src[None, None, :, :, None].expand(nt, cb, DW_ROWS, 8, 8)
    t = torch.gather(t, 3, idx).permute(0, 2, 1, 3, 4)               # (nt, r, cb, chunk, 8)
    return t.reshape(nt * DW_ROWS, cb * SWIZZLE_COLS)[:, :C]


def x_operand_views(xops: torch.Tensor, D: int, rows: int, de: bool) -> Dict[str, torch.Tensor]:
    """{name: (row tiles x 128, width)} of a flat X operand buffer
    (x_operands' layout over `rows` rows): pe (64 lanes), x0..x7 and feat
    (D), and with `de` the direction encodings' 32 lanes. The 32 columns past
    de's lanes are layout padding (the dW kernel reads K = 32 of them) that
    the kernels copy from shared memory as they find it, so they are left
    out."""
    nt = -(-rows // DW_ROWS)
    names = [("pe", PE_DIM)] + [(f"x{i}", D) for i in range(8)] + [("feat", D)]
    names += [("de", DE_DIM)] if de else []
    out, at = {}, 0
    for name, width in names:
        cb = -(-width // SWIZZLE_COLS)
        n = nt * cb * DW_ROWS * SWIZZLE_COLS
        out[name] = untile_operand(xops[at:at + n].view(nt, cb, DW_ROWS, SWIZZLE_COLS), width)
        at += n
    if at != xops.numel():
        raise ValueError(f"{xops.numel()} bf16 are not the X operands of {rows} rows at {D}")
    return out


def point_mlp_dw_operands(params: Dict[str, torch.Tensor], pts: torch.Tensor,
                          dirs: torch.Tensor, g_rgb: torch.Tensor, g_density: torch.Tensor,
                          cfg: NerfConfig):
    """The operands of K6's dW products as the plain backward forms them,
    for one block of points (at most PLAIN_BLOCK_POINTS): (X, G) dicts of
    bf16-valued f32 (M, width) tensors named as in point_dw_table (X: pe,
    x0..x7, feat, de; G: g_h, g_feat, g7..g0)."""
    _check_inputs(pts, dirs)
    if pts.shape[0] > PLAIN_BLOCK_POINTS:
        raise ValueError(f"at most {PLAIN_BLOCK_POINTS} points, got {pts.shape[0]}")
    with torch.no_grad():
        W, B = pack_weights(params, cfg)
        Wf = [w.to(torch.float32) for w in W]
        pts, dirs, g_rgb, g_density = (t.detach().to(torch.float32)
                                       for t in (pts, dirs, g_rgb, g_density))
        rgb_raw, sig_raw, acts, pe, de = _plain_forward(Wf, B, pts, dirs)
        g_rgb_raw, g_sig = _head_vjp(rgb_raw, sig_raw, g_rgb, g_density, cfg)
        taps: Dict[str, torch.Tensor] = {}
        mlp_backward(Wf, pe, de, acts, g_rgb_raw, g_sig, pe.shape[0], 1, True, taps)
        X = {"pe": pe, "de": de, "feat": acts[8]}
        X.update({f"x{i}": acts[i] for i in range(8)})
        return X, taps


def point_mlp_bwd_plain(params: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                        g_rgb: torch.Tensor, g_density: torch.Tensor, cfg: NerfConfig,
                        want_param_grads: bool = True, dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of the backward kernel, on any device: the VJP of
    point_mlp at cotangents g_rgb (M,3) and g_density (M,1). It recomputes the
    forward and returns (dWs [14] stored (in, out), dBs [12], dpts (M,3),
    ddirs (M,3)); unpack_grads turns the first two into the nerf params'
    layout. Blocks of points are summed in order: two runs give the same bits.
    With want_param_grads=False, the frozen-network variant's version: the
    same dX arithmetic with the dW/dB work skipped, and dWs, dBs None.
    `dtype` float64 gives the same function summed in f64 (same bf16 operands
    and rounding points, the encodings formed in f32 as before; gradients
    returned as f64): the yardstick of tools/backward_noise.py --full."""
    _check_inputs(pts, dirs)
    with torch.no_grad():
        W, B = pack_weights(params, cfg)
        Wf = [w.to(dtype) for w in W]
        pts, dirs = (t.detach().to(torch.float32) for t in (pts, dirs))
        g_rgb, g_density = (t.detach().to(dtype) for t in (g_rgb, g_density))
        dW = dB = None
        dpts, ddirs = [], []
        for i in range(0, pts.shape[0], PLAIN_BLOCK_POINTS):
            sl = slice(i, i + PLAIN_BLOCK_POINTS)
            rgb_raw, sig_raw, acts, pe, de = _plain_forward(Wf, B, pts[sl], dirs[sl])
            g_rgb_raw, g_sig = _head_vjp(rgb_raw, sig_raw, g_rgb[sl], g_density[sl], cfg)
            m = pe.shape[0]
            dW_b, dB_b, dpe, dde = mlp_backward(Wf, pe, de, acts, g_rgb_raw, g_sig, m, 1,
                                                want_param_grads)
            if want_param_grads:
                dW = dW_b if dW is None else [a + b for a, b in zip(dW, dW_b)]
                dB = dB_b if dB is None else [a + b for a, b in zip(dB, dB_b)]
            dpts.append(_enc_deriv_to_coords(dpe, pts[sl], 10))
            ddirs.append(_enc_deriv_to_coords(dde, dirs[sl], 4))
        return dW, dB, torch.cat(dpts, dim=0), torch.cat(ddirs, dim=0)


def _check_tensors(named, dev: torch.device) -> None:
    for name, t in named:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != dev:
            raise ValueError(f"{name} must be on the points' device")


def _mlp_fwd_cuda(params, pts: torch.Tensor, dirs: torch.Tensor, cfg: NerfConfig,
                  xops: Optional[torch.Tensor] = None):
    """(rgb (M,3), density (M,1)) by one launch of the forward kernel. With
    `xops` (point_operand_bytes' X bytes) the kernel's check build runs
    instead and also writes the X operands there (point_mlp_fwd_operands):
    not counted."""
    _check_width(cfg, "forward")
    dev = pts.device
    _check_tensors((("pts", pts), ("dirs", dirs)), dev)
    tiles, B = pack_tiles(params, cfg)
    for t in [tiles] + B:
        if t.device != dev:
            raise ValueError("params must be on the points' device")
    M = pts.shape[0]
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    density = torch.empty((M, 1), dtype=torch.float32, device=dev)
    if M == 0:
        return rgb, density
    lib = POINT_MLP_FWD.lib()
    bptrs = (ctypes.c_void_p * 12)(*[b.data_ptr() for b in B])
    with torch.cuda.device(dev):
        # the staging of the trunk past 512 (none at 128 to 512)
        stage = _spill(lib.nerf_point_mlp_fwd_stage(M, cfg.hidden_dim), dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        flags = (int(cfg.occ_activation == "softplus"), int(cfg.dist_alpha))
        if xops is None:
            err = lib.nerf_point_mlp_fwd(pts.data_ptr(), dirs.data_ptr(), tiles.data_ptr(),
                                         bptrs, rgb.data_ptr(), density.data_ptr(), _ptr(stage),
                                         M, cfg.hidden_dim, *flags, stream)
        else:
            err = lib.nerf_point_mlp_fwd_operands(pts.data_ptr(), dirs.data_ptr(),
                                                  tiles.data_ptr(), bptrs, rgb.data_ptr(),
                                                  density.data_ptr(), _ptr(stage),
                                                  xops.data_ptr(), M, cfg.hidden_dim, *flags,
                                                  stream)
    if err != 0:
        raise RuntimeError("point-query MLP forward kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    if xops is None:
        POINT_MLP_FWD.launches += 1
    return rgb, density


def point_operand_bytes(D: int, M: int) -> int:
    """Bytes of the X operands K6 full hands the dW kernel for M points:
    ceil(M/128) row tiles of 64-column bf16 blocks (16 KB each) of pe and de
    (1 block each), x0..x7 and feat (D/64 each)."""
    return -(-M // DW_ROWS) * DW_ROWS * 2 * SWIZZLE_COLS * (2 + 9 * (D // 64))


def point_mlp_fwd_operands(params: Dict[str, torch.Tensor], pts: torch.Tensor,
                           dirs: torch.Tensor, cfg: NerfConfig):
    """(rgb (M,3), density (M,1), X) by the forward kernel's check build:
    the forward of point_mlp that also writes the X operands of the points
    (fused_render.x_operands' layout: pe, x0..x7, feat, de; rows past M those
    of zero points), which K6 full writes for its dW products from the same
    forward. For checks only; no main path calls it, and its launches are not
    counted. On the CPU the plain version's (_plain_forward's, rows past M
    zero)."""
    _check_inputs(pts, dirs)
    with torch.no_grad():
        if runs_plain(pts):
            W, B = pack_weights(params, cfg)
            rgb_raw, sig_raw, acts, pe, de = _plain_forward(
                [w.to(torch.float32) for w in W], B, pts.to(torch.float32),
                dirs.to(torch.float32))
            return (*_heads(rgb_raw, sig_raw, cfg), x_operands(pe, acts, de))
        xops = torch.zeros((point_operand_bytes(cfg.hidden_dim, pts.shape[0]) // 2,),
                           dtype=torch.bfloat16, device=pts.device)
        rgb, density = _mlp_fwd_cuda(params, pts.detach(), dirs.detach(), cfg, xops)
        return rgb, density, xops


def point_mlp_bwd_library(D: int):
    """The library of K6 full at width D: point_mlp_bwd.cu up to 512,
    point_mlp_bwd_xwide.cu past it (the same C entries)."""
    return POINT_MLP_BWD_XWIDE if D > 512 else POINT_MLP_BWD


def mlp_bwd_kernel(want_param_grads: bool) -> str:
    """_check_width's name of the backward's variant: K6 full when a nerf
    parameter wants a gradient, else its frozen-network variant."""
    return "backward" if want_param_grads else "backward (frozen network)"


def _mlp_bwd_cuda(params, pts, dirs, g_rgb, g_density, cfg: NerfConfig,
                  want_param_grads: bool = True, operands: Optional[list] = None):
    """(dWs, dBs, dpts, ddirs) by one launch of the backward kernel: its C
    entry issues the chain (one CTA per SM over tile_rows(D)-point passes),
    the in-order sum of the chain's partial sums and the dW kernel (with its
    in-order sum of the chunks; past 512 two launches of it,
    point_dw_launches). From 384 on the chain also takes a per-CTA scratch
    (the ReLU masks, the parked g4, the bias column sums; past 512 the staging
    of a layer's passes), whose size the C entry gives in sizes[5]. With
    want_param_grads=False its frozen-network variant runs: no dW/dB, and
    dWs, dBs are None. For checks, a list given as `operands` gets the X
    operands the chain handed the dW kernel (point_mlp_fwd_operands' layout,
    flat bf16, zeroed first)."""
    _check_width(cfg, mlp_bwd_kernel(want_param_grads))
    D = cfg.hidden_dim
    dev = pts.device
    M = pts.shape[0]
    if M == 0:
        raise ValueError("the point-query MLP backward needs at least one point")
    _check_tensors((("pts", pts), ("dirs", dirs), ("g_rgb", g_rgb), ("g_density", g_density)),
                   dev)
    if not want_param_grads:
        return (None, None) + _mlp_bwd_frozen_cuda(params, pts, dirs, g_rgb, g_density, cfg)
    tiles, tiles_dx, _B, bptrs = _packed_tiles_on(params, cfg, dev)
    lib = point_mlp_bwd_library(D).lib()
    offsets = (ctypes.c_int * 26)()
    total = lib.nerf_point_mlp_grad_layout(D, offsets)
    if total <= 0:
        raise RuntimeError("the point-query MLP backward kernel reports no gradient layout")
    n_ctas = _backward_ctas(-(-M // tile_rows(D)), dev)
    sizes = (ctypes.c_longlong * 6)()
    if lib.nerf_point_mlp_bwd_scratch(D, M, n_ctas, sizes) != 0:
        raise RuntimeError("the point-query MLP backward kernel reports no scratch sizes")
    chunks = point_dw_chunks(D, sizes[4], M,
                             torch.cuda.get_device_properties(dev).multi_processor_count)
    xops, gops = (torch.empty((sizes[i],), dtype=torch.uint8, device=dev) for i in (0, 1))
    if operands is not None:
        xops.zero_()
        operands.append(xops.view(torch.bfloat16))
    chain_part = torch.empty((sizes[2] // 4,), dtype=torch.float32, device=dev)
    dw_part = torch.empty((chunks * sizes[3] // 4,), dtype=torch.float32, device=dev)
    scratch = _scratch_bytes(sizes[5], dev) if sizes[5] else None   # the 64-point chains'
    f32 = dict(dtype=torch.float32, device=dev)
    grads = torch.empty((total,), **f32)
    dpts = torch.empty((M, 3), **f32)
    ddirs = torch.empty((M, 3), **f32)
    launched = (ctypes.c_int * 2)()   # the C entry's launches of the chain and the dW kernel
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_point_mlp_bwd(
            pts.data_ptr(), dirs.data_ptr(), g_rgb.data_ptr(), g_density.data_ptr(),
            tiles.data_ptr(), tiles_dx.data_ptr(), bptrs, xops.data_ptr(), gops.data_ptr(),
            chain_part.data_ptr(), dw_part.data_ptr(),
            None if scratch is None else scratch.data_ptr(), grads.data_ptr(), dpts.data_ptr(),
            ddirs.data_ptr(), M, D, n_ctas, chunks, int(cfg.occ_activation == "softplus"),
            int(cfg.dist_alpha), total, launched, stream)
    if err != 0:
        raise RuntimeError("point-query MLP backward kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    POINT_MLP_BWD.launches += launched[0]
    DW_SM90.launches += launched[1]
    dWs, dBs = _grad_blocks(grads, offsets, D)
    return dWs, dBs, dpts, ddirs


def dw_sm90(xs: Sequence[torch.Tensor], gs: Sequence[torch.Tensor], Ks: Sequence[int], M: int,
            chunks: int) -> List[torch.Tensor]:
    """dW_i (K_i, N_i) f32 = X_i^T G_i for each block, by one launch of the
    dW kernel (and its in-order sum of the chunks): xs[i], gs[i] the
    operands in tile_operand's layout over M rows, on the card. The kernel
    alone, for checks and timings: K6 full launches it from its own entry."""
    if not (len(xs) == len(gs) == len(Ks)) or not 0 < len(xs) <= 16:
        raise ValueError("1 to 16 blocks, each with X, G and K")
    nt = -(-M // DW_ROWS)
    dev = xs[0].device
    for x, g, K in zip(xs, gs, Ks):
        for t in (x, g):
            if (t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != dev
                    or t.ndim != 4 or t.shape[0] != nt or tuple(t.shape[2:]) != (DW_ROWS, 64)):
                raise ValueError(f"operands must be tile_operand's bf16 layout of {M} rows on "
                                 f"one device, got {tuple(t.shape)} {t.dtype}")
        if not 0 < K <= 64 * x.shape[1] or g.shape[1] not in (1, 2, 4):
            raise ValueError(f"K = {K} for {x.shape[1]} blocks of X, N = {64 * g.shape[1]}")
    if not 0 < chunks <= nt:
        raise ValueError(f"chunks must be in 1..{nt}, got {chunks}")
    lib = DW_SM90.lib()
    outs = [torch.empty((K, 64 * g.shape[1]), dtype=torch.float32, device=dev)
            for g, K in zip(gs, Ks)]
    part = torch.empty((chunks * sum(o.numel() for o in outs),), dtype=torch.float32, device=dev)
    n = len(xs)
    arr = lambda ts: (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])
    ints = lambda v: (ctypes.c_int * n)(*v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_dw_sm90(n, arr(xs), arr(gs), arr(outs), ints([x.shape[1] for x in xs]),
                               ints(Ks), ints([64 * g.shape[1] for g in gs]), M, chunks,
                               part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("weight-gradient kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    DW_SM90.launches += 1
    return outs


def _mlp_bwd_frozen_cuda(params, pts, dirs, g_rgb, g_density, cfg: NerfConfig):
    """(dpts, ddirs) by one launch of K6's frozen-network variant: no
    operands, no partial sums; a per-CTA scratch holds the chain's g4 (one
    tile x D bf16) and, from 384 on, the tile's ReLU masks (past 512 also the
    staging of a layer's passes; the kernel's entry gives its size)."""
    D = cfg.hidden_dim
    dev = pts.device
    M = pts.shape[0]
    tiles, tiles_dx, _B, bptrs = _packed_tiles_on(params, cfg, dev)
    lib = POINT_MLP_BWD_FROZEN.lib()
    n_ctas = _backward_ctas(-(-M // tile_rows(D)), dev)
    scratch = _scratch_bytes(lib.nerf_point_mlp_bwd_frozen_scratch(D, n_ctas), dev)
    dpts = torch.empty((M, 3), dtype=torch.float32, device=dev)
    ddirs = torch.empty((M, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_point_mlp_bwd_frozen(
            pts.data_ptr(), dirs.data_ptr(), g_rgb.data_ptr(), g_density.data_ptr(),
            tiles.data_ptr(), tiles_dx.data_ptr(), bptrs, scratch.data_ptr(), dpts.data_ptr(),
            ddirs.data_ptr(), M, D, n_ctas, int(cfg.occ_activation == "softplus"),
            int(cfg.dist_alpha), stream)
    if err != 0:
        raise RuntimeError("point-query MLP backward kernel (frozen-network variant) launch "
                           "failed: " + lib.nerf_error_string(err).decode())
    POINT_MLP_BWD.launches += 1
    POINT_MLP_BWD_FROZEN.launches += 1
    return dpts, ddirs


def _forward(params, pts, dirs, cfg: NerfConfig, plain: bool):
    """The forward by its route, without an autograd graph."""
    with torch.no_grad():
        if plain:
            return point_mlp_fwd_plain(params, pts, dirs, cfg)
        return _mlp_fwd_cuda(params, pts.detach(), dirs.detach(), cfg)


class _PointMLP(torch.autograd.Function):
    """point_mlp with its hand-written backward: the forward stores only its
    inputs, the backward recomputes everything (pallas_mlp.py:406-443).
    Cotangents of outputs nobody used arrive as None and count as zero."""

    @staticmethod
    def forward(ctx, pts, dirs, cfg, names, *tensors):
        params = dict(zip(names, tensors))
        plain = runs_plain(pts)       # read here: the backward takes the forward's route
        if not plain:
            # what the backward kernel cannot take raises now, not after the forward: the
            # variant the backward will run, full when a nerf parameter wants a gradient
            _check_width(cfg, mlp_bwd_kernel(any(ctx.needs_input_grad[4:])))
        out = _forward(params, pts, dirs, cfg, plain)
        ctx.save_for_backward(pts, dirs, *tensors)
        ctx.static = (cfg, plain, names)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_rgb, g_density):
        pts, dirs, *tensors = ctx.saved_tensors
        cfg, plain, names = ctx.static
        params = dict(zip(names, tensors))
        f32 = dict(dtype=torch.float32, device=pts.device)
        g_rgb = torch.zeros((pts.shape[0], 3), **f32) if g_rgb is None else g_rgb
        g_density = torch.zeros((pts.shape[0], 1), **f32) if g_density is None else g_density
        g_rgb, g_density = (g.to(torch.float32).contiguous() for g in (g_rgb, g_density))
        want_param_grads = any(ctx.needs_input_grad[4:])
        backward = point_mlp_bwd_plain if plain else _mlp_bwd_cuda
        dWs, dBs, dpts, ddirs = backward(params, pts, dirs, g_rgb, g_density, cfg,
                                         want_param_grads)
        param_grads = [None] * len(names)
        if want_param_grads:
            grads = unpack_grads(dWs, dBs, cfg)
            param_grads = [grads[k].to(params[k].dtype) if need else None
                           for k, need in zip(names, ctx.needs_input_grad[4:])]
        return dpts.to(pts.dtype), ddirs.to(dirs.dtype), None, None, *param_grads


def point_mlp(params: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
              cfg: NerfConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(params, points (M,3), directions (M,3)) -> (rgb (M,3), density (M,1)):
    the JAX package's nerf_apply_fused. A CUDA tensor goes through the
    hand-written kernels (point_mlp_fwd forward, point_mlp_bwd backward) or
    raises; a CPU tensor, and any tensor inside `plain_versions()`, through
    point_mlp_fwd_plain and point_mlp_bwd_plain. Gradients flow to the nerf
    params, the points and the directions; under torch.no_grad(), or when
    nothing requires a gradient, no graph is built. When no nerf parameter
    requires a gradient the backward is the frozen-network variant (no dW/dB)."""
    _check_inputs(pts, dirs)
    if pts.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no point-query MLP kernel for device {pts.device}")
    pts = pts.to(torch.float32).contiguous()
    dirs = dirs.to(torch.float32).contiguous()
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (pts, dirs, *params.values()))):
        return _forward(params, pts, dirs, cfg, runs_plain(pts))
    if pts.shape[0] == 0:
        raise ValueError("the differentiable point-query MLP needs at least one point")
    names = tuple(sorted(params))
    return _PointMLP.apply(pts, dirs, cfg, names, *[params[k] for k in names])
