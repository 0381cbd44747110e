"""Fused ray render: rays + z -> encode -> MLP -> heads -> composite, one kernel.

Port of nope_nerf_tpu/ops/pallas_render.py's forward (`_render_fwd_kernel`,
K3), of its backward (`_render_bwd_kernel`, K4: the VJP of render_rays_fused),
of its train-step program (`_render_train_kernel`, K1: render, rgb and
depth losses and every gradient in one launch) and of pallas_mlp.py's
`pack_weights` / `_unpack_grads`. On a CUDA tensor `render_rays_fused` and
`render_ray_loss_fused` launch the hand-written Hopper kernels in
`nope_nerf_torch/csrc/render_fwd.cu`, `csrc/render_bwd.cu` (for a frozen
network its variant `csrc/render_bwd_frozen.cu`) and `csrc/render_train.cu`,
or raise (render_train.cu and render_bwd.cu are the two instances of one
kernel template, `csrc/render_full_sm90.cuh`, on the wgmma dX chain, handing
their weight-gradient products to the dW kernel of `csrc/dw_sm90.cuh`); on a
CPU tensor they run
`render_rays_fused_plain`, `render_rays_fused_bwd_plain` and
`render_ray_loss_fused_plain`, the same arithmetic in plain PyTorch (inside
`with plain_versions():`, re-exported here, they do so on any device: a
switch for checks that hold the kernels' route against the plain one):
- bf16 matmul operands (whatever `compute_dtype` says, as the TPU kernel)
  with f32 accumulation; activations rounded to bf16 after each ReLU, `feat`
  rounded without one; heads f32;
- the f32 composite as exp of an exclusive Hillis-Steele prefix sum of
  log(1 - alpha + 1e-6), in the TPU kernel's order of additions;
- in the backward, every cotangent is rounded to bf16 before it enters a
  product (dX = g W^T, dW = x^T g), ReLU masks come from the bf16
  activations, bias gradients sum the f32 cotangent, and the encoding
  derivative uses the forward's own f32 sin/cos.

The forward kernels (render_fwd here, point_mlp_fwd in fused_mlp.py) take the
weights as `pack_tiles`' pre-swizzled slices, the layout their wgmma trunk
(csrc/mlp_fwd_sm90.cuh; csrc/mlp_fwd_wide_sm90.cuh at hidden_dim 384 and
512; csrc/mlp_fwd_xwide_sm90.cuh at 640 to 1024) streams into shared memory;
every backward kernel takes those and `pack_tiles_dx`' slices of the (in,
out) weights, the B operands of its wgmma dX chain (csrc/mlp_dx_sm90.cuh;
csrc/mlp_dx_wide_sm90.cuh's 64-point chain at 384 and 512). Which kernel
takes which hidden_dim is KERNEL_WIDTHS': the forward kernels 128 to 1024,
the backward kernels 128 to 512.

The ray table is (N, 9) [origin | ray_vec | mlp_dir]: the TPU's 128-lane
padding is a layout of that machine and is not carried over. The train
kernel's target table is (N, 7) for the same reason.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.nerf import NerfConfig, bf16_round, softplus
from ._build import CudaLibrary, plain_versions, runs_plain  # plain_versions: re-exported

EPSILON = 1e-6          # compositing epsilon, reference model/rendering.py:9
RAY_DIM = 9             # [origin | ray_vec | mlp_dir]
PE_DIM = 64             # position encoding 63 -> 64 lanes
DE_DIM = 32             # direction encoding 27 -> 32 lanes
HEAD_DIM = 8            # head outputs padded to one mma n-tile
PTS_PER_PASS = 128      # the kernel's pass over a ray's samples
WIDE_TILE_ROWS = 64     # points of a tile of the 64-point trunks and chain (D 384 to 1024)
XWIDE_PASS_COLS = 128   # output columns of a pass of csrc/mlp_fwd_xwide_sm90.cuh (D 640 to 1024)
PLAIN_BLOCK_RAYS = 2048  # rays per block of the plain version (bounds its memory)

Packed = Tuple[List[torch.Tensor], List[torch.Tensor]]


def _setup(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_render_fwd.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.nerf_render_fwd.restype = ctypes.c_int
    lib.nerf_render_fwd_operands.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.nerf_render_fwd_operands.restype = ctypes.c_int
    lib.nerf_render_fwd_spill.argtypes = [i, i, i]
    lib.nerf_render_fwd_spill.restype = ctypes.c_longlong
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


RENDER_FWD = CudaLibrary("render_fwd.cu", _setup)


def _enc_perm(levels: int) -> np.ndarray:
    """Dense-lane encoding index -> reference encoding index (pallas_mlp.py:59):
    [x,y,z, all sin (L levels), all cos (L levels)]."""
    perm = list(range(3))
    for i in range(levels):
        perm += [3 + 6 * i + c for c in range(3)]
    for i in range(levels):
        perm += [6 + 6 * i + c for c in range(3)]
    return np.asarray(perm)


@functools.lru_cache(maxsize=16)
def _enc_perm_index(levels: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """_enc_perm (or its inverse) as an index tensor on `device`, uploaded once:
    a constant, so callers never write to it."""
    perm = _enc_perm(levels)
    return torch.as_tensor(np.argsort(perm) if inverse else perm, device=device)


def encode_lanes(x: torch.Tensor, levels: int, out_dim: int) -> torch.Tensor:
    """Dense-lane frequency encoding (M, 3) -> (M, out_dim) f32:
    [x | sin(2^i x_c) at 3+3i+c | cos(2^i x_c) at 3+3L+3i+c | 0]."""
    scale = torch.tensor([2.0 ** i for i in range(levels)], dtype=x.dtype, device=x.device)
    args = (x[:, None, :] * scale[None, :, None]).reshape(x.shape[0], 3 * levels)
    pad = x.new_zeros((x.shape[0], out_dim - 3 - 6 * levels))
    return torch.cat([x, torch.sin(args), torch.cos(args), pad], dim=1)


def _packed_blocks(params: Dict[str, torch.Tensor], cfg: NerfConfig) -> Packed:
    """nerf params -> (14 f32 weight blocks stored (in, out), 12 f32 biases):
    the same blocks as the JAX package's pack_weights (pallas_mlp.py:95).
    Encoding-facing rows are permuted to the dense-lane order and zero-padded,
    the skip and rgb-hidden layers split into their x and encoding parts, the
    heads padded to HEAD_DIM outputs."""
    D = cfg.hidden_dim
    if D % 128 or cfg.pos_enc_levels != 10 or cfg.dir_enc_levels != 4:
        raise ValueError("the fused render needs hidden_dim % 128 == 0 and the "
                         "reference 10/4 encoding levels")
    dev = params["trunk0_0_w"].device

    def perm_rows(w, levels, rows):
        w = w[_enc_perm_index(levels, False, dev)]
        return torch.nn.functional.pad(w, (0, 0, 0, rows - w.shape[0]))

    def pad_cols(w, cols):
        return torch.nn.functional.pad(w, (0, cols - w.shape[1]))

    w4 = params["trunk1_0_w"]
    wr = params["rgb_hidden_w"]
    weights = [
        perm_rows(params["trunk0_0_w"], 10, PE_DIM),
        params["trunk0_1_w"], params["trunk0_2_w"], params["trunk0_3_w"],
        w4[:D], perm_rows(w4[D:], 10, PE_DIM),
        params["trunk1_1_w"], params["trunk1_2_w"], params["trunk1_3_w"],
        pad_cols(params["density_w"], HEAD_DIM),
        params["feature_w"],
        wr[:D], perm_rows(wr[D:], 4, DE_DIM),
        pad_cols(params["rgb_w"], HEAD_DIM),
    ]

    def pad_b(b, n):
        return torch.nn.functional.pad(b, (0, n - b.shape[0]))

    biases = [params[f"trunk0_{i}_b"] for i in range(4)]
    biases += [params[f"trunk1_{i}_b"] for i in range(4)]
    biases += [pad_b(params["density_b"], HEAD_DIM), params["feature_b"],
               params["rgb_hidden_b"], pad_b(params["rgb_b"], HEAD_DIM)]
    return weights, [b.to(torch.float32).contiguous() for b in biases]


def pack_weights(params: Dict[str, torch.Tensor], cfg: NerfConfig) -> Packed:
    """nerf params -> (14 bf16 weights stored (out, in), 12 f32 biases), the
    forward products' operands in the kernels' layout."""
    blocks, biases = _packed_blocks(params, cfg)
    return [w.t().contiguous().to(torch.bfloat16) for w in blocks], biases


SWIZZLE_COLS = 64       # bf16 columns of one 128-byte swizzled block
WIDE_SLICE_COLS = 32    # bf16 columns of one slice of the wide trunk (64-byte swizzle)


def _slice_cols(D: int) -> int:
    """Columns of one weight slice of the forward buffer: 64 at D <= 256 (the
    128-row trunk of csrc/mlp_fwd_sm90.cuh), 32 at 384 and 512 (the 64-row
    trunk of csrc/mlp_fwd_wide_sm90.cuh, whose ring stages would not fit
    beside its activations at 64 columns)."""
    return SWIZZLE_COLS if D <= 256 else WIDE_SLICE_COLS


def _tile_layout(D: int) -> List[Tuple[int, int, int]]:
    """(pack_weights index, rows N, columns K) of each weight in the order of
    the forward kernels' tiled buffer (csrc/mlp_fwd_sm90.cuh::Tiles, and
    csrc/mlp_fwd_wide_sm90.cuh::TilesW at 384 and 512): the trunk's and
    feature layer's (D-row) slices in the order a pass consumes them, the
    rgb-hidden layer's (D/2 rows, w12's 32 columns padded to one slice), then
    the two heads (8 rows)."""
    H = D // 2
    return [(0, D, PE_DIM), (1, D, D), (2, D, D), (3, D, D), (4, D, D), (5, D, PE_DIM),
            (6, D, D), (7, D, D), (8, D, D), (10, D, D), (11, H, D), (12, H, DE_DIM),
            (9, HEAD_DIM, D), (13, HEAD_DIM, H)]


def _slice_index(base: int, N: int, K: int, C: int, r0: int, n: int,
                 k_major: bool) -> np.ndarray:
    """Rows r0..r0+n-1 of one weight (N rows, K columns) as ceil(K/C) slices
    of n rows of C columns, a row 2C bytes: each bf16's index in the source
    block at `base`, -1 for columns past K. The block is (K, N) row-major
    (stored (in, out) and read transposed) unless k_major, when it is (N, K)
    row-major. The 16-byte chunk c of a slice's row r is stored at chunk c ^
    ((2C r / 128) % (C/8)): the 128-byte swizzle (C = 64, c ^ (r % 8)) or the
    64-byte one (C = 32, c ^ ((r / 2) % 4)) that wgmma and the bulk copies
    read (r0 a multiple of 8, where the pattern starts over)."""
    chunks = C // 8
    kblocks = -(-K // C)
    r = np.arange(n)[None, :, None, None]
    chunk = np.arange(chunks)[None, None, :, None] ^ ((2 * C * r // 128) % chunks)
    col = (np.arange(kblocks)[:, None, None, None] * C + chunk * 8
           + np.arange(8)[None, None, None, :])
    src = base + (r0 + r) * K + col if k_major else base + col * N + r0 + r
    return np.where(col < K, src, -1).reshape(-1)


def _swizzled_slices(shapes: List[Tuple[int, int, int]], k_major: bool) -> np.ndarray:
    """For each bf16 of a buffer of swizzled weight slices, its index in the
    concatenation of the source blocks followed by one zero. shapes: (rows N,
    columns K, slice columns C) of each weight in buffer order, each one
    _slice_index of all its rows. Columns past K are zero."""
    parts, base = [], 0
    for N, K, C in shapes:
        parts.append(_slice_index(base, N, K, C, 0, N, k_major))
        base += K * N
    idx = np.concatenate(parts)
    return np.where(idx < 0, base, idx)


@functools.lru_cache(maxsize=4)
def _tile_index(D: int) -> np.ndarray:
    """The forward buffer's gather index (_swizzled_slices) over the
    _packed_blocks (stored (in, out)) in _tile_layout's order: the weights in
    slices of _slice_cols(D) columns, the heads (resident in the kernels'
    shared memory) in 64-column blocks at every width. Past 512, _tile_x_index."""
    if D > 512:
        return _tile_x_index(D)
    return _swizzled_slices([(N, K, SWIZZLE_COLS if i in (9, 13) else _slice_cols(D))
                             for i, N, K in _tile_layout(D)], k_major=False)


# The layers of csrc/mlp_fwd_xwide_sm90.cuh's trunk in the order a tile runs
# them, each as the pack_weights blocks of its products
_XWIDE_LAYERS = ((0,), (1,), (2,), (3,), (4, 5), (6,), (7,), (8,), (10,))


def _tile_x_index(D: int) -> np.ndarray:
    """The forward buffer at 640 to 1024 (csrc/mlp_fwd_xwide_sm90.cuh::TilesX):
    for each layer in the order a tile runs it, for each of its D/128 passes,
    the 64-column slices (128-byte swizzle) of the pass's 128 rows (output
    columns) of each of the layer's blocks (the skip layer: w4's, then w5's);
    then the rgb-hidden layer, pass by pass, w11's and w12's slices of the
    pass's 64 rows (w12's 32 columns padded with zeros to one slice); then the
    two heads in 64-column blocks of 8 rows. Over the same concatenation of
    the _packed_blocks as at every width."""
    base, at = {}, 0
    for i, N, K in _tile_layout(D):
        base[i] = (at, N, K)
        at += N * K

    def rows(i, r0, n, C=SWIZZLE_COLS):
        b, N, K = base[i]
        return _slice_index(b, N, K, C, r0, n, k_major=False)

    passes = D // XWIDE_PASS_COLS
    h_rows = XWIDE_PASS_COLS // 2
    parts = [rows(i, XWIDE_PASS_COLS * p, XWIDE_PASS_COLS)
             for layer in _XWIDE_LAYERS for p in range(passes) for i in layer]
    parts += [rows(i, h_rows * p, h_rows) for p in range(passes) for i in (11, 12)]
    parts += [rows(i, 0, base[i][1], SWIZZLE_COLS) for i in (9, 13)]
    idx = np.concatenate(parts)
    return np.where(idx < 0, at, idx)


def pack_tiles(params: Dict[str, torch.Tensor], cfg: NerfConfig) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """nerf params -> (the forward kernels' tiled bf16 weight buffer, 12 f32
    biases): pack_weights' 14 weights, pre-swizzled and in the order the
    kernels' producer streams them (_tile_index), so each slice is one
    contiguous bulk copy. Three device ops past _packed_blocks: a
    concatenation, a cast and one gather."""
    blocks, biases = _packed_blocks(params, cfg)
    return _gather_slices(blocks, cfg.hidden_dim, _tile_layout, _tile_index), biases


def tile_rows(D: int) -> int:
    """Points of one tile of the kernels' trunk and dX chain at width D: 128
    at 128 and 256, 64 from 384 on."""
    return PTS_PER_PASS if D <= 256 else WIDE_TILE_ROWS


def _tile_dx_layout(D: int) -> List[Tuple[int, int, int]]:
    """(pack_weights index, rows N = inputs, columns K = outputs) of each
    weight of the frozen-network backward's buffer (csrc/mlp_dx_sm90.cuh::
    TilesDx; csrc/mlp_dx_wide_sm90.cuh::TilesDxW at 384 and 512), in the
    order its dX products g_in = g_out W consume them: the
    rgb-hidden layer's direction part (K6 only; K4 starts after it) and x
    part, the feature layer, the trunk from layer 7 down to 1 (w8, w7, w6,
    w4, w3, w2, w1), then the encoding's two products, w0 and the skip's
    encoding part w5."""
    H = D // 2
    return [(12, DE_DIM, H), (11, D, H), (10, D, D), (8, D, D), (7, D, D), (6, D, D),
            (4, D, D), (3, D, D), (2, D, D), (1, D, D), (0, PE_DIM, D), (5, PE_DIM, D)]


@functools.lru_cache(maxsize=4)
def _tile_dx_index(D: int) -> np.ndarray:
    """The backward buffer's gather index (_swizzled_slices): each weight's
    (in, out) block is already (N, K) with K contiguous, the K-major B operand
    of a dX product, cut into slices of _slice_cols(D) columns: 64 in the
    128-byte swizzle at 128 and 256, 32 in the 64-byte one at 384 and 512
    (the wide chain's ring stages hold the forward's 32-column slices)."""
    return _swizzled_slices([(N, K, _slice_cols(D)) for _, N, K in _tile_dx_layout(D)],
                            k_major=True)


@functools.lru_cache(maxsize=16)
def _index_tensor(index_fn, D: int, device: torch.device) -> torch.Tensor:
    """A gather index on `device`, uploaded once (a constant: never written)."""
    return torch.as_tensor(index_fn(D), device=device)


def _gather_slices(blocks: List[torch.Tensor], D: int, layout_fn, index_fn) -> torch.Tensor:
    """The _packed_blocks in layout_fn(D)'s order, cast to bf16 and gathered
    into swizzled slices by index_fn(D): a concatenation, a cast, a gather."""
    order = [blocks[i] for i, _, _ in layout_fn(D)]
    flat = torch.cat([b.reshape(-1) for b in order] + [order[0].new_zeros(1)])
    return flat.to(torch.bfloat16)[_index_tensor(index_fn, D, flat.device)]


def pack_tiles_dx(params: Dict[str, torch.Tensor], cfg: NerfConfig):
    """nerf params -> (the forward buffer of pack_tiles, the frozen-network
    backward's buffer, 12 f32 biases), from one _packed_blocks. The backward
    buffer holds each weight of _tile_dx_layout as 64-column (output) slices
    of its (in, out) storage (32-column ones at 384 and 512), pre-swizzled,
    in the order the chain's producer streams them."""
    blocks, biases = _packed_blocks(params, cfg)
    D = cfg.hidden_dim
    return (_gather_slices(blocks, D, _tile_layout, _tile_index),
            _gather_slices(blocks, D, _tile_dx_layout, _tile_dx_index), biases)


def pack_weights_both(params: Dict[str, torch.Tensor], cfg: NerfConfig):
    """(weights (out, in), weights (in, out), biases): pack_weights' bf16
    blocks in both storages; the (in, out) one, as the params dict stores
    each weight, is what pack_tiles_dx slices for the dX = g W^T products."""
    blocks, biases = _packed_blocks(params, cfg)
    return ([w.t().contiguous().to(torch.bfloat16) for w in blocks],
            [w.contiguous().to(torch.bfloat16) for w in blocks], biases)


def unpack_grads(dWs: List[torch.Tensor], dBs: List[torch.Tensor],
                 cfg: NerfConfig) -> Dict[str, torch.Tensor]:
    """Packed gradients -> the nerf params dict layout (the JAX package's
    `_unpack_grads`, pallas_mlp.py:350). dWs are the 14 blocks of pack_weights
    stored (in, out), the heads with their live columns only (density (D, 1),
    rgb (D/2, 3)); dBs the 12 biases, the heads' with 1 and 3 entries. Undoes
    the row permutation, the splits and the padding."""
    inv_pe = _enc_perm_index(10, True, dWs[0].device)
    inv_de = _enc_perm_index(4, True, dWs[0].device)
    g = {"trunk0_0_w": dWs[0][:63][inv_pe],
         "trunk0_1_w": dWs[1], "trunk0_2_w": dWs[2], "trunk0_3_w": dWs[3],
         "trunk1_0_w": torch.cat([dWs[4], dWs[5][:63][inv_pe]], dim=0),
         "trunk1_1_w": dWs[6], "trunk1_2_w": dWs[7], "trunk1_3_w": dWs[8],
         "density_w": dWs[9], "feature_w": dWs[10],
         "rgb_hidden_w": torch.cat([dWs[11], dWs[12][:27][inv_de]], dim=0),
         "rgb_w": dWs[13]}
    for i in range(4):
        g[f"trunk0_{i}_b"] = dBs[i]
        g[f"trunk1_{i}_b"] = dBs[4 + i]
    g.update(density_b=dBs[8], feature_b=dBs[9], rgb_hidden_b=dBs[10], rgb_b=dBs[11])
    return g


def pack_rays(origin: torch.Tensor, ray_vec: torch.Tensor,
              mlp_dir: torch.Tensor) -> torch.Tensor:
    """[origin | ray_vec | mlp_dir] -> (N, 9) f32 ray table. origin may be (3,)
    (pinhole center, broadcast) or (N, 3) (NDC rays)."""
    n = ray_vec.shape[0]
    origin = origin.reshape(-1, 3).expand(n, 3)
    return torch.cat([origin, ray_vec, mlp_dir], dim=-1).to(torch.float32).contiguous()


def alpha_from_raw(raw: torch.Tensor, z: torch.Tensor, cfg: NerfConfig,
                   dist_alpha: bool) -> torch.Tensor:
    """Raw density (R,S) -> alpha (R,S) (pallas_render.py:146). cfg.dist_alpha
    is the head flag (raw activation vs 1-exp(-act)); `dist_alpha` the
    renderer's delta-scaled opacity with a forced last-sample hit."""
    sigma = softplus(raw) if cfg.occ_activation == "softplus" else torch.relu(raw)
    occ = sigma if cfg.dist_alpha else 1.0 - torch.exp(-sigma)
    if not dist_alpha:
        return occ
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=1)
    alpha = 1.0 - torch.exp(-occ * deltas)
    alpha[:, -1] = 1.0
    return alpha


def prefix_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over the last axis, Hillis-Steele in f32:
    out[s] = sum_{j<s} x[j], in the TPU kernel's order of additions."""
    S = x.shape[-1]
    acc = torch.nn.functional.pad(x[:, :-1], (1, 0))
    d = 1
    while d < S:
        acc = acc + torch.nn.functional.pad(acc[:, :-d], (d, 0))
        d *= 2
    return acc


def composite_scan(alpha: torch.Tensor, z: torch.Tensor, rgb: torch.Tensor):
    """(trans-weighted rgb (R,3), dist (R,), weights (R,S)) with
    trans = exp(exclusive prefix of log(1 - alpha + eps))."""
    trans = torch.exp(prefix_exclusive(torch.log(1.0 - alpha + EPSILON)))
    weights = alpha * trans
    return (weights[..., None] * rgb).sum(dim=1), (weights * z).sum(dim=1), weights


def _encode_points(rays: torch.Tensor, z: torch.Tensor):
    """(pe (T,64), de (n,32)) bf16-rounded dense-lane encodings of the sample
    positions o + v*z (t = r*S + s) and of the per-ray MLP direction."""
    o, v, d = rays[:, 0:3], rays[:, 3:6], rays[:, 6:9]
    pts = (o[:, None, :] + v[:, None, :] * z[..., None]).reshape(-1, 3)
    return bf16_round(encode_lanes(pts, 10, PE_DIM)), bf16_round(encode_lanes(d, 4, DE_DIM))


def _mlp_forward(Wf, B, pe, de, n: int, S: int):
    """The 9-layer MLP with its skip and heads on T = n*S points (the JAX
    package's _fwd_tail): (rgb_raw (T,3), sig_raw (T,), activations
    (x0..x7, feat, h) as bf16-valued f32). Wf are the (out, in) weights as f32
    (bf16 -> f32 is exact); the direction part of the rgb-hidden layer is one
    product per ray."""
    def dot(x, i):
        return x @ Wf[i].t()

    acts = [bf16_round(torch.relu(dot(pe, 0) + B[0]))]
    for i in (1, 2, 3):
        acts.append(bf16_round(torch.relu(dot(acts[-1], i) + B[i])))
    acts.append(bf16_round(torch.relu(dot(acts[-1], 4) + dot(pe, 5) + B[4])))
    for i in (6, 7, 8):
        acts.append(bf16_round(torch.relu(dot(acts[-1], i) + B[i - 1])))
    x7 = acts[-1]
    sig_raw = dot(x7, 9)[:, 0] + B[8][0]
    feat = bf16_round(dot(x7, 10) + B[9])
    de_h = dot(de, 12)                                   # per ray
    H = de_h.shape[1]
    hid = (dot(feat, 11).reshape(n, S, H) + de_h[:, None, :]).reshape(n * S, H)
    h = bf16_round(torch.relu(hid + B[10]))
    rgb_raw = dot(h, 13)[:, :3] + B[11][:3]
    return rgb_raw, sig_raw, acts + [feat, h]


def _plain_block(W, B, rays, z, cfg: NerfConfig, dist_alpha: bool):
    n, S = z.shape
    pe, de = _encode_points(rays, z)
    rgb_raw, sig_raw, _ = _mlp_forward([w.to(torch.float32) for w in W], B, pe, de, n, S)
    rgb = torch.sigmoid(rgb_raw).reshape(n, S, 3)
    alpha = alpha_from_raw(sig_raw.reshape(n, S), z, cfg, dist_alpha)
    rgb_ray, dist, weights = composite_scan(alpha, z, rgb)
    return rgb_ray, dist, weights, alpha


def _check_inputs(rays: torch.Tensor, z: torch.Tensor) -> None:
    if rays.ndim != 2 or rays.shape[1] != RAY_DIM:
        raise ValueError(f"rays must be (N, {RAY_DIM}), got {tuple(rays.shape)}")
    if z.ndim != 2 or z.shape[0] != rays.shape[0]:
        raise ValueError(f"z must be (N, S) with N={rays.shape[0]}, got {tuple(z.shape)}")


def render_rays_fused_plain(params, rays: torch.Tensor, z: torch.Tensor,
                            cfg: NerfConfig, dist_alpha: bool = False,
                            want_aux: bool = True):
    """Plain PyTorch version of the fused kernel, on any device:
    (rgb (N,3), dist (N,), weights (N,S) or None, alpha (N,S) or None)."""
    _check_inputs(rays, z)
    W, B = pack_weights(params, cfg)
    rays = rays.to(torch.float32)
    z = z.to(torch.float32)
    outs = [_plain_block(W, B, rays[i:i + PLAIN_BLOCK_RAYS], z[i:i + PLAIN_BLOCK_RAYS],
                         cfg, dist_alpha)
            for i in range(0, max(rays.shape[0], 1), PLAIN_BLOCK_RAYS)]
    rgb, dist, weights, alpha = (torch.cat(t, dim=0) for t in zip(*outs))
    if not want_aux:
        return rgb, dist, None, None
    return rgb, dist, weights, alpha


def _render_cuda(tiles, B, rays, z, cfg: NerfConfig, dist_alpha: bool, want_aux: bool,
                 xops: Optional[torch.Tensor] = None):
    """(rgb, dist, weights, alpha) by one launch of the render kernel, from
    pack_tiles' (tiles, B). With `xops` (render_operand_bytes' X bytes) the
    kernel's check build runs instead and also writes the X operands there
    (render_fwd_operands): not counted, and no weights or alpha."""
    n, S = z.shape
    _check_kernel_shapes("render", S, cfg.hidden_dim)
    D = cfg.hidden_dim
    for name, t in (("rays", rays), ("z", z)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != rays.device:
            raise ValueError("rays and z must be on the same device")
    for t in [tiles] + B:
        if t.device != rays.device or not t.is_contiguous():
            raise ValueError("packed params must be contiguous on the rays' device")
    lib = RENDER_FWD.lib()
    rgb = torch.empty((n, 3), dtype=torch.float32, device=rays.device)
    dist = torch.empty((n,), dtype=torch.float32, device=rays.device)
    weights = alpha = None
    if want_aux:
        weights = torch.empty((n, S), dtype=torch.float32, device=rays.device)
        alpha = torch.empty((n, S), dtype=torch.float32, device=rays.device)
    if n == 0:
        return rgb, dist, weights, alpha
    bptrs = (ctypes.c_void_p * 12)(*[b.data_ptr() for b in B])
    with torch.cuda.device(rays.device):
        # the per-sample arrays past shared memory's room (S > 3,840 at D = 256) and,
        # past 512, the trunk's staging
        spill = _spill(lib.nerf_render_fwd_spill(n, S, D), rays.device)
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        flags = (int(cfg.occ_activation == "softplus"), int(cfg.dist_alpha), int(dist_alpha))
        if xops is None:
            err = lib.nerf_render_fwd(
                rays.data_ptr(), z.data_ptr(), tiles.data_ptr(), bptrs, rgb.data_ptr(),
                dist.data_ptr(),
                weights.data_ptr() if want_aux else None,
                alpha.data_ptr() if want_aux else None,
                _ptr(spill), n, S, D, *flags, stream)
        else:
            err = lib.nerf_render_fwd_operands(
                rays.data_ptr(), z.data_ptr(), tiles.data_ptr(), bptrs, rgb.data_ptr(),
                dist.data_ptr(), _ptr(spill), xops.data_ptr(), n, S, D, *flags, stream)
    if err != 0:
        raise RuntimeError("render kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    if xops is None:
        RENDER_FWD.launches += 1
    return rgb, dist, weights, alpha


def x_operands(pe: torch.Tensor, acts: List[torch.Tensor],
               de: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The X operands of the dW products (pe, x0..x7, feat and, for the
    point-query MLP, de) from a plain forward's encodings and activations, as
    the kernels write them: each in fused_mlp.tile_operand's layout, the
    operands one after the other, flat bf16."""
    from .fused_mlp import tile_operand   # fused_mlp imports this module
    ops = [pe] + list(acts[:9]) + ([] if de is None else [de])
    return torch.cat([tile_operand(x).reshape(-1) for x in ops])


def render_fwd_operands(params, rays: torch.Tensor, z: torch.Tensor, cfg: NerfConfig,
                        dist_alpha: bool = False):
    """(rgb (N,3), dist (N,), X) by the render kernel's check build: the
    forward of render_rays_fused that also writes the X operands of the
    rays' samples (x_operands' layout, rows in the order r S + s: pe, x0..x7,
    feat), which K1 and K4 full write for their dW products from the same
    forward. For checks only; no main path calls it, and its launches are not
    counted. On the CPU the plain version's (_plain_forward's)."""
    _check_inputs(rays, z)
    n, S = z.shape
    with torch.no_grad():
        if runs_plain(rays):
            W, B = pack_weights(params, cfg)
            fwd = _plain_forward([w.to(torch.float32) for w in W], B, rays.to(torch.float32),
                                 z.to(torch.float32), cfg, dist_alpha)
            return fwd["ray_rgb"], fwd["dist"], x_operands(fwd["pe"], fwd["acts"])
        tiles, B = pack_tiles(params, cfg)
        xops = torch.zeros((render_operand_bytes(cfg.hidden_dim, n, S)[0] // 2,),
                           dtype=torch.bfloat16, device=rays.device)
        rgb, dist, _, _ = _render_cuda(tiles, B, rays.detach(), z.detach(), cfg, dist_alpha,
                                       False, xops)
        return rgb, dist, xops


# ---------------------------------------------------------------------------
# Train-fused path: one launch per step = loss values + every gradient
# (pallas_render.py::render_ray_loss_fused, kernel K1).
# ---------------------------------------------------------------------------

TGT_DIM = 7             # target table columns: rgb_gt (0-2), then
TGT_DEPTH = 3           # depth_gt, in the same (dist) space as the kernel's dist
TGT_MASK = 4            # depth-loss validity mask, 0.0/1.0
TGT_WRGB = 5            # annealed rgb_weight / n_total (same value every row)
TGT_WDEPTH = 6          # annealed depth_weight * (count>0) / max(count, 1)
PLAIN_TRAIN_BLOCK_RAYS = 256
# The dW operands a launch of K1 or K4 full holds at once (render_chunks):
# 1024 rays x 256 samples at D = 256, 2.52 GB.
OPERAND_BUDGET_BYTES = 1024 * 256 * 9600


def _setup_train(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_train_grad_layout.argtypes = [i, p]
    lib.nerf_train_grad_layout.restype = ctypes.c_int
    lib.nerf_render_train_scratch.argtypes = [i, ctypes.c_longlong, i, i, p]
    lib.nerf_render_train_scratch.restype = ctypes.c_int
    lib.nerf_render_train.argtypes = [p] * 16 + [i] * 12 + [p]
    lib.nerf_render_train.restype = ctypes.c_int
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


RENDER_TRAIN = CudaLibrary("render_train.cu", _setup_train)


def pack_targets(rgb_gt: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor,
                 w_rgb_scaled, w_depth_scaled) -> torch.Tensor:
    """(N,3) rgb_gt, (N,) depth_gt and mask and the two scaled loss weights
    (numbers or 0-d tensors) -> the (N, 7) f32 target table (columns TGT_*)."""
    n = rgb_gt.shape[0]

    def col(v):
        if torch.is_tensor(v):
            return v.to(device=rgb_gt.device, dtype=torch.float32).expand(n, 1)
        return torch.full((n, 1), float(v), dtype=torch.float32, device=rgb_gt.device)

    return torch.cat([rgb_gt.to(torch.float32), depth_gt.to(torch.float32)[:, None],
                      mask.to(torch.float32)[:, None], col(w_rgb_scaled),
                      col(w_depth_scaled)], dim=1).contiguous()


def suffix_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive suffix sum over the last axis, Hillis-Steele in f32:
    out[s] = sum_{j>s} x[j], in the order of the TPU kernel's
    _lane_suffix_exclusive."""
    S = x.shape[-1]
    acc = torch.nn.functional.pad(x[:, 1:], (0, 1))
    d = 1
    while d < S:
        acc = acc + torch.nn.functional.pad(acc[:, d:], (0, d))
        d *= 2
    return acc


def _enc_deriv_to_coords(dpe, x, levels: int):
    """Cotangent of a dense-lane encoding (M, >= 3+6L) -> cotangent of its
    (M, 3) argument, with the f32 sin/cos of the forward's arguments:
    d/dx_c = dpe[c] + sum_i 2^i (dpe_sin[3i+c] cos(2^i x_c) - dpe_cos[3i+c] sin(2^i x_c))."""
    scale = torch.tensor([2.0 ** i for i in range(levels)], dtype=x.dtype, device=x.device)
    args = x[:, None, :] * scale[None, :, None]                       # (M, L, 3)
    d_sin = dpe[:, 3:3 + 3 * levels].reshape(-1, levels, 3)
    d_cos = dpe[:, 3 + 3 * levels:3 + 6 * levels].reshape(-1, levels, 3)
    d_arg = d_sin * torch.cos(args) - d_cos * torch.sin(args)
    return dpe[:, :3] + (d_arg * scale[None, :, None]).sum(dim=1)


def _plain_forward(Wf, B, rays, z, cfg: NerfConfig, dist_alpha: bool,
                   dtype: torch.dtype = torch.float32) -> Dict[str, object]:
    """The forward of one block of f32 rays with everything its backward reads
    (pallas_render.py:146-218): encodings, activations, heads, alpha and the
    composite, before any white background. The sample points and their
    bf16-rounded encodings are always formed in f32; with `dtype` float64
    (and Wf in float64) everything after them is summed in f64."""
    n, S = z.shape
    o, v = rays[:, 0:3], rays[:, 3:6]
    pts = (o[:, None, :] + v[:, None, :] * z[..., None]).reshape(-1, 3).to(dtype)
    pe, de = (t.to(dtype) for t in _encode_points(rays, z))
    z = z.to(dtype)
    rgb_raw, sig_raw, acts = _mlp_forward(Wf, B, pe, de, n, S)
    raw = sig_raw.reshape(n, S)
    sigma = softplus(raw) if cfg.occ_activation == "softplus" else torch.relu(raw)
    occ = sigma if cfg.dist_alpha else 1.0 - torch.exp(-sigma)
    last = torch.zeros(S, dtype=torch.bool, device=z.device)
    last[-1] = True
    deltas = None
    if dist_alpha:
        deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=1)
        alpha = torch.where(last, torch.ones_like(occ), 1.0 - torch.exp(-occ * deltas))
    else:
        alpha = occ
    trans = torch.exp(prefix_exclusive(torch.log(1.0 - alpha + EPSILON)))
    weights = alpha * trans
    rgb3 = torch.sigmoid(rgb_raw).reshape(n, S, 3)
    return {"pts": pts, "pe": pe, "de": de, "acts": acts, "raw": raw, "occ": occ, "last": last,
            "deltas": deltas, "alpha": alpha, "trans": trans, "weights": weights, "rgb3": rgb3,
            "dist": (weights * z).sum(dim=1),
            "ray_rgb": (weights[..., None] * rgb3).sum(dim=1)}


def mlp_backward(Wf, pe, de, acts, g_rgb, g_sig, n: int, S: int,
                 want_param_grads: bool = True, taps: Optional[Dict[str, torch.Tensor]] = None):
    """MLP backward (pallas_mlp.py:207-260) from the cotangents of the raw
    heads, g_rgb (T,3) and g_sig (T,), over T = n*S points whose direction
    encoding `de` (n,32) is shared by each group of S: dW = x^T . bf16(g)
    stored (in, out), dX = bf16(g) . W^T with Wf[i] = W^T (the (out, in)
    weights as f32). Returns (dWs [14], dBs [12], dpe (T,64), dde (n,32));
    with want_param_grads=False (a frozen network) the same dpe and dde, and
    dWs, dBs None: the dX chain alone. A `taps` dict receives the bf16-valued
    cotangents that enter the dW products: g_h, g_feat, g7 .. g0."""
    r = bf16_round
    x0, x1, x2, x3, x4, x5, x6, x7, feat, h = acts
    dW: List[Optional[torch.Tensor]] = [None] * 14
    dB: List[Optional[torch.Tensor]] = [None] * 12

    def grads(wi, bi, x_in, g):
        if want_param_grads:
            dW[wi], dB[bi] = x_in.t() @ r(g), g.sum(dim=0)

    H = h.shape[1]
    grads(13, 11, h, g_rgb)
    g_h = (r(g_rgb) @ Wf[13][:3]) * (h > 0)
    rg_h = r(g_h)
    grads(11, 10, feat, g_h)
    if want_param_grads:
        dW[12] = de.t() @ rg_h.reshape(n, S, H).sum(dim=1)  # rounded per point, then summed
    dde = (rg_h @ Wf[12]).reshape(n, S, DE_DIM).sum(dim=1)  # (n, 32)
    g_feat = rg_h @ Wf[11]
    grads(10, 9, x7, g_feat)
    if want_param_grads:
        dW[9], dB[8] = x7.t() @ r(g_sig)[:, None], g_sig.sum().reshape(1)
    g = (r(g_feat) @ Wf[10] + r(g_sig)[:, None] * Wf[9][0][None, :]) * (x7 > 0)
    if taps is not None:
        taps.update(g_h=rg_h, g_feat=r(g_feat), g7=r(g))
    for wi, bi, x_in in ((8, 7, x6), (7, 6, x5), (6, 5, x4)):
        grads(wi, bi, x_in, g)
        g = (r(g) @ Wf[wi]) * (x_in > 0)
        if taps is not None:
            taps[f"g{wi - 2}"] = r(g)
    g4 = g
    for wi, bi, x_in in ((4, 4, x3), (3, 3, x2), (2, 2, x1), (1, 1, x0)):
        grads(wi, bi, x_in, g)
        g = (r(g) @ Wf[wi]) * (x_in > 0)
        if taps is not None:
            taps[f"g{wi - 1}"] = r(g)
    g0 = g
    if want_param_grads:
        dB[0] = g0.sum(dim=0)
        dW[0], dW[5] = pe.t() @ r(g0), pe.t() @ r(g4)
    dpe = r(g0) @ Wf[0] + r(g4) @ Wf[5]                      # (T, 64)
    if not want_param_grads:
        return None, None, dpe, dde
    return dW, dB, dpe, dde


def _plain_backward_tail(Wf, rays, z, fwd: Dict[str, object], cfg: NerfConfig, dist_alpha: bool,
                         g_rgb_ray, g_dist, g_w_in, g_a_in, white_bg: bool,
                         taps: Optional[Dict[str, torch.Tensor]] = None):
    """Composite -> heads -> MLP -> encoding backward of one block of rays
    (pallas_render.py::_backward_tail), step by step (not autograd: autograd
    would not round the cotangents to bf16 before each product). `fwd` is
    _plain_forward's; g_rgb_ray (n,3) and g_dist (n,) are the cotangents of
    the rays' rgb and dist, g_w_in / g_a_in (n,S) or None those of the
    per-sample weights and alpha; white_bg folds the gradient of the
    1 - sum(weights) term in. Returns (dWs [14] stored (in, out), dBs [12],
    drays (n,9), dz (n,S)); a `taps` dict receives mlp_backward's taps and
    the bf16-valued raw-density and raw-rgb cotangents g_sig (T,), g_rgb (T,3)."""
    n, S = z.shape
    v, d = rays[:, 3:6], rays[:, 6:9]
    pts, pe, de = fwd["pts"], fwd["pe"], fwd["de"]
    raw, occ, last, deltas = fwd["raw"], fwd["occ"], fwd["last"], fwd["deltas"]
    alpha, trans, weights, rgb3 = fwd["alpha"], fwd["trans"], fwd["weights"], fwd["rgb3"]

    # ---- composite backward (:435-472) --------------------------------------
    g_w = (g_rgb_ray[:, None, :] * rgb3).sum(dim=2) + g_dist[:, None] * z
    if white_bg:
        g_w = g_w - g_rgb_ray.sum(dim=1, keepdim=True)
    if g_w_in is not None:
        g_w = g_w + g_w_in
    g_logs = suffix_exclusive(g_w * weights)
    g_alpha = g_w * trans - g_logs / (1.0 - alpha + EPSILON)
    if g_a_in is not None:
        g_alpha = g_alpha + g_a_in
    g_z = g_dist[:, None] * weights
    if dist_alpha:
        E = torch.exp(-occ * deltas)
        g_apre = torch.where(last, torch.zeros_like(g_alpha), g_alpha)
        g_occ = g_apre * deltas * E
        g_delta = torch.where(last, torch.zeros_like(g_alpha), g_apre * occ * E)
        g_z = g_z - g_delta + torch.nn.functional.pad(g_delta[:, :-1], (1, 0))
    else:
        g_occ = g_alpha
    g_sigma = g_occ if cfg.dist_alpha else g_occ * (1.0 - occ)
    if cfg.occ_activation == "softplus":
        g_raw = g_sigma * torch.sigmoid(raw)
    else:
        g_raw = g_sigma * (raw > 0.0)
    g_sig = g_raw.reshape(-1)                                              # (T,)
    g_rgb = (weights[..., None] * g_rgb_ray[:, None, :] * rgb3 * (1.0 - rgb3)).reshape(-1, 3)
    dW, dB, dpe, dde = mlp_backward(Wf, pe, de, fwd["acts"], g_rgb, g_sig, n, S, True, taps)
    if taps is not None:
        taps.update(g_sig=bf16_round(g_sig), g_rgb=bf16_round(g_rgb))

    # ---- encoding backward -> ray table and z (:484-523) --------------------
    dpts = _enc_deriv_to_coords(dpe, pts, 10).reshape(n, S, 3)
    g_z = g_z + (dpts * v[:, None, :]).sum(dim=2)
    drays = torch.cat([dpts.sum(dim=1), (dpts * z[..., None]).sum(dim=1),
                       _enc_deriv_to_coords(dde, d, 4)], dim=1)
    return dW, dB, drays, g_z


def _plain_train_block(Wf, B, rays, z, tgt, cfg: NerfConfig, dist_alpha: bool,
                       rgb_p: int, white_bg: bool):
    """K1's arithmetic on one block of rays, step by step: forward, loss sums,
    analytic cotangents and the explicit backward. Returns (sums (3,), dWs
    [14] stored (in, out), dBs [12], drays (n,9), dz (n,S), dtgt (n,7))."""
    fwd = _plain_forward(Wf, B, rays, z, cfg, dist_alpha)
    dist, ray_rgb = fwd["dist"], fwd["ray_rgb"]
    if white_bg:
        ray_rgb = ray_rgb + (1.0 - fwd["weights"].sum(dim=1, keepdim=True))

    # ---- loss values and analytic cotangents (:666-695) ---------------------
    diff = ray_rgb - tgt[:, 0:3]
    m, w_rgb, w_depth = tgt[:, TGT_MASK], tgt[:, TGT_WRGB], tgt[:, TGT_WDEPTH]
    ddiff = dist - tgt[:, TGT_DEPTH]
    row_rgb = (diff.abs() if rgb_p == 1 else diff * diff).sum(dim=1)
    row_depth = m * ddiff.abs()
    sums = torch.stack([row_rgb.sum(), row_depth.sum(), (diff * diff).sum()])
    g_rgb_ray = w_rgb[:, None] * (torch.sign(diff) if rgb_p == 1 else 2.0 * diff)
    g_dist = w_depth * m * torch.sign(ddiff)
    zero = torch.zeros_like(g_dist)
    dtgt = torch.stack([-g_rgb_ray[:, 0], -g_rgb_ray[:, 1], -g_rgb_ray[:, 2], -g_dist, zero,
                        row_rgb, row_depth], dim=1)
    dW, dB, drays, g_z = _plain_backward_tail(Wf, rays, z, fwd, cfg, dist_alpha, g_rgb_ray,
                                              g_dist, None, None, white_bg)
    return sums, dW, dB, drays, g_z, dtgt


def _check_train_inputs(rays, z, tgt) -> None:
    _check_inputs(rays, z)
    if rays.shape[0] == 0:
        raise ValueError("the train kernel needs at least one ray")
    if tgt.ndim != 2 or tuple(tgt.shape) != (rays.shape[0], TGT_DIM):
        raise ValueError(f"tgt must be (N, {TGT_DIM}) with N={rays.shape[0]}, "
                         f"got {tuple(tgt.shape)}")


def _sum_blocks(per_block: List[List[torch.Tensor]]) -> List[torch.Tensor]:
    """Sum each entry of the blocks' lists, in block order."""
    out = list(per_block[0])
    for block in per_block[1:]:
        out = [a + b for a, b in zip(out, block)]
    return out


def _train_plain(params, rays, z, tgt, cfg: NerfConfig, dist_alpha: bool, rgb_p: int,
                 white_bg: bool):
    """(sums, dWs, dBs, drays, dz, dtgt) by the plain version, in blocks of
    rays summed in order: two runs give the same bits."""
    W, B = pack_weights(params, cfg)
    Wf = [w.to(torch.float32) for w in W]
    rays, z, tgt = (t.detach().to(torch.float32) for t in (rays, z, tgt))
    parts = [_plain_train_block(Wf, B, rays[i:i + PLAIN_TRAIN_BLOCK_RAYS],
                                z[i:i + PLAIN_TRAIN_BLOCK_RAYS],
                                tgt[i:i + PLAIN_TRAIN_BLOCK_RAYS], cfg, dist_alpha, rgb_p,
                                white_bg)
             for i in range(0, rays.shape[0], PLAIN_TRAIN_BLOCK_RAYS)]
    sums = parts[0][0]
    for part in parts[1:]:
        sums = sums + part[0]
    dW, dB = _sum_blocks([part[1] for part in parts]), _sum_blocks([part[2] for part in parts])
    drays, dz, dtgt = (torch.cat([part[k] for part in parts], dim=0) for k in (3, 4, 5))
    return sums, dW, dB, drays, dz, dtgt


# The hidden_dim each CUDA kernel takes, by the name its wrapper raises with:
# 128 and 256 on the 128-row trunk and dX chain of csrc/mlp_fwd_sm90.cuh and
# csrc/mlp_dx_sm90.cuh, 384 and 512 on the 64-row ones of
# csrc/mlp_fwd_wide_sm90.cuh and csrc/mlp_dx_wide_sm90.cuh (the kernels that
# form weight gradients, K1, K4 full and K6 full, with
# csrc/mlp_dw_chain_sm90.cuh's OperandSaveW there); the forward kernels, K3
# and K5, also 640 to 1024 on csrc/mlp_fwd_xwide_sm90.cuh's trunk.
BACKWARD_WIDTHS = (128, 256, 384, 512)
FORWARD_WIDTHS = BACKWARD_WIDTHS + (640, 768, 896, 1024)
KERNEL_WIDTHS = {"render": FORWARD_WIDTHS, "point-query MLP forward": FORWARD_WIDTHS,
                 "render-backward (frozen network)": BACKWARD_WIDTHS,
                 "point-query MLP backward (frozen network)": BACKWARD_WIDTHS,
                 "point-query MLP backward": BACKWARD_WIDTHS,
                 "train": BACKWARD_WIDTHS, "render-backward": BACKWARD_WIDTHS}
# The entry of ROADMAP.md's Queue 3 (c) that brings each backward kernel to
# 640 to 1024, on the forward the forward kernels run there
BACKWARD_QUEUE = {"render-backward (frozen network)": 2,
                  "point-query MLP backward (frozen network)": 2,
                  "point-query MLP backward": 3, "train": 4, "render-backward": 4}


def check_kernel_width(kernel: str, D: int) -> None:
    """Raise NotImplementedError, before any device work, unless the CUDA
    `kernel` (a key of KERNEL_WIDTHS) takes hidden_dim D; past 512 naming the
    entry of ROADMAP.md's Queue 3 (c) that would bring D to it."""
    widths = KERNEL_WIDTHS[kernel]
    if D in widths:
        return
    if D > FORWARD_WIDTHS[-1]:
        why = (f": widths past {FORWARD_WIDTHS[-1]} need a tile plan of their own in every "
               "trunk header (ROADMAP.md, Queue 3 (c))")
    elif D > BACKWARD_WIDTHS[-1] and D in FORWARD_WIDTHS:
        why = (f": only the forward kernels run past {BACKWARD_WIDTHS[-1]}; this one is queued "
               f"on their trunk (ROADMAP.md, Queue 3 (c), item {BACKWARD_QUEUE[kernel]})")
    else:
        why = ""
    raise NotImplementedError(
        f"the CUDA {kernel} kernel takes hidden_dim {', '.join(map(str, widths))}, got {D}"
        + why)


def render_bwd_kernel(want_param_grads: bool) -> str:
    """The KERNEL_WIDTHS name of the render backward's variant: the full
    kernel when a nerf parameter wants a gradient, else the frozen one."""
    return "render-backward" if want_param_grads else "render-backward (frozen network)"


def _check_kernel_shapes(kernel: str, S: int, D: int) -> None:
    """What a render kernel takes: any S % 128 == 0 (the JAX kernels' own
    rule) and the hidden_dim of KERNEL_WIDTHS; anything else raises before
    any device work."""
    if S % PTS_PER_PASS or S <= 0:
        raise NotImplementedError(
            f"the CUDA {kernel} kernel takes S % {PTS_PER_PASS} == 0, got S={S}")
    check_kernel_width(kernel, D)


def _scratch_bytes(nbytes: int, dev: torch.device) -> torch.Tensor:
    """The per-CTA scratch a frozen-network backward kernel's C entry asks for."""
    if nbytes <= 0:
        raise RuntimeError("the backward kernel reports no scratch size")
    return torch.empty((nbytes,), dtype=torch.uint8, device=dev)


def _spill(nbytes: int, dev: torch.device) -> Optional[torch.Tensor]:
    """The scratch a kernel's C entry asks for: a render kernel's per-sample
    arrays that do not fit in shared memory and, in K3 and K5 past 512, the
    trunk's staging (None for none)."""
    if nbytes < 0:
        raise RuntimeError("the kernel reports no scratch size")
    return None if nbytes == 0 else torch.empty((nbytes // 4,), dtype=torch.float32, device=dev)


def _check_backward_tensors(named, dev: torch.device) -> None:
    for name, t in named:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != dev:
            raise ValueError(f"{name} must be on the rays' device")


def _backward_ctas(n: int, dev: torch.device) -> int:
    """One persistent CTA per SM, each with its own partial sums."""
    return min(n, torch.cuda.get_device_properties(dev).multi_processor_count)


def render_operand_bytes(D: int, n_rays: int, S: int) -> Tuple[int, int]:
    """Bytes of the X and G operands K1 and K4 full hand the dW kernel for
    n_rays x S samples: every operand is one 128-row tile per 128 samples of
    64-column bf16 blocks (16 KB each; at 384 and 512 two 64-point passes
    fill a row tile's halves). X: pe (1 block), x0..x7 and feat (D/64 each);
    G: g_h (D/128), g_feat and g7..g0 (D/64 each). At D = 256, 4,736 and
    4,864 B a sample; 14,336 B in all at 384, 19,072 at 512."""
    tiles = n_rays * (S // PTS_PER_PASS)
    block = PTS_PER_PASS * 2 * SWIZZLE_COLS
    return tiles * block * (1 + 9 * (D // 64)), tiles * block * (D // 128 + 9 * (D // 64))


def render_chunks(n_rays: int, S: int, D: int) -> List[Tuple[int, int]]:
    """The chunks of rays [start, stop) a launch of K1 or K4 full goes through,
    in order: the fewest whose dW operands (render_operand_bytes) each stay
    within OPERAND_BUDGET_BYTES, all of one size but the last, which takes
    the rest. One chunk for every call up to 1024 x 256 samples at D = 256,
    and up to 1024 x 128 at 384 and 512."""
    fit = max(1, OPERAND_BUDGET_BYTES // sum(render_operand_bytes(D, 1, S)))
    step = -(-n_rays // -(-n_rays // fit))
    return [(a, min(a + step, n_rays)) for a in range(0, n_rays, step)]


def _full_scratch(scratch_fn, D: int, n: int, S: int, dev: torch.device):
    """(chunk_rays, n_ctas, chunks, [xops, gops, chain_part, dw_part, spill,
    scratch]) for one launch of K1 or K4 full: the rays' chunks by
    render_chunks, the scratch sizes of one chunk from the kernel's own entry
    (its X and G operands checked against render_operand_bytes), the dW
    kernel's chunks of samples by fused_mlp.dw_chunks; spill is None where
    the per-sample arrays fit in shared memory, scratch (the wide chain's
    per-CTA g4, column sums, masks and h) None at 128 and 256."""
    from .fused_mlp import dw_chunks   # fused_mlp imports this module
    chunk_rays = render_chunks(n, S, D)[0][1]
    n_ctas = _backward_ctas(chunk_rays, dev)
    sizes = (ctypes.c_longlong * 7)()
    if scratch_fn(D, chunk_rays, S, n_ctas, sizes) != 0:
        raise RuntimeError("the render backward kernel reports no scratch sizes")
    if (sizes[0], sizes[1]) != render_operand_bytes(D, chunk_rays, S):
        raise RuntimeError(f"the render backward kernel's operand sizes {sizes[0]}, {sizes[1]} "
                           f"are not render_operand_bytes' "
                           f"{render_operand_bytes(D, chunk_rays, S)}")
    if (sizes[6] > 0) != (D > 256):
        raise RuntimeError(f"the render backward kernel reports {sizes[6]} B of wide-chain "
                           f"scratch at hidden_dim {D}")
    chunks = dw_chunks(sizes[4], chunk_rays * S,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = [torch.empty((sizes[i],), dtype=torch.uint8, device=dev) for i in (0, 1)]
    scratch += [torch.empty((sizes[2] // 4,), dtype=torch.float32, device=dev),
                torch.empty((chunks * sizes[3] // 4,), dtype=torch.float32, device=dev),
                _spill(sizes[5], dev),
                torch.empty((sizes[6],), dtype=torch.uint8, device=dev) if sizes[6] else None]
    return chunk_rays, n_ctas, chunks, scratch


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _full_operands(operands: Optional[list], scratch, chunk_rays: int, n: int) -> None:
    """For checks: hand the caller (a list given as `operands`) the buffer
    of X operands a launch of K1 or K4 full fills for the dW kernel, flat
    bf16 in render_fwd_operands' layout, zeroed first. A call in more than
    one chunk of rays keeps only its last chunk's there, so it raises."""
    if operands is None:
        return
    if chunk_rays != n:
        raise ValueError(f"the operands of {n} rays come in chunks of {chunk_rays}: pass one "
                         "chunk of rays at a time (render_chunks)")
    scratch[0].zero_()
    operands.append(scratch[0].view(torch.bfloat16))


def _count_full_launches(lib, n: int, chunk_rays: int) -> None:
    """K1 and K4 full launch their chain kernel and the dW kernel once per
    chunk of rays from their own C entries: that many more launches of each."""
    from .fused_mlp import DW_SM90   # fused_mlp imports this module
    launched = -(-n // chunk_rays)
    lib.launches += launched
    DW_SM90.launches += launched


def _grad_blocks(grads: torch.Tensor, offsets, D: int):
    """The 14 dW (in, out) and 12 dB views of a kernel's gradient buffer."""
    H = D // 2
    w_shapes = [(PE_DIM, D), (D, D), (D, D), (D, D), (D, D), (PE_DIM, D), (D, D), (D, D),
                (D, D), (D, 1), (D, D), (D, H), (DE_DIM, H), (H, 3)]
    b_shapes = [(D,)] * 8 + [(1,), (D,), (H,), (3,)]
    blocks = [grads[off:off + int(np.prod(shape))].view(shape)
              for off, shape in zip(offsets, w_shapes + b_shapes)]
    return blocks[:14], blocks[14:26]


def _train_cuda(params, rays, z, tgt, cfg: NerfConfig, dist_alpha: bool, rgb_p: int,
                white_bg: bool, operands: Optional[list] = None):
    """(sums, dWs, dBs, drays, dz, dtgt) by one launch of the train kernel:
    its C entry issues, for each chunk of rays (render_chunks), the chain,
    the in-order sum of the chain's partial sums and the dW kernel (with its
    in-order sum of the chunks of samples). A list given as `operands` gets
    the X operands the chain handed the dW kernel (_full_operands)."""
    n, S = z.shape
    D = cfg.hidden_dim
    _check_kernel_shapes("train", S, D)
    dev = rays.device
    rays, z, tgt = (t.detach() for t in (rays, z, tgt))
    _check_backward_tensors((("rays", rays), ("z", z), ("tgt", tgt)), dev)
    tiles, tiles_dx, _B, bptrs = _packed_tiles_on(params, cfg, dev)
    lib = RENDER_TRAIN.lib()
    offsets = (ctypes.c_int * 27)()
    total = lib.nerf_train_grad_layout(D, offsets)
    if total <= 0:
        raise RuntimeError("the train kernel reports no gradient layout")
    chunk_rays, n_ctas, chunks, scratch = _full_scratch(lib.nerf_render_train_scratch, D, n, S,
                                                        dev)
    _full_operands(operands, scratch, chunk_rays, n)
    f32 = dict(dtype=torch.float32, device=dev)
    grads = torch.empty((total,), **f32)
    drays = torch.empty((n, RAY_DIM), **f32)
    dz = torch.empty((n, S), **f32)
    dtgt = torch.empty((n, TGT_DIM), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_render_train(
            rays.data_ptr(), z.data_ptr(), tgt.data_ptr(), tiles.data_ptr(), tiles_dx.data_ptr(),
            bptrs, *[_ptr(t) for t in scratch], grads.data_ptr(), drays.data_ptr(),
            dz.data_ptr(), dtgt.data_ptr(), n, chunk_rays, S, D, n_ctas, chunks,
            int(cfg.occ_activation == "softplus"), int(cfg.dist_alpha), int(dist_alpha),
            int(rgb_p), int(white_bg), total, stream)
    if err != 0:
        raise RuntimeError("train kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    _count_full_launches(RENDER_TRAIN, n, chunk_rays)
    dWs, dBs = _grad_blocks(grads, offsets, D)
    sums = grads[offsets[26]:offsets[26] + 3]
    return sums, dWs, dBs, drays, dz, dtgt


class _RayLossFused(torch.autograd.Function):
    """One launch computes the loss and stashes every gradient; backward only
    scales them by the cotangent of `total` (pallas_render.py:1017-1031)."""

    @staticmethod
    def forward(ctx, rays, z, tgt, cfg, dist_alpha, rgb_p, white_bg, names, *tensors):
        params = dict(zip(names, tensors))
        run = _train_plain if runs_plain(rays) else _train_cuda
        sums, dWs, dBs, drays, dz, dtgt = run(params, rays, z, tgt, cfg, dist_alpha, rgb_p,
                                              white_bg)
        grads = unpack_grads(dWs, dBs, cfg)
        total = tgt[0, TGT_WRGB] * sums[0] + tgt[0, TGT_WDEPTH] * sums[1]
        ctx.save_for_backward(drays, dz, dtgt, *[grads[k].to(params[k].dtype) for k in names])
        sums = sums.clone()
        ctx.mark_non_differentiable(sums)
        return total, sums

    @staticmethod
    def backward(ctx, g_total, _g_sums):
        drays, dz, dtgt, *grads = ctx.saved_tensors
        return (drays * g_total, dz * g_total, dtgt * g_total, None, None, None, None, None,
                *[g * g_total for g in grads])


def render_ray_loss_fused(params, rays: torch.Tensor, z: torch.Tensor, tgt: torch.Tensor,
                          cfg: NerfConfig, dist_alpha: bool, rgb_p: int, white_bg: bool):
    """(params, ray table (N,9), z (N,S), target table (N,7)) -> (total, sums (3,)):
    total = w_rgb' sum|rgb-gt|^p + w_depth' sum m|dist-dgt| (the weights ride
    in the target table, TGT_*) and sums are the unweighted
    [sum|rgb-gt|^p, sum m|dist-dgt|, sum (rgb-gt)^2], metrics without gradient.

    Gradients flow to the nerf params, the ray table, z and the target table.
    On a CUDA tensor the hand-written train kernel computes values and
    gradients in one launch; on a CPU tensor, and on any tensor inside
    `plain_versions()`, render_ray_loss_fused_plain's arithmetic does."""
    _check_train_inputs(rays, z, tgt)
    if rays.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no train kernel for device {rays.device}")
    if rgb_p not in (1, 2):
        raise ValueError("rgb_p must be 1 (L1) or 2 (L2)")
    names = tuple(sorted(params))
    return _RayLossFused.apply(rays, z, tgt, cfg, bool(dist_alpha), int(rgb_p), bool(white_bg),
                               names, *[params[k] for k in names])


def render_ray_loss_fused_plain(params, rays: torch.Tensor, z: torch.Tensor,
                                tgt: torch.Tensor, cfg: NerfConfig, dist_alpha: bool,
                                rgb_p: int, white_bg: bool):
    """Plain PyTorch version of the train kernel, on any device:
    (total, sums (3,), grads) with grads = {"params": nerf-params-shaped dict,
    "rays": (N,9), "z": (N,S), "tgt": (N,7)}, the gradients of `total`."""
    _check_train_inputs(rays, z, tgt)
    with torch.no_grad():
        sums, dWs, dBs, drays, dz, dtgt = _train_plain(params, rays, z, tgt, cfg, dist_alpha,
                                                       rgb_p, white_bg)
        total = tgt[0, TGT_WRGB] * sums[0] + tgt[0, TGT_WDEPTH] * sums[1]
    return total, sums, {"params": unpack_grads(dWs, dBs, cfg), "rays": drays, "z": dz,
                         "tgt": dtgt}


# ---------------------------------------------------------------------------
# The render's backward (pallas_render.py::_render_fused_bwd, kernel K4) and
# the differentiable render_rays_fused.
# ---------------------------------------------------------------------------

def _setup_bwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_bwd_grad_layout.argtypes = [i, p]
    lib.nerf_bwd_grad_layout.restype = ctypes.c_int
    lib.nerf_render_bwd_scratch.argtypes = [i, ctypes.c_longlong, i, i, p]
    lib.nerf_render_bwd_scratch.restype = ctypes.c_int
    lib.nerf_render_bwd.argtypes = [p] * 18 + [i] * 10 + [p]
    lib.nerf_render_bwd.restype = ctypes.c_int
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


RENDER_BWD = CudaLibrary("render_bwd.cu", _setup_bwd)


def _setup_bwd_frozen(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_render_bwd_frozen.argtypes = [p] * 13 + [i] * 7 + [p]
    lib.nerf_render_bwd_frozen.restype = ctypes.c_int
    lib.nerf_render_bwd_frozen_spill.argtypes = [i, i, i]
    lib.nerf_render_bwd_frozen_spill.restype = ctypes.c_longlong
    lib.nerf_render_bwd_frozen_scratch.argtypes = [i, i, i]
    lib.nerf_render_bwd_frozen_scratch.restype = ctypes.c_longlong
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


# K4's frozen-network variant (d(rays), dz only) on the wgmma dX chain. Its
# `launches` counts those launches; each also counts in RENDER_BWD.launches,
# which counts every launch of K4, either variant.
RENDER_BWD_FROZEN = CudaLibrary("render_bwd_frozen.cu", _setup_bwd_frozen)


def _check_bwd_inputs(rays, z, g_rgb, g_dist, g_w, g_a) -> None:
    _check_inputs(rays, z)
    n, S = z.shape
    if n == 0:
        raise ValueError("the render backward needs at least one ray")
    if tuple(g_rgb.shape) != (n, 3) or tuple(g_dist.shape) != (n,):
        raise ValueError(f"g_rgb must be ({n}, 3) and g_dist ({n},), got "
                         f"{tuple(g_rgb.shape)} and {tuple(g_dist.shape)}")
    for name, g in (("g_w", g_w), ("g_a", g_a)):
        if g is not None and tuple(g.shape) != (n, S):
            raise ValueError(f"{name} must be ({n}, {S}) or None, got {tuple(g.shape)}")


def _bwd_plain(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg: NerfConfig, dist_alpha: bool,
               dtype: torch.dtype = torch.float32):
    """(dWs, dBs, drays, dz) by the plain version, in blocks of rays summed in
    order: two runs give the same bits. `dtype` float64 sums every product,
    scan and reduction in f64 (same bf16 operands, same rounding points)."""
    W, B = pack_weights(params, cfg)
    Wf = [w.to(dtype) for w in W]
    rays, z = (t.detach().to(torch.float32) for t in (rays, z))
    g_rgb, g_dist = (t.detach().to(dtype) for t in (g_rgb, g_dist))
    g_w, g_a = (None if g is None else g.detach().to(dtype) for g in (g_w, g_a))
    parts = []
    for i in range(0, rays.shape[0], PLAIN_TRAIN_BLOCK_RAYS):
        sl = slice(i, i + PLAIN_TRAIN_BLOCK_RAYS)
        fwd = _plain_forward(Wf, B, rays[sl], z[sl], cfg, dist_alpha, dtype)
        # a white background is applied outside this function, so its gradient
        # arrives through g_w (pallas_render.py:592-593)
        parts.append(_plain_backward_tail(
            Wf, rays[sl].to(dtype), z[sl].to(dtype), fwd, cfg, dist_alpha, g_rgb[sl], g_dist[sl],
            None if g_w is None else g_w[sl], None if g_a is None else g_a[sl], False))
    dW, dB = _sum_blocks([part[0] for part in parts]), _sum_blocks([part[1] for part in parts])
    drays, dz = (torch.cat([part[k] for part in parts], dim=0) for k in (2, 3))
    return dW, dB, drays, dz


def render_rays_fused_bwd_plain(params, rays: torch.Tensor, z: torch.Tensor,
                                g_rgb: torch.Tensor, g_dist: torch.Tensor,
                                g_w: Optional[torch.Tensor], g_a: Optional[torch.Tensor],
                                cfg: NerfConfig, dist_alpha: bool = False,
                                dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of the render-backward kernel, on any device: the
    VJP of render_rays_fused at cotangents g_rgb (N,3), g_dist (N,), g_w and
    g_a (N,S) or None (zero). It recomputes the forward and returns
    (dWs [14] stored (in, out), dBs [12], drays (N,9), dz (N,S)); unpack_grads
    turns the first two into the nerf params' layout. `dtype` float64 gives
    the same function summed in f64 (same bf16 operands and rounding points,
    gradients returned as f64): the yardstick for how far the order of f32
    additions moves the kernel and the f32 plain version."""
    _check_bwd_inputs(rays, z, g_rgb, g_dist, g_w, g_a)
    with torch.no_grad():
        return _bwd_plain(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg, dist_alpha, dtype)


def render_dw_operands(params, rays: torch.Tensor, z: torch.Tensor, g_rgb: torch.Tensor,
                       g_dist: torch.Tensor, g_w: Optional[torch.Tensor],
                       g_a: Optional[torch.Tensor], cfg: NerfConfig, dist_alpha: bool = False,
                       white_bg: bool = False):
    """The operands of K1's and K4 full's weight gradients as the plain
    backward forms them, for one block of at most PLAIN_TRAIN_BLOCK_RAYS rays
    at the cotangents of render_rays_fused_bwd_plain (with white_bg, K1's:
    the background's term folded into g_w as the train kernel does). Returns
    (X, G, chain): X and G dicts of bf16-valued f32 (n S, width) tensors
    named as in fused_mlp.render_dw_table (X: pe, x0..x7, feat; G: g_h,
    g_feat, g7..g0), rows in the kernels' row-tile order (sample s of ray r
    at r S + s); chain holds the factors of the blocks the kernels keep in
    their chain: x7, g_sig (dW[9] = x7^T g_sig), h, g_rgb (the raw rgb's
    cotangent, dW[13] = h^T g_rgb), de (n, 32) and ghsum (n, D/2), the sum
    of each ray's bf16 g_h (dW[12] = de^T ghsum)."""
    _check_bwd_inputs(rays, z, g_rgb, g_dist, g_w, g_a)
    n, S = z.shape
    if n > PLAIN_TRAIN_BLOCK_RAYS:
        raise ValueError(f"at most {PLAIN_TRAIN_BLOCK_RAYS} rays, got {n}")
    with torch.no_grad():
        W, B = pack_weights(params, cfg)
        Wf = [w.to(torch.float32) for w in W]
        rays, z, g_rgb, g_dist = (t.detach().to(torch.float32) for t in (rays, z, g_rgb, g_dist))
        g_w, g_a = (None if g is None else g.detach().to(torch.float32) for g in (g_w, g_a))
        fwd = _plain_forward(Wf, B, rays, z, cfg, dist_alpha)
        taps: Dict[str, torch.Tensor] = {}
        _plain_backward_tail(Wf, rays, z, fwd, cfg, dist_alpha, g_rgb, g_dist, g_w, g_a,
                             white_bg, taps)
        acts = fwd["acts"]
        X = {"pe": fwd["pe"], "feat": acts[8]}
        X.update({f"x{i}": acts[i] for i in range(8)})
        G = {k: v for k, v in taps.items() if k not in ("g_sig", "g_rgb")}
        H = cfg.hidden_dim // 2
        chain = {"x7": acts[7], "g_sig": taps["g_sig"], "h": acts[9], "g_rgb": taps["g_rgb"],
                 "de": fwd["de"], "ghsum": taps["g_h"].reshape(n, S, H).sum(dim=1)}
        return X, G, chain


def _render_bwd_cuda(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg: NerfConfig,
                     dist_alpha: bool, want_param_grads: bool = True,
                     operands: Optional[list] = None):
    """(dWs, dBs, drays, dz) by one launch of the render-backward kernel (its
    C entry issues, for each chunk of rays (render_chunks), the chain, the
    in-order sum of its partials and the dW kernel). With
    want_param_grads=False its frozen-network variant runs
    (render_bwd_frozen.cu): no dW/dB, and dWs, dBs are None. A list given as
    `operands` gets the full variant's X operands (_full_operands)."""
    n, S = z.shape
    D = cfg.hidden_dim
    _check_kernel_shapes(render_bwd_kernel(want_param_grads), S, D)
    dev = rays.device
    rays, z, g_rgb, g_dist = (t.detach() for t in (rays, z, g_rgb, g_dist))
    g_w, g_a = (None if g is None else g.detach() for g in (g_w, g_a))
    named = [("rays", rays), ("z", z), ("g_rgb", g_rgb), ("g_dist", g_dist)]
    named += [(name, g) for name, g in (("g_w", g_w), ("g_a", g_a)) if g is not None]
    _check_backward_tensors(named, dev)
    if not want_param_grads:
        drays, dz = _render_bwd_frozen_cuda(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg,
                                            dist_alpha)
        return None, None, drays, dz
    tiles, tiles_dx, _B, bptrs = _packed_tiles_on(params, cfg, dev)
    lib = RENDER_BWD.lib()
    offsets = (ctypes.c_int * 26)()
    total = lib.nerf_bwd_grad_layout(D, offsets)
    if total <= 0:
        raise RuntimeError("the render-backward kernel reports no gradient layout")
    chunk_rays, n_ctas, chunks, scratch = _full_scratch(lib.nerf_render_bwd_scratch, D, n, S,
                                                        dev)
    _full_operands(operands, scratch, chunk_rays, n)
    f32 = dict(dtype=torch.float32, device=dev)
    grads = torch.empty((total,), **f32)
    drays = torch.empty((n, RAY_DIM), **f32)
    dz = torch.empty((n, S), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_render_bwd(
            rays.data_ptr(), z.data_ptr(), g_rgb.data_ptr(), g_dist.data_ptr(), _ptr(g_w),
            _ptr(g_a), tiles.data_ptr(), tiles_dx.data_ptr(), bptrs,
            *[_ptr(t) for t in scratch], grads.data_ptr(), drays.data_ptr(), dz.data_ptr(),
            n, chunk_rays, S, D, n_ctas, chunks, int(cfg.occ_activation == "softplus"),
            int(cfg.dist_alpha), int(dist_alpha), total, stream)
    if err != 0:
        raise RuntimeError("render-backward kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    _count_full_launches(RENDER_BWD, n, chunk_rays)
    dWs, dBs = _grad_blocks(grads, offsets, D)
    return dWs, dBs, drays, dz


def _packed_tiles_on(params, cfg: NerfConfig, dev: torch.device):
    """pack_tiles_dx's (tiles, tiles_dx, biases), checked to lie on `dev`,
    and the 12 bias pointers."""
    with torch.no_grad():
        tiles, tiles_dx, B = pack_tiles_dx(params, cfg)
    for t in [tiles, tiles_dx] + B:
        if t.device != dev:
            raise ValueError("params must be on the inputs' device")
    return tiles, tiles_dx, B, (ctypes.c_void_p * 12)(*[b.data_ptr() for b in B])


def _render_bwd_frozen_cuda(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg: NerfConfig,
                            dist_alpha: bool):
    """(drays, dz) by one launch of K4's frozen-network variant: no operands,
    no partial sums; a per-CTA scratch holds the chain's g4 (one tile x D
    bf16) and, at 384 and 512, the ReLU masks of a ray's S/64 tiles (the
    kernel's entry gives its size), and another the per-sample arrays that do
    not fit in shared memory (S > 896 at D = 256, S > 128 at 512)."""
    n, S = z.shape
    D = cfg.hidden_dim
    dev = rays.device
    tiles, tiles_dx, _B, bptrs = _packed_tiles_on(params, cfg, dev)
    lib = RENDER_BWD_FROZEN.lib()
    n_ctas = _backward_ctas(n, dev)
    scratch = _scratch_bytes(lib.nerf_render_bwd_frozen_scratch(S, D, n_ctas), dev)
    spill = _spill(lib.nerf_render_bwd_frozen_spill(S, D, n_ctas), dev)
    drays = torch.empty((n, RAY_DIM), dtype=torch.float32, device=dev)
    dz = torch.empty((n, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_render_bwd_frozen(
            rays.data_ptr(), z.data_ptr(), g_rgb.data_ptr(), g_dist.data_ptr(), _ptr(g_w),
            _ptr(g_a), tiles.data_ptr(), tiles_dx.data_ptr(), bptrs, scratch.data_ptr(),
            _ptr(spill), drays.data_ptr(), dz.data_ptr(), n, S, D, n_ctas,
            int(cfg.occ_activation == "softplus"),
            int(cfg.dist_alpha), int(dist_alpha), stream)
    if err != 0:
        raise RuntimeError("render-backward kernel (frozen-network variant) launch failed: "
                           + lib.nerf_error_string(err).decode())
    RENDER_BWD.launches += 1
    RENDER_BWD_FROZEN.launches += 1
    return drays, dz


def _render_forward(params, rays, z, cfg: NerfConfig, dist_alpha: bool, want_aux: bool,
                    plain: bool):
    """The forward by its route: the plain version when `plain`, else the
    kernel. No autograd graph."""
    with torch.no_grad():
        if plain:
            return render_rays_fused_plain(params, rays, z, cfg, dist_alpha, want_aux)
        tiles, B = pack_tiles(params, cfg)
        return _render_cuda(tiles, B, rays.detach(), z.detach(), cfg, dist_alpha, want_aux)


class _RenderFused(torch.autograd.Function):
    """render_rays_fused with its hand-written backward: the forward stores
    only its inputs, the backward recomputes everything
    (pallas_render.py:845-911). Cotangents of outputs nobody used arrive as
    None and count as zero."""

    @staticmethod
    def forward(ctx, rays, z, cfg, dist_alpha, want_aux, names, *tensors):
        params = dict(zip(names, tensors))
        plain = runs_plain(rays)      # read here: the backward takes the forward's route
        if not plain:
            # what the backward kernel cannot take raises now, not after the forward: the
            # variant the backward will run, full when a nerf parameter wants a gradient
            _check_kernel_shapes(render_bwd_kernel(any(ctx.needs_input_grad[6:])), z.shape[1],
                                 cfg.hidden_dim)
        out = _render_forward(params, rays, z, cfg, dist_alpha, want_aux, plain)
        ctx.save_for_backward(rays, z, *tensors)
        ctx.static = (cfg, dist_alpha, plain, names)
        ctx.set_materialize_grads(False)
        return out if want_aux else out[:2]

    @staticmethod
    def backward(ctx, g_rgb, g_dist, g_w=None, g_a=None):
        rays, z, *tensors = ctx.saved_tensors
        cfg, dist_alpha, plain, names = ctx.static
        params = dict(zip(names, tensors))
        n = rays.shape[0]
        if g_rgb is None:
            g_rgb = torch.zeros((n, 3), dtype=torch.float32, device=rays.device)
        if g_dist is None:
            g_dist = torch.zeros((n,), dtype=torch.float32, device=rays.device)
        g_rgb, g_dist = g_rgb.to(torch.float32).contiguous(), g_dist.to(torch.float32).contiguous()
        g_w, g_a = (None if g is None else g.to(torch.float32).contiguous() for g in (g_w, g_a))
        want_param_grads = any(ctx.needs_input_grad[6:])
        if plain:
            dWs, dBs, drays, dz = _bwd_plain(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg,
                                             dist_alpha)
        else:
            dWs, dBs, drays, dz = _render_bwd_cuda(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg,
                                                   dist_alpha, want_param_grads)
        if want_param_grads:
            grads = unpack_grads(dWs, dBs, cfg)
            param_grads = [grads[k].to(params[k].dtype) if need else None
                           for k, need in zip(names, ctx.needs_input_grad[6:])]
        else:
            param_grads = [None] * len(names)
        return (drays.to(rays.dtype), dz.to(z.dtype), None, None, None, None, *param_grads)


def render_rays_fused(params, rays: torch.Tensor, z: torch.Tensor, cfg: NerfConfig,
                      dist_alpha: bool = False, want_aux: bool = True):
    """(params, ray table (N,9), z (N,S)) -> (rgb (N,3), dist (N,),
    weights (N,S), alpha (N,S)); weights/alpha are None when not want_aux.

    `dist_alpha` is the RENDERER's flag (delta-scaled opacity); the MLP head's
    is cfg.dist_alpha. A CUDA tensor goes through the hand-written kernels
    (render_fwd forward, render_bwd backward) or raises; a CPU tensor, and any
    tensor inside `plain_versions()`, through render_rays_fused_plain and
    render_rays_fused_bwd_plain, the same arithmetic. Gradients flow to the nerf params, the ray table and z; under
    torch.no_grad(), or when nothing requires a gradient, no graph is built.
    When no nerf parameter requires a gradient the backward skips the dW/dB
    products."""
    _check_inputs(rays, z)
    if rays.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no render kernel for device {rays.device}")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (rays, z, *params.values()))):
        return _render_forward(params, rays, z, cfg, dist_alpha, want_aux, runs_plain(rays))
    if rays.shape[0] == 0:
        raise ValueError("the differentiable render needs at least one ray")
    names = tuple(sorted(params))
    out = _RenderFused.apply(rays, z, cfg, bool(dist_alpha), bool(want_aux), names,
                             *[params[k] for k in names])
    return out if want_aux else (out[0], out[1], None, None)
