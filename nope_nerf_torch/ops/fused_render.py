"""Fused ray render: rays + z -> encode -> MLP -> heads -> composite, one kernel.

Port of nope_nerf_tpu/ops/pallas_render.py's forward (`_render_fwd_kernel`,
K3), of its backward (`_render_bwd_kernel`, K4: the VJP of render_rays_fused),
of its train-step program (`_render_train_kernel`, K1: render, rgb and
depth losses and every gradient in one launch) and of pallas_mlp.py's
`pack_weights` / `_unpack_grads`. On a CUDA tensor `render_rays_fused` and
`render_ray_loss_fused` launch the hand-written Hopper kernels in
`nope_nerf_torch/csrc/render_fwd.cu`, `csrc/render_bwd.cu` and
`csrc/render_train.cu`, or raise; on a CPU tensor they run
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
MAX_SAMPLES = 1024      # the kernel's shared-memory limit on S
PLAIN_BLOCK_RAYS = 2048  # rays per block of the plain version (bounds its memory)

Packed = Tuple[List[torch.Tensor], List[torch.Tensor]]


def _setup(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_render_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.nerf_render_fwd.restype = ctypes.c_int
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


def pack_weights_both(params: Dict[str, torch.Tensor], cfg: NerfConfig):
    """(weights (out, in), weights (in, out), biases): the train kernel also
    takes each bf16 weight as the params dict stores it, the operand of the
    backward's dX = g W^T products."""
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


def _render_cuda(W, B, rays, z, cfg: NerfConfig, dist_alpha: bool, want_aux: bool):
    n, S = z.shape
    D = cfg.hidden_dim
    if S % PTS_PER_PASS or S > MAX_SAMPLES:
        raise NotImplementedError(
            f"the CUDA render kernel takes S % {PTS_PER_PASS} == 0 and S <= "
            f"{MAX_SAMPLES}, got S={S}")
    if D not in (128, 256):
        raise NotImplementedError(f"the CUDA render kernel is built for hidden_dim 128 "
                                  f"and 256, got {D}")
    for name, t in (("rays", rays), ("z", z)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != rays.device:
            raise ValueError("rays and z must be on the same device")
    for t in W + B:
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
    wptrs = (ctypes.c_void_p * 14)(*[w.data_ptr() for w in W])
    bptrs = (ctypes.c_void_p * 12)(*[b.data_ptr() for b in B])
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = lib.nerf_render_fwd(
            rays.data_ptr(), z.data_ptr(), wptrs, bptrs, rgb.data_ptr(), dist.data_ptr(),
            weights.data_ptr() if want_aux else None,
            alpha.data_ptr() if want_aux else None,
            n, S, D, int(cfg.occ_activation == "softplus"), int(cfg.dist_alpha),
            int(dist_alpha), stream)
    if err != 0:
        raise RuntimeError("render kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    RENDER_FWD.launches += 1
    return rgb, dist, weights, alpha


# ---------------------------------------------------------------------------
# Train-fused path: one launch per step = loss values + every gradient
# (pallas_render.py::render_ray_loss_fused, kernel K1).
# ---------------------------------------------------------------------------

TGT_DIM = 7             # target table columns: rgb_gt (0-2), then
TGT_DEPTH = 3           # depth_gt, in the same (dist) space as the kernel's dist
TGT_MASK = 4            # depth-loss validity mask, 0.0/1.0
TGT_WRGB = 5            # annealed rgb_weight / n_total (same value every row)
TGT_WDEPTH = 6          # annealed depth_weight * (count>0) / max(count, 1)
TRAIN_MAX_SAMPLES = 256   # the train kernel's shared-memory limit on S
PLAIN_TRAIN_BLOCK_RAYS = 256
STASH_HALF_DIMS = 19      # the kernel's activation stash per point, in units of
                          # hidden_dim / 2: x0..x7 and feat (2 each), h (1)


def _setup_train(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_train_grad_layout.argtypes = [i, p]
    lib.nerf_train_grad_layout.restype = ctypes.c_int
    lib.nerf_render_train.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                                      i, i, i, i, i, i, i, i, i, i, p]
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


def mlp_backward(Wf, pe, de, acts, g_rgb, g_sig, n: int, S: int):
    """MLP backward (pallas_mlp.py:207-260) from the cotangents of the raw
    heads, g_rgb (T,3) and g_sig (T,), over T = n*S points whose direction
    encoding `de` (n,32) is shared by each group of S: dW = x^T . bf16(g)
    stored (in, out), dX = bf16(g) . W^T with Wf[i] = W^T (the (out, in)
    weights as f32). Returns (dWs [14], dBs [12], dpe (T,64), dde (n,32))."""
    r = bf16_round
    x0, x1, x2, x3, x4, x5, x6, x7, feat, h = acts
    dW: List[Optional[torch.Tensor]] = [None] * 14
    dB: List[Optional[torch.Tensor]] = [None] * 12
    H = h.shape[1]
    dW[13], dB[11] = h.t() @ r(g_rgb), g_rgb.sum(dim=0)
    g_h = (r(g_rgb) @ Wf[13][:3]) * (h > 0)
    rg_h = r(g_h)
    dW[11], dB[10] = feat.t() @ rg_h, g_h.sum(dim=0)
    dW[12] = de.t() @ rg_h.reshape(n, S, H).sum(dim=1)      # rounded per point, then summed
    dde = (rg_h @ Wf[12]).reshape(n, S, DE_DIM).sum(dim=1)  # (n, 32)
    g_feat = rg_h @ Wf[11]
    dW[10], dB[9] = x7.t() @ r(g_feat), g_feat.sum(dim=0)
    dW[9], dB[8] = x7.t() @ r(g_sig)[:, None], g_sig.sum().reshape(1)
    g = (r(g_feat) @ Wf[10] + r(g_sig)[:, None] * Wf[9][0][None, :]) * (x7 > 0)
    for wi, bi, x_in in ((8, 7, x6), (7, 6, x5), (6, 5, x4)):
        dW[wi], dB[bi] = x_in.t() @ r(g), g.sum(dim=0)
        g = (r(g) @ Wf[wi]) * (x_in > 0)
    g4 = g
    for wi, bi, x_in in ((4, 4, x3), (3, 3, x2), (2, 2, x1), (1, 1, x0)):
        dW[wi], dB[bi] = x_in.t() @ r(g), g.sum(dim=0)
        g = (r(g) @ Wf[wi]) * (x_in > 0)
    g0 = g
    dB[0] = g0.sum(dim=0)
    dW[0], dW[5] = pe.t() @ r(g0), pe.t() @ r(g4)
    dpe = r(g0) @ Wf[0] + r(g4) @ Wf[5]                      # (T, 64)
    return dW, dB, dpe, dde


def _plain_backward_tail(Wf, rays, z, fwd: Dict[str, object], cfg: NerfConfig, dist_alpha: bool,
                         g_rgb_ray, g_dist, g_w_in, g_a_in, white_bg: bool):
    """Composite -> heads -> MLP -> encoding backward of one block of rays
    (pallas_render.py::_backward_tail), step by step (not autograd: autograd
    would not round the cotangents to bf16 before each product). `fwd` is
    _plain_forward's; g_rgb_ray (n,3) and g_dist (n,) are the cotangents of
    the rays' rgb and dist, g_w_in / g_a_in (n,S) or None those of the
    per-sample weights and alpha; white_bg folds the gradient of the
    1 - sum(weights) term in. Returns (dWs [14] stored (in, out), dBs [12],
    drays (n,9), dz (n,S))."""
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
    dW, dB, dpe, dde = mlp_backward(Wf, pe, de, fwd["acts"], g_rgb, g_sig, n, S)

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


def _check_backward_shapes(kernel: str, S: int, D: int) -> None:
    if S % PTS_PER_PASS or S > TRAIN_MAX_SAMPLES:
        raise NotImplementedError(
            f"the CUDA {kernel} kernel takes S % {PTS_PER_PASS} == 0 and S <= "
            f"{TRAIN_MAX_SAMPLES}, got S={S}")
    if D not in (128, 256):
        raise NotImplementedError(f"the CUDA {kernel} kernel is built for hidden_dim 128 "
                                  f"and 256, got {D}")


def _check_backward_tensors(named, dev: torch.device) -> None:
    for name, t in named:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != dev:
            raise ValueError(f"{name} must be on the rays' device")


def _pack_for_backward(params, cfg: NerfConfig, dev: torch.device):
    """ctypes pointer arrays of both weight layouts and the biases (and the
    tensors, which must outlive the launch)."""
    with torch.no_grad():
        W, Wt, B = pack_weights_both(params, cfg)
    for t in W + Wt + B:
        if t.device != dev:
            raise ValueError("params must be on the rays' device")
    return ((ctypes.c_void_p * 14)(*[w.data_ptr() for w in W]),
            (ctypes.c_void_p * 14)(*[w.data_ptr() for w in Wt]),
            (ctypes.c_void_p * 12)(*[b.data_ptr() for b in B]), (W, Wt, B))


def _backward_ctas(n: int, dev: torch.device) -> int:
    """One persistent CTA per SM, each with its own stash and partial sums."""
    return min(n, torch.cuda.get_device_properties(dev).multi_processor_count)


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
                white_bg: bool):
    """(sums, dWs, dBs, drays, dz, dtgt) by one launch of the train kernel."""
    n, S = z.shape
    D = cfg.hidden_dim
    _check_backward_shapes("train", S, D)
    dev = rays.device
    rays, z, tgt = (t.detach() for t in (rays, z, tgt))
    _check_backward_tensors((("rays", rays), ("z", z), ("tgt", tgt)), dev)
    wptrs, wtptrs, bptrs, _keep = _pack_for_backward(params, cfg, dev)
    lib = RENDER_TRAIN.lib()
    offsets = (ctypes.c_int * 27)()
    total = lib.nerf_train_grad_layout(D, offsets)
    if total <= 0:
        raise RuntimeError("the train kernel reports no gradient layout")
    n_ctas = _backward_ctas(n, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    stash = torch.empty((n_ctas, S, STASH_HALF_DIMS * D // 2), dtype=torch.bfloat16, device=dev)
    partials = torch.empty((n_ctas, total), **f32)
    grads = torch.empty((total,), **f32)
    drays = torch.empty((n, RAY_DIM), **f32)
    dz = torch.empty((n, S), **f32)
    dtgt = torch.empty((n, TGT_DIM), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_render_train(
            rays.data_ptr(), z.data_ptr(), tgt.data_ptr(), wptrs, wtptrs, bptrs,
            stash.data_ptr(), partials.data_ptr(), grads.data_ptr(), drays.data_ptr(),
            dz.data_ptr(), dtgt.data_ptr(), n, S, D, n_ctas,
            int(cfg.occ_activation == "softplus"), int(cfg.dist_alpha), int(dist_alpha),
            int(rgb_p), int(white_bg), total, stream)
    if err != 0:
        raise RuntimeError("train kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    RENDER_TRAIN.launches += 1
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
    lib.nerf_render_bwd.argtypes = [p] * 14 + [i] * 8 + [p]
    lib.nerf_render_bwd.restype = ctypes.c_int
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


RENDER_BWD = CudaLibrary("render_bwd.cu", _setup_bwd)


class _FrozenVariantCount:
    """Of RENDER_BWD.launches, those of the frozen-network variant (no dW/dB)."""
    launches = 0


RENDER_BWD_FROZEN = _FrozenVariantCount()


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


def _render_bwd_cuda(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg: NerfConfig,
                     dist_alpha: bool, want_param_grads: bool = True):
    """(dWs, dBs, drays, dz) by one launch of the render-backward kernel. With
    want_param_grads=False the kernel's frozen-network variant runs: it skips
    the dW/dB products and their buffers, and dWs, dBs are None."""
    n, S = z.shape
    D = cfg.hidden_dim
    _check_backward_shapes("render-backward", S, D)
    dev = rays.device
    rays, z, g_rgb, g_dist = (t.detach() for t in (rays, z, g_rgb, g_dist))
    g_w, g_a = (None if g is None else g.detach() for g in (g_w, g_a))
    named = [("rays", rays), ("z", z), ("g_rgb", g_rgb), ("g_dist", g_dist)]
    named += [(name, g) for name, g in (("g_w", g_w), ("g_a", g_a)) if g is not None]
    _check_backward_tensors(named, dev)
    wptrs, wtptrs, bptrs, _keep = _pack_for_backward(params, cfg, dev)
    lib = RENDER_BWD.lib()
    offsets = (ctypes.c_int * 26)()
    total = lib.nerf_bwd_grad_layout(D, offsets)
    if total <= 0:
        raise RuntimeError("the render-backward kernel reports no gradient layout")
    n_ctas = _backward_ctas(n, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    stash = torch.empty((n_ctas, S, STASH_HALF_DIMS * D // 2), dtype=torch.bfloat16, device=dev)
    partials = grads = None
    if want_param_grads:
        partials = torch.empty((n_ctas, total), **f32)
        grads = torch.empty((total,), **f32)
    drays = torch.empty((n, RAY_DIM), **f32)
    dz = torch.empty((n, S), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_render_bwd(
            rays.data_ptr(), z.data_ptr(), g_rgb.data_ptr(), g_dist.data_ptr(), ptr(g_w),
            ptr(g_a), wptrs, wtptrs, bptrs, stash.data_ptr(), ptr(partials), ptr(grads),
            drays.data_ptr(), dz.data_ptr(), n, S, D, n_ctas,
            int(cfg.occ_activation == "softplus"), int(cfg.dist_alpha), int(dist_alpha),
            total, stream)
    if err != 0:
        raise RuntimeError("render-backward kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    RENDER_BWD.launches += 1
    if not want_param_grads:
        RENDER_BWD_FROZEN.launches += 1
        return None, None, drays, dz
    dWs, dBs = _grad_blocks(grads, offsets, D)
    return dWs, dBs, drays, dz


def _render_forward(params, rays, z, cfg: NerfConfig, dist_alpha: bool, want_aux: bool,
                    plain: bool):
    """The forward by its route: the plain version when `plain`, else the
    kernel. No autograd graph."""
    with torch.no_grad():
        if plain:
            return render_rays_fused_plain(params, rays, z, cfg, dist_alpha, want_aux)
        W, B = pack_weights(params, cfg)
        return _render_cuda(W, B, rays.detach(), z.detach(), cfg, dist_alpha, want_aux)


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
            # the backward kernel's limits are tighter than the forward's: say so now
            _check_backward_shapes("render-backward", z.shape[1], cfg.hidden_dim)
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
