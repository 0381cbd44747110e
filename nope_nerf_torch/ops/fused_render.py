"""Fused ray render: rays + z -> encode -> MLP -> heads -> composite, one kernel.

Port of nope_nerf_tpu/ops/pallas_render.py's forward (`_render_fwd_kernel`,
K3) and of pallas_mlp.py's `pack_weights`. On a CUDA tensor
`render_rays_fused` launches the hand-written Hopper kernel in
`nope_nerf_torch/csrc/render_fwd.cu`, or raises; on a CPU tensor it runs
`render_rays_fused_plain`, the same arithmetic in plain PyTorch:
- bf16 matmul operands (whatever `compute_dtype` says, as the TPU kernel)
  with f32 accumulation; activations rounded to bf16 after each ReLU, `feat`
  rounded without one; heads f32;
- the f32 composite as exp of an exclusive Hillis-Steele prefix sum of
  log(1 - alpha + 1e-6), in the TPU kernel's order of additions.

The ray table is (N, 9) [origin | ray_vec | mlp_dir]: the TPU's 128-lane
padding is a layout of that machine and is not carried over.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.nerf import NerfConfig, bf16_round, softplus
from ._build import CudaLibrary

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


def encode_lanes(x: torch.Tensor, levels: int, out_dim: int) -> torch.Tensor:
    """Dense-lane frequency encoding (M, 3) -> (M, out_dim) f32:
    [x | sin(2^i x_c) at 3+3i+c | cos(2^i x_c) at 3+3L+3i+c | 0]."""
    scale = torch.tensor([2.0 ** i for i in range(levels)], dtype=x.dtype, device=x.device)
    args = (x[:, None, :] * scale[None, :, None]).reshape(x.shape[0], 3 * levels)
    pad = x.new_zeros((x.shape[0], out_dim - 3 - 6 * levels))
    return torch.cat([x, torch.sin(args), torch.cos(args), pad], dim=1)


def pack_weights(params: Dict[str, torch.Tensor], cfg: NerfConfig) -> Packed:
    """nerf params -> (14 bf16 weights, 12 f32 biases) in the kernel's layout.

    The same blocks as the JAX package's pack_weights (pallas_mlp.py:95), each
    weight stored (out, in): encoding-facing rows permuted to the dense-lane
    order and zero-padded, the skip and rgb-hidden layers split into their
    x and encoding parts, the heads padded to HEAD_DIM outputs."""
    D = cfg.hidden_dim
    if D % 128 or cfg.pos_enc_levels != 10 or cfg.dir_enc_levels != 4:
        raise ValueError("the fused render needs hidden_dim % 128 == 0 and the "
                         "reference 10/4 encoding levels")
    dev = params["trunk0_0_w"].device

    def perm_rows(w, levels, rows):
        w = w[torch.as_tensor(_enc_perm(levels), device=dev)]
        return torch.nn.functional.pad(w, (0, 0, 0, rows - w.shape[0]))

    def pad_cols(w, cols):
        return torch.nn.functional.pad(w, (0, cols - w.shape[1]))

    w4 = params["trunk1_0_w"]
    wr = params["rgb_hidden_w"]
    weights_in_out = [
        perm_rows(params["trunk0_0_w"], 10, PE_DIM),
        params["trunk0_1_w"], params["trunk0_2_w"], params["trunk0_3_w"],
        w4[:D], perm_rows(w4[D:], 10, PE_DIM),
        params["trunk1_1_w"], params["trunk1_2_w"], params["trunk1_3_w"],
        pad_cols(params["density_w"], HEAD_DIM),
        params["feature_w"],
        wr[:D], perm_rows(wr[D:], 4, DE_DIM),
        pad_cols(params["rgb_w"], HEAD_DIM),
    ]
    weights = [w.t().contiguous().to(torch.bfloat16) for w in weights_in_out]

    def pad_b(b, n):
        return torch.nn.functional.pad(b, (0, n - b.shape[0]))

    biases = [params[f"trunk0_{i}_b"] for i in range(4)]
    biases += [params[f"trunk1_{i}_b"] for i in range(4)]
    biases += [pad_b(params["density_b"], HEAD_DIM), params["feature_b"],
               params["rgb_hidden_b"], pad_b(params["rgb_b"], HEAD_DIM)]
    biases = [b.to(torch.float32).contiguous() for b in biases]
    return weights, biases


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


def _plain_block(W, B, rays, z, cfg: NerfConfig, dist_alpha: bool):
    n, S = z.shape
    o, v, d = rays[:, 0:3], rays[:, 3:6], rays[:, 6:9]
    pts = (o[:, None, :] + v[:, None, :] * z[..., None]).reshape(-1, 3)
    pe = bf16_round(encode_lanes(pts, 10, PE_DIM))
    de = bf16_round(encode_lanes(d, 4, DE_DIM))
    Wf = [w.to(torch.float32) for w in W]   # bf16 -> f32 is exact

    def dot(x, i):
        return x @ Wf[i].t()

    x = bf16_round(torch.relu(dot(pe, 0) + B[0]))
    for i in (1, 2, 3):
        x = bf16_round(torch.relu(dot(x, i) + B[i]))
    x = bf16_round(torch.relu(dot(x, 4) + dot(pe, 5) + B[4]))
    for i in (6, 7, 8):
        x = bf16_round(torch.relu(dot(x, i) + B[i - 1]))
    sig_raw = dot(x, 9)[:, 0] + B[8][0]
    feat = bf16_round(dot(x, 10) + B[9])
    de_h = dot(de, 12)                                   # per ray
    H = de_h.shape[1]
    hid = (dot(feat, 11).reshape(n, S, H) + de_h[:, None, :]).reshape(n * S, H)
    h = bf16_round(torch.relu(hid + B[10]))
    rgb = torch.sigmoid(dot(h, 13)[:, :3] + B[11][:3]).reshape(n, S, 3)
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


def render_rays_fused(params, rays: torch.Tensor, z: torch.Tensor, cfg: NerfConfig,
                      dist_alpha: bool = False, want_aux: bool = True):
    """(params, ray table (N,9), z (N,S)) -> (rgb (N,3), dist (N,),
    weights (N,S), alpha (N,S)); weights/alpha are None when not want_aux.

    `dist_alpha` is the RENDERER's flag (delta-scaled opacity); the MLP head's
    is cfg.dist_alpha. A CUDA tensor goes through the hand-written kernel
    (forward only: no autograd graph is built); a CPU tensor through
    render_rays_fused_plain."""
    _check_inputs(rays, z)
    if rays.device.type == "cpu":
        return render_rays_fused_plain(params, rays, z, cfg, dist_alpha, want_aux)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no render kernel for device {rays.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (rays, z, *params.values())):
        raise NotImplementedError("gradients through the CUDA render kernel come with the "
                                  "port of its backward kernel (K4)")
    W, B = pack_weights(params, cfg)
    with torch.no_grad():
        return _render_cuda(W, B, rays, z, cfg, dist_alpha, want_aux)
