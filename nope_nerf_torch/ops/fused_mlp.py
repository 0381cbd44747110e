"""Point-query NeRF MLP: points + directions -> encode -> MLP -> heads, one kernel.

Port of nope_nerf_tpu/ops/pallas_mlp.py's `nerf_apply_fused` and its custom
VJP: the forward kernel `_fwd_kernel` (K5) and the backward kernel
`_bwd_kernel` (K6), with the head VJP and the encoding VJP that the JAX
package runs around them. `point_mlp` is the MLP query of the unfused render
(ops/render.py: the coarse and fine passes of hierarchical sampling, and any
sample count the fused render does not take).

On a CUDA tensor `point_mlp` launches the hand-written Hopper kernels in
`nope_nerf_torch/csrc/point_mlp_fwd.cu` and `csrc/point_mlp_bwd.cu`, or
raises; on a CPU tensor, and on any tensor inside `with plain_versions():`,
it runs `point_mlp_fwd_plain` and `point_mlp_bwd_plain`, the same arithmetic
in plain PyTorch:
- the f32 dense-lane encodings (fused_render.encode_lanes) rounded to bf16;
- bf16 matmul operands with f32 accumulation, whatever `compute_dtype` says
  (pallas_mlp.py:395-399), activations rounded to bf16 after each ReLU,
  `feat` rounded without one, heads f32;
- in the backward, every cotangent rounded to bf16 before it enters a
  product, ReLU masks from the bf16 activations, bias gradients summed from
  the f32 cotangents (fused_render.mlp_backward), and the encodings'
  cotangents pulled to the points and directions with the forward's f32
  sin/cos.
The packed weights are fused_render.pack_weights'; the TPU's (M, 64) / (M, 32)
encodings and (M, 128) padded outputs are layouts of that machine and are not
carried over: the kernels take (M, 3) and write (M, 3) and (M, 1).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..models.nerf import NerfConfig, _occupancy, bf16_round, softplus
from ._build import CudaLibrary, runs_plain
from .fused_render import (DE_DIM, PE_DIM, STASH_HALF_DIMS, _backward_ctas, _enc_deriv_to_coords,
                           _grad_blocks, _mlp_forward, _pack_for_backward, encode_lanes,
                           mlp_backward, pack_weights, unpack_grads)

PTS_PER_PASS = 128        # the kernels' pass over consecutive points
PLAIN_BLOCK_POINTS = 65536  # points per block of the plain versions (bounds their memory)


def _setup_fwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_point_mlp_fwd.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, p]
    lib.nerf_point_mlp_fwd.restype = ctypes.c_int
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


def _setup_bwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.nerf_point_mlp_grad_layout.argtypes = [i, p]
    lib.nerf_point_mlp_grad_layout.restype = ctypes.c_int
    lib.nerf_point_mlp_bwd.argtypes = [p] * 12 + [ctypes.c_longlong] + [i] * 5 + [p]
    lib.nerf_point_mlp_bwd.restype = ctypes.c_int
    lib.nerf_error_string.argtypes = [ctypes.c_int]
    lib.nerf_error_string.restype = ctypes.c_char_p


POINT_MLP_FWD = CudaLibrary("point_mlp_fwd.cu", _setup_fwd)
POINT_MLP_BWD = CudaLibrary("point_mlp_bwd.cu", _setup_bwd)


def _check_inputs(pts: torch.Tensor, dirs: torch.Tensor) -> None:
    if pts.ndim != 2 or pts.shape[1] != 3 or tuple(dirs.shape) != tuple(pts.shape):
        raise ValueError(f"pts and dirs must both be (M, 3), got {tuple(pts.shape)} and "
                         f"{tuple(dirs.shape)}")


def _check_width(cfg: NerfConfig) -> None:
    if cfg.hidden_dim not in (128, 256) or cfg.pos_enc_levels != 10 or cfg.dir_enc_levels != 4:
        raise NotImplementedError(
            "the CUDA point-query MLP kernels are built for hidden_dim 128 and 256 with the "
            f"reference 10/4 encoding levels, got hidden_dim={cfg.hidden_dim}, levels "
            f"{cfg.pos_enc_levels}/{cfg.dir_enc_levels}")


def _heads(rgb_raw: torch.Tensor, sig_raw: torch.Tensor, cfg: NerfConfig):
    """(rgb (M,3), density (M,1)) from the raw heads (pallas_mlp.py:381)."""
    return torch.sigmoid(rgb_raw), _occupancy(sig_raw, cfg)[:, None]


def _plain_forward(Wf, B, pts, dirs):
    """(rgb_raw (T,3), sig_raw (T,), activations, pe, de) of one block."""
    pe = bf16_round(encode_lanes(pts, 10, PE_DIM))
    de = bf16_round(encode_lanes(dirs, 4, DE_DIM))
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


def point_mlp_bwd_plain(params: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
                        g_rgb: torch.Tensor, g_density: torch.Tensor, cfg: NerfConfig):
    """Plain PyTorch version of the backward kernel, on any device: the VJP of
    point_mlp at cotangents g_rgb (M,3) and g_density (M,1). It recomputes the
    forward and returns (dWs [14] stored (in, out), dBs [12], dpts (M,3),
    ddirs (M,3)); unpack_grads turns the first two into the nerf params'
    layout. Blocks of points are summed in order: two runs give the same bits."""
    _check_inputs(pts, dirs)
    with torch.no_grad():
        W, B = pack_weights(params, cfg)
        Wf = [w.to(torch.float32) for w in W]
        pts, dirs, g_rgb, g_density = (t.detach().to(torch.float32)
                                       for t in (pts, dirs, g_rgb, g_density))
        dW = dB = None
        dpts, ddirs = [], []
        for i in range(0, pts.shape[0], PLAIN_BLOCK_POINTS):
            sl = slice(i, i + PLAIN_BLOCK_POINTS)
            rgb_raw, sig_raw, acts, pe, de = _plain_forward(Wf, B, pts[sl], dirs[sl])
            g_rgb_raw, g_sig = _head_vjp(rgb_raw, sig_raw, g_rgb[sl], g_density[sl], cfg)
            m = pe.shape[0]
            dW_b, dB_b, dpe, dde = mlp_backward(Wf, pe, de, acts, g_rgb_raw, g_sig, m, 1)
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


def _mlp_fwd_cuda(params, pts: torch.Tensor, dirs: torch.Tensor, cfg: NerfConfig):
    """(rgb (M,3), density (M,1)) by one launch of the forward kernel."""
    _check_width(cfg)
    dev = pts.device
    _check_tensors((("pts", pts), ("dirs", dirs)), dev)
    W, B = pack_weights(params, cfg)
    for t in W + B:
        if t.device != dev:
            raise ValueError("params must be on the points' device")
    M = pts.shape[0]
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    density = torch.empty((M, 1), dtype=torch.float32, device=dev)
    if M == 0:
        return rgb, density
    lib = POINT_MLP_FWD.lib()
    wptrs = (ctypes.c_void_p * 14)(*[w.data_ptr() for w in W])
    bptrs = (ctypes.c_void_p * 12)(*[b.data_ptr() for b in B])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_point_mlp_fwd(pts.data_ptr(), dirs.data_ptr(), wptrs, bptrs,
                                     rgb.data_ptr(), density.data_ptr(), M, cfg.hidden_dim,
                                     int(cfg.occ_activation == "softplus"), int(cfg.dist_alpha),
                                     stream)
    if err != 0:
        raise RuntimeError("point-query MLP forward kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    POINT_MLP_FWD.launches += 1
    return rgb, density


def _mlp_bwd_cuda(params, pts, dirs, g_rgb, g_density, cfg: NerfConfig):
    """(dWs, dBs, dpts, ddirs) by one launch of the backward kernel (and its
    in-order sum of the CTAs' partial gradients)."""
    _check_width(cfg)
    D = cfg.hidden_dim
    dev = pts.device
    M = pts.shape[0]
    if M == 0:
        raise ValueError("the point-query MLP backward needs at least one point")
    _check_tensors((("pts", pts), ("dirs", dirs), ("g_rgb", g_rgb), ("g_density", g_density)),
                   dev)
    wptrs, wtptrs, bptrs, _keep = _pack_for_backward(params, cfg, dev)
    lib = POINT_MLP_BWD.lib()
    offsets = (ctypes.c_int * 26)()
    total = lib.nerf_point_mlp_grad_layout(D, offsets)
    if total <= 0:
        raise RuntimeError("the point-query MLP backward kernel reports no gradient layout")
    n_ctas = _backward_ctas(-(-M // PTS_PER_PASS), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    stash = torch.empty((n_ctas, PTS_PER_PASS * STASH_HALF_DIMS * D // 2), dtype=torch.bfloat16,
                        device=dev)
    partials = torch.empty((n_ctas, total), **f32)
    grads = torch.empty((total,), **f32)
    dpts = torch.empty((M, 3), **f32)
    ddirs = torch.empty((M, 3), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_point_mlp_bwd(
            pts.data_ptr(), dirs.data_ptr(), g_rgb.data_ptr(), g_density.data_ptr(), wptrs, wtptrs,
            bptrs, stash.data_ptr(), partials.data_ptr(), grads.data_ptr(), dpts.data_ptr(),
            ddirs.data_ptr(), M, D, n_ctas, int(cfg.occ_activation == "softplus"),
            int(cfg.dist_alpha), total, stream)
    if err != 0:
        raise RuntimeError("point-query MLP backward kernel launch failed: "
                           + lib.nerf_error_string(err).decode())
    POINT_MLP_BWD.launches += 1
    dWs, dBs = _grad_blocks(grads, offsets, D)
    return dWs, dBs, dpts, ddirs


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
        if plain:
            dWs, dBs, dpts, ddirs = point_mlp_bwd_plain(params, pts, dirs, g_rgb, g_density, cfg)
        else:
            dWs, dBs, dpts, ddirs = _mlp_bwd_cuda(params, pts, dirs, g_rgb, g_density, cfg)
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
    nothing requires a gradient, no graph is built."""
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
