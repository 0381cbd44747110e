"""The "official" NeRF MLP as plain functions over a params dict.

Port of nope_nerf_tpu/models/nerf.py: params are a flat dict of (in, out)
weight matrices with the JAX package's names, so a JAX state converts without
reshaping (see nope_nerf_torch/convert.py). `nerf_apply` is the plain path on
(M, 3) point batches; the fused render kernels (ops/fused_render.py) and the
point-query MLP kernels (ops/fused_mlp.py) compute the same network inside
CUDA kernels. `nerf_density` and `nerf_gradient` stay plain on every device,
as the JAX package runs them outside its kernels (occupancy grid, phong view,
normals).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from .. import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    hidden_dim: int = 256
    pos_enc_levels: int = 10
    dir_enc_levels: int = 4
    occ_activation: str = "softplus"  # 'softplus' | 'relu'
    dist_alpha: bool = False          # False => density -> 1-exp(-density) occupancy
    white_background: bool = False
    # 'bfloat16': bf16 matmul operands, f32 accumulation; 'float32': exact f32.
    compute_dtype: str = "bfloat16"
    # Use the hand-written render kernel (read from the same
    # `tpu.use_pallas_renderer` key as the JAX package's Pallas switch).
    # Requires hidden_dim % 128 == 0 and the reference 10/4 encoding levels.
    use_pallas: bool = False

    @property
    def pos_in_dims(self) -> int:
        return (2 * self.pos_enc_levels + 1) * 3

    @property
    def dir_in_dims(self) -> int:
        return (2 * self.dir_enc_levels + 1) * 3

    @classmethod
    def from_cfg(cls, cfg: dict) -> "NerfConfig":
        return cls(
            hidden_dim=cfg["model"]["hidden_dim"],
            pos_enc_levels=cfg["model"]["pos_enc_levels"],
            dir_enc_levels=cfg["model"]["dir_enc_levels"],
            occ_activation=cfg["model"]["occ_activation"],
            dist_alpha=cfg["rendering"]["dist_alpha"],
            white_background=cfg["rendering"]["white_background"],
            compute_dtype=cfg.get("tpu", {}).get("compute_dtype", "bfloat16"),
            use_pallas=bool(
                cfg.get("tpu", {}).get("use_pallas_renderer", False)
                and cfg["model"]["hidden_dim"] % 128 == 0
                and cfg["model"]["pos_enc_levels"] == 10
                and cfg["model"]["dir_enc_levels"] == 4),
        )


def encode_position(x: torch.Tensor, levels: int, inc_input: bool = True) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)] along
    the last axis (reference order, official_nerf.py:99-119)."""
    feats = [x] if inc_input else []
    for i in range(levels):
        scaled = (2.0 ** i) * x
        feats.append(torch.sin(scaled))
        feats.append(torch.cos(scaled))
    return torch.cat(feats, dim=-1)


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for W and b (torch.nn.Linear's law)."""
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty((fan_in, fan_out), dtype=dtype).uniform_(-bound, bound, generator=gen)
    b = torch.empty((fan_out,), dtype=dtype).uniform_(-bound, bound, generator=gen)
    return w, b


def init_nerf_params(cfg: NerfConfig, generator: torch.Generator,
                     device: DeviceLike = None,
                     dtype: torch.dtype = torch.float32) -> Params:
    """Seeded init with the JAX package's distributions and bias constants.
    The numbers differ from jax.random's; tests share params through
    convert.py instead."""
    dev = resolve_device(device)
    D = cfg.hidden_dim
    pos_in, dir_in = cfg.pos_in_dims, cfg.dir_in_dims
    params: Params = {}
    dims0 = [pos_in, D, D, D, D]
    for i in range(4):
        params[f"trunk0_{i}_w"], params[f"trunk0_{i}_b"] = _linear_init(
            generator, dims0[i], dims0[i + 1], dtype)
    dims1 = [D + pos_in, D, D, D, D]
    for i in range(4):
        params[f"trunk1_{i}_w"], params[f"trunk1_{i}_b"] = _linear_init(
            generator, dims1[i], dims1[i + 1], dtype)
    params["density_w"], _ = _linear_init(generator, D, 1, dtype)
    params["density_b"] = torch.full((1,), 0.1, dtype=dtype)        # official_nerf.py:39
    params["feature_w"], params["feature_b"] = _linear_init(generator, D, D, dtype)
    params["rgb_hidden_w"], params["rgb_hidden_b"] = _linear_init(
        generator, D + dir_in, D // 2, dtype)
    params["rgb_w"], _ = _linear_init(generator, D // 2, 3, dtype)
    rgb_bias = 0.8 if cfg.white_background else 0.02                 # official_nerf.py:41-44
    params["rgb_b"] = torch.full((3,), rgb_bias, dtype=dtype)
    return {k: v.to(dev) for k, v in params.items()}


def reset_linear_params(generator: torch.Generator, params: Params, cfg: NerfConfig) -> Params:
    """Re-initialize every linear layer on the params' device (the reference's
    scheduling_mode='reset' at decay start, train.py:347-350: torch's
    reset_parameters includes the head biases, so the custom density and rgb
    biases revert to uniform too)."""
    some = params["density_w"]
    fresh = init_nerf_params(cfg, generator, device=some.device, dtype=some.dtype)
    for name, fan_in in (("density_b", cfg.hidden_dim), ("rgb_b", cfg.hidden_dim // 2)):
        bound = 1.0 / math.sqrt(fan_in)
        fresh[name] = torch.empty(params[name].shape, dtype=some.dtype).uniform_(
            -bound, bound, generator=generator).to(some.device)
    return fresh


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 value (ties to even), kept in x's own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            cfg: NerfConfig) -> torch.Tensor:
    """x @ w + b; in bfloat16 mode the operands are rounded to bf16 and the
    products summed in f32 (bf16 x bf16 is exact in f32), as the JAX
    package's preferred_element_type=f32 dot does."""
    if cfg.compute_dtype == "bfloat16":
        return bf16_round(x) @ bf16_round(w) + b
    return x @ w + b


def _trunk(params: Params, pos_enc: torch.Tensor, cfg: NerfConfig) -> torch.Tensor:
    x = pos_enc
    for i in range(4):
        x = torch.relu(_matmul(x, params[f"trunk0_{i}_w"], params[f"trunk0_{i}_b"], cfg))
    x = torch.cat([x, pos_enc], dim=-1)  # skip concat, official_nerf.py:63
    for i in range(4):
        x = torch.relu(_matmul(x, params[f"trunk1_{i}_w"], params[f"trunk1_{i}_b"], cfg))
    return x


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus's formula: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _occupancy(raw: torch.Tensor, cfg: NerfConfig) -> torch.Tensor:
    density = softplus(raw) if cfg.occ_activation == "softplus" else torch.relu(raw)
    if not cfg.dist_alpha:
        density = 1.0 - torch.exp(-density)  # occupancy in [0,1), official_nerf.py:82-83
    return density


def nerf_density(params: Params, pts: torch.Tensor, cfg: NerfConfig) -> torch.Tensor:
    """Density/occupancy only (the reference's only_occupancy=True path)."""
    x = _trunk(params, encode_position(pts, cfg.pos_enc_levels), cfg)
    return _occupancy(_matmul(x, params["density_w"], params["density_b"], cfg), cfg)


def nerf_gradient(params: Params, pts: torch.Tensor, cfg: NerfConfig) -> torch.Tensor:
    """Negative spatial gradient of the raw (pre-activation) density head with
    respect to the points, (M, 3) (reference official_nerf.py:46-58, the
    surface normals). Under grad mode, when the params or the points require
    a gradient, the result keeps its graph (create_graph) and stays
    differentiable in them."""
    create = torch.is_grad_enabled() and (
        pts.requires_grad or any(v.requires_grad for v in params.values()))
    with torch.enable_grad():
        p = pts if create and pts.requires_grad else pts.detach().requires_grad_(True)
        x = _trunk(params, encode_position(p, cfg.pos_enc_levels), cfg)
        raw = _matmul(x, params["density_w"], params["density_b"], cfg)
        grad, = torch.autograd.grad(raw.sum(), p, create_graph=create)
    return -grad


def nerf_apply(params: Params, pts: torch.Tensor, ray_d: torch.Tensor,
               cfg: NerfConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb (M, 3), occupancy/density (M, 1)) for points and directions (M, 3)
    (reference OfficialStaticNerf.forward, official_nerf.py:69-96)."""
    x = _trunk(params, encode_position(pts, cfg.pos_enc_levels), cfg)
    density = _occupancy(_matmul(x, params["density_w"], params["density_b"], cfg), cfg)
    dir_enc = encode_position(ray_d, cfg.dir_enc_levels)
    feat = _matmul(x, params["feature_w"], params["feature_b"], cfg)
    h = torch.relu(_matmul(torch.cat([feat, dir_enc], dim=-1),
                           params["rgb_hidden_w"], params["rgb_hidden_b"], cfg))
    rgb = torch.sigmoid(_matmul(h, params["rgb_w"], params["rgb_b"], cfg))
    return rgb, density
