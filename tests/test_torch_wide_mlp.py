"""hidden_dim 384 and 512 on the forward trunk, on the CPU: the plain versions of
K3 (ops/fused_render.py::render_rays_fused) and K5 (ops/fused_mlp.py::
point_mlp) against the JAX package's Pallas kernels in interpret mode at both
widths, the renderer through Trainer.render_frame's route at 384 against
JAX's unfused renderer, NerfConfig's gate at 512, and the per-kernel width
gates of the CUDA wrappers (csrc/mlp_fwd_wide_sm90.cuh serves K3 and K5 at
384 and 512, csrc/mlp_dx_wide_sm90.cuh the backward kernels, the frozen-network
variants of K4 and K6 and the kernels that form weight gradients, K1, K4 full
and K6 full).

Tolerances: K3's outputs within 2e-3 of the largest entry (at least 1e-3), as
tests/test_torch_render.py holds it at 256; K5's within 1e-4 absolute, as
tests/test_torch_fused_mlp.py holds it in interpret mode. Both sides round the
same operands to bf16 and sum in f32 in another order. The renders: 2e-3 of
the largest entry, the bf16 class of tests/test_torch_render.py and
tests/test_torch_hierarchical.py. The interpreted kernels take seconds each
at 512, so the grid is the two flag sets the card's checks use.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.config import load_config as jax_load_config
from nope_nerf_tpu.geometry.camera import camera_matrix_from_focal
from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.ops import render as jrender

from nope_nerf_torch.config import load_config
from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.models.nerf import init_nerf_params as init_torch_params
from nope_nerf_torch.ops import fused_mlp as FM
from nope_nerf_torch.ops import fused_render as F
from nope_nerf_torch.ops import render as trender

torch.set_num_threads(2)
WIDE = [384, 512]
FLAGS = [("softplus", False), ("relu", True)]   # (occupancy, head and renderer dist_alpha)


def _port_cfg(jc):
    return NerfConfig(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})


def _close(got, ref, rel):
    ref = np.asarray(ref)
    assert np.max(np.abs(ref - got.numpy())) < rel * max(1e-3, float(np.abs(ref).max()))


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
@pytest.mark.parametrize("D", WIDE)
def test_render_plain_matches_pallas_kernel_interpret(D, occ, dist_alpha):
    """K3's plain version against _render_fwd_kernel at D = 384 and 512, 8 rays
    x 128 samples: rgb, dist, weights and alpha."""
    from jax.experimental.pallas import tpu as pltpu
    from nope_nerf_tpu.ops.pallas_render import pack_rays, render_rays_fused

    jc = JNerfConfig(hidden_dim=D, use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha)
    jp = init_nerf_params(jax.random.key(D), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(D)
    o, v, d = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(3))
    z = np.sort(rng.uniform(0.1, 6.0, size=(8, 128)).astype(np.float32), axis=1)
    with pltpu.force_tpu_interpret_mode():
        ref = render_rays_fused(jp, pack_rays(*(jnp.asarray(a) for a in (o, v, d))),
                                jnp.asarray(z), jc, dist_alpha)
    got = F.render_rays_fused(tp, F.pack_rays(*(torch.from_numpy(a) for a in (o, v, d))),
                              torch.from_numpy(z), _port_cfg(jc), dist_alpha)
    assert got[2].shape == (8, 128)
    for r, g in zip(ref, got):
        _close(g, r, 2e-3)


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
@pytest.mark.parametrize("D", WIDE)
def test_point_mlp_plain_matches_pallas_kernel_interpret(D, occ, dist_alpha):
    """K5's plain version against nerf_apply_fused (_fwd_kernel) at D = 384 and
    512 on 200 points (a ragged last pass on both sides)."""
    from jax.experimental.pallas import tpu as pltpu
    from nope_nerf_tpu.ops.pallas_mlp import nerf_apply_fused

    jc = JNerfConfig(hidden_dim=D, compute_dtype="bfloat16", occ_activation=occ,
                     dist_alpha=dist_alpha, use_pallas=True)
    jp = init_nerf_params(jax.random.key(D + 1), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(D + 1)
    pts = (rng.normal(size=(200, 3)) * 2.0).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        r_rgb, r_den = nerf_apply_fused(jp, jnp.asarray(pts), jnp.asarray(dirs), jc)
    rgb, den = FM.point_mlp(tp, torch.from_numpy(pts), torch.from_numpy(dirs), _port_cfg(jc))
    assert rgb.shape == (200, 3) and den.shape == (200, 1)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(r_rgb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(den.numpy(), np.asarray(r_den), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_importance", [0, 64], ids=["fused", "hierarchical"])
def test_render_frame_route_matches_jax_unfused(n_importance):
    """render_nope_nerf as Trainer.render_frame calls it (eval, no jitter, no
    aux) at hidden_dim 384 with use_pallas, 16 rays x 128 samples: through K3's
    plain version, and with n_importance 64 through K5's twice, against JAX's
    unfused renderer in bfloat16."""
    D, n = 384, 16
    jc = JNerfConfig(hidden_dim=D, compute_dtype="bfloat16", use_pallas=False)
    tc = NerfConfig(hidden_dim=D, compute_dtype="bfloat16", use_pallas=True)
    jp = init_nerf_params(jax.random.key(3), jc)
    jp["density_b"] = jp["density_b"] - 4.0   # transmittance alive to the last sample
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(3)
    cam = np.array(camera_matrix_from_focal(jnp.asarray(1.2), jnp.asarray(1.4)))
    world = np.eye(4, dtype=np.float32)
    world[:3, 3] = [0.3, -0.2, 0.5]
    pixels = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, size=(n, 1)).astype(np.float32)
    kw = dict(num_points=128, n_importance=n_importance)
    ref = jrender.render_nope_nerf(jp, jnp.asarray(pixels), jnp.asarray(depth), jnp.asarray(cam),
                                   jnp.asarray(world), None, None, jrender.RenderConfig(**kw), jc,
                                   add_noise=False, eval_=True, need_aux=False)
    got = trender.render_nope_nerf(tp, torch.from_numpy(pixels), torch.from_numpy(depth),
                                   torch.from_numpy(cam), torch.from_numpy(world), None, None,
                                   trender.RenderConfig(**kw), tc, add_noise=False, eval_=True,
                                   need_aux=False)
    for k in ("rgb", "depth_pred"):
        _close(got[k], ref[k], 2e-3)


def test_nerf_config_gate_at_512_is_jax_s():
    """hidden_dim 512 (and 384) with the default use_pallas_renderer takes the
    kernels' route in both packages; 448 (no multiple of 128) takes neither."""
    for D in (384, 512, 448):
        over = {"model": {"hidden_dim": D}}
        jc = JNerfConfig.from_cfg(jax_load_config(overrides=over))
        tc = NerfConfig.from_cfg(load_config(overrides=over))
        assert tc.use_pallas == jc.use_pallas == (D % 128 == 0)
        assert tc.hidden_dim == jc.hidden_dim == D


@pytest.mark.parametrize("D", [128, 256, 384, 512, 640, 1024, 64])
def test_width_gates(D):
    """Every CUDA kernel takes 128 to 512: K3, K5, the frozen-network
    variants of K4 and K6, K6 full, and the render kernels that form weight
    gradients, K1 and K4 full (their wide kernel on csrc/mlp_dx_wide_sm90.cuh's
    chain); every one also takes 640 and 1024 (csrc/mlp_fwd_xwide_sm90.cuh's
    trunk and csrc/mlp_dx_xwide_sm90.cuh's chain). Every kernel raises
    NotImplementedError for a width JAX's kernels do not take; no message
    names Queue 3 (b) any more. The checks run before any device work, here
    on the CPU."""
    for kernel in F.KERNEL_WIDTHS:
        if D in (128, 256, 384, 512, 640, 1024):
            F.check_kernel_width(kernel, D)
            F._check_kernel_shapes(kernel, 128, D)
            continue
        with pytest.raises(NotImplementedError, match="hidden_dim") as info:
            F.check_kernel_width(kernel, D)
        assert "Queue 3 (b)" not in str(info.value)
        assert ("Queue 3 (c)" in str(info.value)) == (D > 512)
    assert set(F.KERNEL_WIDTHS) == {
        "render", "point-query MLP forward", "render-backward (frozen network)",
        "point-query MLP backward (frozen network)", "point-query MLP backward", "train",
        "render-backward"}
    assert F.render_bwd_kernel(False) == "render-backward (frozen network)"
    assert F.render_bwd_kernel(True) == "render-backward"
    cfg = NerfConfig(hidden_dim=D, use_pallas=True)
    for kernel in ("forward", FM.mlp_bwd_kernel(False), FM.mlp_bwd_kernel(True)):
        if D in (128, 256, 384, 512, 640, 1024):
            FM._check_width(cfg, kernel)
        else:
            with pytest.raises(NotImplementedError):
                FM._check_width(cfg, kernel)


def _meta_params(cfg):
    gen = torch.Generator().manual_seed(0)
    return {k: v.to("meta") for k, v in init_torch_params(cfg, gen, device="cpu").items()}


def test_wide_gates_fire_before_device_work():
    """On a device the kernels serve (a meta tensor stands in for a CUDA one:
    the checks come before any launch or build), K1 and K4 full at 512 pass
    their width gate, and so does the differentiable route of K3 when a nerf
    parameter wants a gradient (its forward checks the backward's variant),
    K6 full's gate, the differentiable route of K5 with or without parameters
    that want gradients, the frozen variants' gates and K3's forward for a
    frozen network: every call goes on to the kernel's build (no nvcc on this
    machine). Past 1024 (1152) K1 and K4 full, and the differentiable route
    of K3 with parameters that want gradients, raise NotImplementedError
    naming Queue 3 (c) before any build."""
    cfg = NerfConfig(hidden_dim=512, use_pallas=True)
    meta = dict(device="meta")
    rays, z = torch.empty(4, 9, **meta), torch.empty(4, 128, **meta)
    tgt = torch.empty(4, F.TGT_DIM, **meta)
    g_rgb, g_dist = torch.empty(4, 3, **meta), torch.empty(4, **meta)
    pts = torch.empty(4, 3, **meta)
    params = _meta_params(cfg)
    names = tuple(sorted(params))
    tensors = [params[k] for k in names]
    wants = SimpleNamespace(needs_input_grad=(True,) * 6 + (True,) * len(names))
    frozen = SimpleNamespace(needs_input_grad=(True,) * 6 + (False,) * len(names))
    with pytest.raises(RuntimeError, match="nvcc"):
        F._train_cuda(params, rays, z, tgt, cfg, False, 1, False)
    with pytest.raises(RuntimeError, match="nvcc"):
        F._render_bwd_cuda(params, rays, z, g_rgb, g_dist, None, None, cfg, False)
    with pytest.raises(RuntimeError, match="nvcc"):
        F._RenderFused.forward(wants, rays, z, cfg, False, True, names, *tensors)
    with pytest.raises(RuntimeError, match="nvcc"):
        FM._PointMLP.forward(SimpleNamespace(needs_input_grad=wants.needs_input_grad[2:]),
                             pts, pts, cfg, names, *tensors)
    with pytest.raises(RuntimeError, match="nvcc"):
        FM._mlp_bwd_cuda(params, pts, pts, pts, torch.empty(4, 1, **meta), cfg)
    with pytest.raises(RuntimeError, match="nvcc"):
        F._RenderFused.forward(frozen, rays, z, cfg, False, True, names, *tensors)
    with pytest.raises(RuntimeError, match="nvcc"):
        FM._PointMLP.forward(SimpleNamespace(needs_input_grad=frozen.needs_input_grad[2:]),
                             pts, pts, cfg, names, *tensors)
    with pytest.raises(RuntimeError, match="nvcc"):
        F._render_bwd_cuda(params, rays, z, g_rgb, g_dist, None, None, cfg, False,
                           want_param_grads=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        FM._mlp_bwd_cuda(params, pts, pts, pts, torch.empty(4, 1, **meta), cfg,
                         want_param_grads=False)
    past = NerfConfig(hidden_dim=1152, use_pallas=True)
    with pytest.raises(NotImplementedError, match="Queue 3 \\(c\\)"):
        F._train_cuda({}, rays, z, tgt, past, False, 1, False)
    with pytest.raises(NotImplementedError, match="Queue 3 \\(c\\)"):
        F._render_bwd_cuda({}, rays, z, g_rgb, g_dist, None, None, past, False)
    with pytest.raises(NotImplementedError, match="render-backward.*Queue 3 \\(c\\)"):
        F._RenderFused.forward(wants, rays, z, past, False, True, names, *tensors)