"""hidden_dim 640 to 1024 on the forward trunk, on the CPU: the plain versions of
K3 (ops/fused_render.py::render_rays_fused) and K5 (ops/fused_mlp.py::
point_mlp) against the JAX package's Pallas kernels in interpret mode, and the
width gates of the CUDA wrappers there (csrc/mlp_fwd_xwide_sm90.cuh serves K3
and K5 at 640, 768, 896 and 1024; the backward kernels stop at 512 and name the
entry of ROADMAP.md's Queue 3 (c) that brings each of them).

Tolerances, as tests/test_torch_wide_mlp.py holds the same functions at 384
and 512: K3's outputs within 2e-3 of the largest entry (at least 1e-3); K5's
within 1e-4 absolute. Both sides round the same operands to bf16 and sum in
f32 in another order. The interpreted kernels take seconds each at these
widths, so K3 runs at 640 only, and K5 at 640 and 1024, each on the two flag
sets the card's checks use.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params

from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.models.nerf import init_nerf_params as init_torch_params
from nope_nerf_torch.ops import fused_mlp as FM
from nope_nerf_torch.ops import fused_render as F

torch.set_num_threads(2)
FLAGS = [("softplus", False), ("relu", True)]   # (occupancy, head and renderer dist_alpha)
BACKWARD = {   # each backward kernel's entry of Queue 3 (c) past 512
    "render-backward (frozen network)": 2, "point-query MLP backward (frozen network)": 2,
    "point-query MLP backward": 3, "train": 4, "render-backward": 4}
FORWARD = ("render", "point-query MLP forward")


def _port_cfg(jc):
    return NerfConfig(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})


def _close(got, ref, rel):
    ref = np.asarray(ref)
    assert np.max(np.abs(ref - got.numpy())) < rel * max(1e-3, float(np.abs(ref).max()))


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
def test_render_plain_matches_pallas_kernel_interpret(occ, dist_alpha):
    """K3's plain version against _render_fwd_kernel at D = 640, 8 rays x 128
    samples: rgb, dist, weights and alpha."""
    from jax.experimental.pallas import tpu as pltpu
    from nope_nerf_tpu.ops.pallas_render import pack_rays, render_rays_fused

    D = 640
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
@pytest.mark.parametrize("D", [640, 1024])
def test_point_mlp_plain_matches_pallas_kernel_interpret(D, occ, dist_alpha):
    """K5's plain version against nerf_apply_fused (_fwd_kernel) at D = 640 and
    1024 on 200 points (a ragged last pass on both sides)."""
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


@pytest.mark.parametrize("D", [640, 768, 896, 1024, 1152])
def test_xwide_width_gates(D):
    """K3 and K5 take 640 to 1024; at those widths each backward kernel raises
    NotImplementedError naming its entry of Queue 3 (c) (the frozen-network
    variants item 2, K6 full item 3, K1 and K4 full item 4). Past 1024 every
    kernel raises, naming Queue 3 (c). The checks run before any device
    work, here on the CPU."""
    assert set(F.KERNEL_WIDTHS) == set(FORWARD) | set(BACKWARD)
    for kernel in F.KERNEL_WIDTHS:
        if D <= 1024 and kernel in FORWARD:
            F.check_kernel_width(kernel, D)
            F._check_kernel_shapes(kernel, 1024, D)
            continue
        with pytest.raises(NotImplementedError, match="hidden_dim") as info:
            F.check_kernel_width(kernel, D)
        text = str(info.value)
        assert "Queue 3 (c)" in text
        if D <= 1024:
            assert f"Queue 3 (c), item {BACKWARD[kernel]}" in text
        else:
            assert "past 1024" in text and "item" not in text
    cfg = NerfConfig(hidden_dim=D, use_pallas=True)
    for kernel in ("forward", FM.mlp_bwd_kernel(False), FM.mlp_bwd_kernel(True)):
        if D <= 1024 and kernel == "forward":
            FM._check_width(cfg, kernel)
        else:
            with pytest.raises(NotImplementedError, match="Queue 3 \\(c\\)"):
                FM._check_width(cfg, kernel)


def _meta_params(cfg):
    gen = torch.Generator().manual_seed(0)
    return {k: v.to("meta") for k, v in init_torch_params(cfg, gen, device="cpu").items()}


def test_xwide_routes_raise_before_any_build():
    """On a device the kernels serve (a meta tensor stands in for a CUDA one:
    the checks come before any launch or build), at 640: K3's forward for a
    frozen network and K5's forward pass their gates and go on to the kernel's
    build (no nvcc on this machine); the differentiable routes of K3 and K5
    check the backward's variant first and raise NotImplementedError, with or
    without parameters that want gradients, and so does every backward
    wrapper."""
    cfg = NerfConfig(hidden_dim=640, use_pallas=True)
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
        F._render_forward(params, rays, z, cfg, False, True, False)
    with pytest.raises(RuntimeError, match="nvcc"):
        FM._mlp_fwd_cuda(params, pts, pts, cfg)
    with pytest.raises(NotImplementedError, match="render-backward kernel.*item 4"):
        F._RenderFused.forward(wants, rays, z, cfg, False, True, names, *tensors)
    with pytest.raises(NotImplementedError, match="render-backward \\(frozen network\\).*item 2"):
        F._RenderFused.forward(frozen, rays, z, cfg, False, True, names, *tensors)
    with pytest.raises(NotImplementedError, match="MLP backward kernel.*item 3"):
        FM._PointMLP.forward(SimpleNamespace(needs_input_grad=wants.needs_input_grad[2:]),
                             pts, pts, cfg, names, *tensors)
    with pytest.raises(NotImplementedError, match="\\(frozen network\\).*item 2"):
        FM._PointMLP.forward(SimpleNamespace(needs_input_grad=frozen.needs_input_grad[2:]),
                             pts, pts, cfg, names, *tensors)
    with pytest.raises(NotImplementedError, match="train kernel.*item 4"):
        F._train_cuda({}, rays, z, tgt, cfg, False, 1, False)
    with pytest.raises(NotImplementedError, match="item 4"):
        F._render_bwd_cuda({}, rays, z, g_rgb, g_dist, None, None, cfg, False)
    with pytest.raises(NotImplementedError, match="item 2"):
        F._render_bwd_cuda({}, rays, z, g_rgb, g_dist, None, None, cfg, False,
                           want_param_grads=False)
    with pytest.raises(NotImplementedError, match="item 3"):
        FM._mlp_bwd_cuda({}, pts, pts, pts, torch.empty(4, 1, **meta), cfg)
    with pytest.raises(NotImplementedError, match="item 2"):
        FM._mlp_bwd_cuda({}, pts, pts, pts, torch.empty(4, 1, **meta), cfg,
                         want_param_grads=False)
