"""Port parity: the CPU renderer (ops/render.py, ops/fused_render.py) against
nope_nerf_tpu's unfused render_nope_nerf in bfloat16 mode, on 16 rays x 128
samples at hidden width 128, over the flag grid of tests/test_pallas_render.py.

The port takes both of its CPU routes: the fused kernel's plain version
(use_pallas) and the unfused nerf_apply path. The stratified jitter is
pinned: the JAX package's draw is recomputed from its key and handed to the
port. Tolerance 2e-3 x max|ref| on rendered values, as the JAX package holds
its own fused kernel to its unfused path: both round the same operands to
bf16 and sum in f32 in another order, and the composite is a cumprod on one
side and exp of a prefix sum of logs on the other.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.geometry.camera import camera_matrix_from_focal
from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.ops import render as jrender

from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.ops import fused_render as tfused
from nope_nerf_torch.ops import render as trender

torch.set_num_threads(2)
N_RAYS = 16
HIDDEN = 128
KEY = 7


def _setup(white=False, seed=0):
    jp = init_nerf_params(jax.random.key(seed), JNerfConfig(hidden_dim=HIDDEN,
                                                            white_background=white))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    cam = np.array(camera_matrix_from_focal(jnp.asarray(1.2), jnp.asarray(1.4)))
    ang = 0.1
    world = np.eye(4, dtype=np.float32)
    world[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    world[:3, 3] = [0.3, -0.2, 0.5]
    pixels = rng.uniform(-1, 1, size=(N_RAYS, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, size=(N_RAYS, 1)).astype(np.float32)
    return jp, tp, cam, world, pixels, depth


def _jax_noise(n, steps):
    """The stratified jitter JAX's render_nope_nerf draws from key KEY."""
    _, knoise, _ = jax.random.split(jax.random.key(KEY), 3)
    return np.array(jax.random.uniform(knoise, (n, steps), jnp.float32))


def _render_both(rcfg_kw, nerf_kw, port_fused, eval_=False, need_aux=True, add_noise=True):
    white = rcfg_kw.get("white_background", False)
    jp, tp, cam, world, pixels, depth = _setup(white)
    rcfg_j = jrender.RenderConfig(num_points=128, **rcfg_kw)
    rcfg_t = trender.RenderConfig(num_points=128, **rcfg_kw)
    ncfg_j = JNerfConfig(hidden_dim=HIDDEN, compute_dtype="bfloat16", use_pallas=False,
                         white_background=white, **nerf_kw)
    ncfg_t = NerfConfig(hidden_dim=HIDDEN, compute_dtype="bfloat16", use_pallas=port_fused,
                        white_background=white, **nerf_kw)
    ref = jrender.render_nope_nerf(jp, jnp.asarray(pixels), jnp.asarray(depth),
                                   jnp.asarray(cam), jnp.asarray(world), None,
                                   jax.random.key(KEY), rcfg_j, ncfg_j, add_noise=add_noise,
                                   eval_=eval_, need_aux=need_aux)
    got = trender.render_nope_nerf(tp, torch.from_numpy(pixels), torch.from_numpy(depth),
                                   torch.from_numpy(cam), torch.from_numpy(world), None,
                                   None, rcfg_t, ncfg_t, add_noise=add_noise, eval_=eval_,
                                   need_aux=need_aux,
                                   noise=torch.from_numpy(_jax_noise(N_RAYS, 128)))
    return ref, got


def _check(ref, got, keys=("rgb", "depth_pred", "weights", "alpha")):
    for k in keys:
        if got[k] is None:
            continue
        r, g = np.asarray(ref[k]), got[k].numpy()
        scale = max(1e-3, float(np.max(np.abs(r))))
        assert np.max(np.abs(r - g)) < 2e-3 * scale, k
    for k in ("z_vals", "depth_gt"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["object_mask"].numpy(), np.asarray(ref["object_mask"]))


@pytest.mark.parametrize("port_fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("sample_option", ["uniform", "ndc"])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_render_flag_grid(dist_alpha, occ, sample_option, port_fused):
    ref, got = _render_both(dict(dist_alpha=dist_alpha, sample_option=sample_option),
                            dict(occ_activation=occ, dist_alpha=dist_alpha), port_fused)
    _check(ref, got)


@pytest.mark.parametrize("port_fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("variant", ["white_bg", "eval", "eval_noaux", "eval_white_noaux",
                                     "no_normalise", "no_ray_dir"])
def test_render_variants(variant, port_fused):
    rcfg_kw, kw = {}, {}
    if "white" in variant:
        rcfg_kw["white_background"] = True
    if variant.startswith("eval"):
        kw.update(eval_=True, add_noise=False)
    if "noaux" in variant:
        kw["need_aux"] = False
    if variant == "no_normalise":
        rcfg_kw["normalise_ray"] = False
    if variant == "no_ray_dir":
        rcfg_kw["use_ray_dir"] = False
    ref, got = _render_both(rcfg_kw, {}, port_fused, **kw)
    _check(ref, got)
    if port_fused and variant == "eval_noaux":
        assert got["weights"] is None and got["alpha"] is None


def test_sample_uniform_pinned_noise():
    n, steps, rng = 5, 128, (0.05, 6.0)
    noise = _jax_noise(n, steps)
    _, knoise, _ = jax.random.split(jax.random.key(KEY), 3)
    ref = jrender.sample_uniform(knoise, n, steps, rng, True)
    got = trender.sample_uniform(n, steps, rng, True, torch.device("cpu"),
                                 noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    flat = trender.sample_uniform(n, steps, rng, False, torch.device("cpu"))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(
        jrender.sample_uniform(None, n, steps, rng, False)))


def test_composite_and_scan_composite():
    rng = np.random.default_rng(4)
    alpha = rng.uniform(0, 0.2, size=(6, 128)).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 8, size=(6, 128)).astype(np.float32), axis=1)
    rgb = rng.uniform(0, 1, size=(6, 128, 3)).astype(np.float32)
    ref = jrender.composite(jnp.asarray(rgb), jnp.asarray(alpha), jnp.asarray(z))
    got = trender.composite(*(torch.from_numpy(a) for a in (rgb, alpha, z)))
    scan = tfused.composite_scan(*(torch.from_numpy(a) for a in (alpha, z, rgb)))
    for r, g, s in zip(ref, got, scan):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_fused_plain_empty_batch_and_bad_shapes():
    _, tp, *_ = _setup()
    ncfg = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)
    rgb, dist, w, a = tfused.render_rays_fused(tp, torch.zeros(0, 9), torch.zeros(0, 128), ncfg)
    assert rgb.shape == (0, 3) and dist.shape == (0,) and w.shape == a.shape == (0, 128)
    with pytest.raises(ValueError):
        tfused.render_rays_fused(tp, torch.zeros(4, 128), torch.zeros(4, 128), ncfg)
    with pytest.raises(ValueError):
        tfused.render_rays_fused(tp, torch.zeros(4, 9), torch.zeros(5, 128), ncfg)


def test_cuda_ineligible_config_raises_not_implemented():
    """Every config but outside_steps > 0 has a route on CUDA now (the fused
    render or the unfused one through the point-query MLP kernels); that one
    raises on every device, as the JAX package's renderer cannot run it. The
    check fires before any device work, so a meta tensor stands in for a
    CUDA one here."""
    _, tp, cam, world, pixels, depth = _setup()
    for px in (torch.empty((N_RAYS, 2), device="meta"), torch.from_numpy(pixels)):
        with pytest.raises(NotImplementedError, match="outside_steps"):
            trender.render_nope_nerf(tp, px, None, torch.from_numpy(cam),
                                     torch.from_numpy(world), None, None,
                                     trender.RenderConfig(outside_steps=8),
                                     NerfConfig(hidden_dim=HIDDEN, use_pallas=True))


@pytest.mark.slow
@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_plain_matches_pallas_kernel_interpret(occ, dist_alpha):
    """The port's plain version of the fused kernel against the Pallas kernel
    itself (interpret mode), at the full width 256."""
    from jax.experimental.pallas import tpu as pltpu
    from nope_nerf_tpu.ops.pallas_render import pack_rays, render_rays_fused

    jc = JNerfConfig(use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha)
    jp = init_nerf_params(jax.random.key(1), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(0)
    o, v, d = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(3))
    z = np.sort(rng.uniform(0.1, 6.0, size=(8, 128)).astype(np.float32), axis=1)
    with pltpu.force_tpu_interpret_mode():
        ref = render_rays_fused(jp, pack_rays(*(jnp.asarray(a) for a in (o, v, d))),
                                jnp.asarray(z), jc, dist_alpha)
    tc = NerfConfig(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    got = tfused.render_rays_fused(tp, tfused.pack_rays(*(torch.from_numpy(a) for a in (o, v, d))),
                                   torch.from_numpy(z), tc, dist_alpha)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert np.max(np.abs(r - g.numpy())) < 2e-3 * max(1e-3, float(np.abs(r).max()))
