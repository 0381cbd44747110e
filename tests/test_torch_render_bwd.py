"""Port parity for the render's backward (K4): the plain PyTorch version
`render_rays_fused_bwd_plain`, and the differentiable `render_rays_fused` /
`render_nope_nerf` built on it, against nope_nerf_tpu's VJP of
`render_rays_fused`, the Pallas backward kernel run in interpret mode as
tests/test_pallas_render.py runs it.

Inputs come from a numpy seed: 8 or 16 rays x 128 samples at hidden width 128,
spread as tests/test_torch_train_kernel.py spreads them. The cotangents are
those of a smooth loss of the forward's own outputs (an L2 colour and depth
term, a sum of squared weights on every 7th sample, one column of alpha), so
no block's gradient is a sum of cancelling terms. Tolerances: forward values
2e-3 x max(1, max|ref|); each gradient block 2e-2 x its largest entry (+1e-6):
both sides round the same cotangents to bf16 before every product, but sum
the f32 products in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nope_nerf_tpu.geometry.camera import camera_matrix_from_focal as jax_camera_matrix
from nope_nerf_tpu.geometry.camera import pixel_grid as jax_pixel_grid
from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.ops import pallas_render as jpr
from nope_nerf_tpu.ops.render import RenderConfig as JRenderConfig
from nope_nerf_tpu.ops.render import render_nope_nerf as jax_render_nope_nerf

from nope_nerf_torch.geometry.camera import camera_matrix_from_focal
from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.ops import fused_render as F
from nope_nerf_torch.ops.render import RenderConfig, render_nope_nerf

torch.set_num_threads(2)
HIDDEN = 128
S = 128


def _inputs(n, seed, dist_alpha=False):
    """Seeded params, rays, z and targets; the density bias is lowered where
    occupancy would otherwise saturate in the first samples (see
    tests/test_torch_train_kernel.py::_inputs)."""
    rng = np.random.default_rng(seed)
    jp = init_nerf_params(jax.random.key(seed), JNerfConfig(hidden_dim=HIDDEN))
    if not dist_alpha:
        jp = dict(jp, density_b=jp["density_b"] - 3.0)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(n, S)).astype(np.float32), axis=1)
    rgb_gt = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    depth_gt = rng.uniform(1.0, 5.0, size=(n,)).astype(np.float32)
    return jp, o, v, z, rgb_gt, depth_gt


def _cotangents(out, rgb_gt, depth_gt, aux):
    """Cotangents of 0.7 mean|rgb-gt|^2 + 0.3 mean(dist-dgt)^2 [+ mean over rays of
    sum(weights[:, ::7]^2) + sum(alpha[:, 5])] at the forward values `out`."""
    rgb, dist, weights, alpha = (np.asarray(a) for a in out)
    n = rgb.shape[0]
    g_rgb = (1.4 / n * (rgb - rgb_gt)).astype(np.float32)
    g_dist = (0.6 / n * (dist - depth_gt)).astype(np.float32)
    if not aux:
        return g_rgb, g_dist, None, None
    g_w = np.zeros_like(weights)
    g_w[:, ::7] = 2.0 / n * weights[:, ::7]
    g_a = np.zeros_like(alpha)
    g_a[:, 5] = 1.0 / n
    return g_rgb, g_dist, g_w, g_a


def _assert_block(name, got, ref):
    tol = 2e-2 * float(np.max(np.abs(ref))) + 1e-6
    err = float(np.max(np.abs(got - ref)))
    assert got.shape == ref.shape, name
    assert err <= tol, f"{name}: err {err} > {tol}"


def _compare(n, seed, occ, head_dist_alpha, dist_alpha, aux):
    """The plain backward against the JAX VJP; returns the port's inputs and
    gradients for further checks."""
    jp, o, v, z, rgb_gt, depth_gt = _inputs(n, seed, dist_alpha or head_dist_alpha)
    jc = JNerfConfig(hidden_dim=HIDDEN, use_pallas=True, occ_activation=occ,
                     dist_alpha=head_dist_alpha)
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True, occ_activation=occ,
                    dist_alpha=head_dist_alpha)
    rays_j = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    render = jpr.render_rays_fused if aux else jpr.render_rays_fused_noaux
    with pltpu.force_tpu_interpret_mode():
        out_j, vjp = jax.vjp(lambda p, r, zz: render(p, r, zz, jc, dist_alpha), jp, rays_j,
                             jnp.asarray(z))
        full = out_j if aux else jpr.render_rays_fused(jp, rays_j, jnp.asarray(z), jc, dist_alpha)
        cot = _cotangents(full, rgb_gt, depth_gt, aux)
        gp, gr, gz = vjp(tuple(jnp.asarray(c) for c in cot if c is not None))

    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    zt = torch.from_numpy(z)
    out = F.render_rays_fused_plain(tp, rays, zt, tc, dist_alpha, want_aux=True)
    for name, g, r in zip(("rgb", "dist", "weights", "alpha"), out, full):
        r = np.asarray(r)
        assert float(np.max(np.abs(g.numpy() - r))) <= 2e-3 * max(1.0, float(np.abs(r).max())), name
    cot_t = [None if c is None else torch.from_numpy(c) for c in cot]
    dWs, dBs, drays, dz = F.render_rays_fused_bwd_plain(tp, rays, zt, *cot_t, tc, dist_alpha)
    grads = F.unpack_grads(dWs, dBs, tc)
    assert set(grads) == set(gp)
    for k in sorted(gp):
        _assert_block(k, grads[k].numpy(), np.asarray(gp[k]))
    _assert_block("rays", drays.numpy(), np.asarray(gr)[:, :9])
    _assert_block("z", dz.numpy(), np.asarray(gz))
    return tp, rays, zt, tc, cot_t, grads, drays, dz


def test_bwd_plain_matches_pallas_bwd_kernel_default_flags():
    """Default flags with all four cotangents, and the autograd wrapper over
    the same plain version: backward of the same cotangents gives the same
    bits, and a frozen network gets gradients for the rays and z alone."""
    tp, rays, z, tc, cot, grads, drays, dz = _compare(8, 0, "softplus", False, False, True)
    leaves = {k: t.clone().requires_grad_(True) for k, t in tp.items()}
    rays_g, z_g = rays.clone().requires_grad_(True), z.clone().requires_grad_(True)
    out = F.render_rays_fused(leaves, rays_g, z_g, tc, False, want_aux=True)
    assert all(t.requires_grad for t in out)
    torch.autograd.backward(out, cot)
    for k, t in leaves.items():
        assert torch.equal(t.grad, grads[k]), k
    assert torch.equal(rays_g.grad, drays) and torch.equal(z_g.grad, dz)

    rays_f = rays.clone().requires_grad_(True)
    rgb, dist, w, a = F.render_rays_fused(tp, rays_f, z, tc, False, want_aux=False)
    assert w is None and a is None
    torch.autograd.backward((rgb, dist), cot[:2])
    ref = F.render_rays_fused_bwd_plain(tp, rays, z, cot[0], cot[1], None, None, tc, False)
    assert torch.equal(rays_f.grad, ref[2])
    assert all(t.grad is None for t in tp.values())


@pytest.mark.slow
@pytest.mark.parametrize("dist_alpha", [False, True])
@pytest.mark.parametrize("head_dist_alpha", [False, True])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
def test_bwd_plain_matches_pallas_bwd_kernel_flag_grid(occ, head_dist_alpha, dist_alpha):
    _compare(16, 1, occ, head_dist_alpha, dist_alpha, True)


@pytest.mark.slow
def test_bwd_plain_matches_pallas_noaux_vjp():
    """rgb and dist cotangents only, against render_rays_fused_noaux's VJP."""
    _compare(16, 2, "softplus", False, False, False)


def test_bwd_plain_equals_train_plain_on_its_cotangents():
    """The train kernel's plain version and the backward's share one chain: fed
    the cotangents the train program forms itself, the backward returns the
    same bits. Blocks of rays are summed in order, so two runs agree as well."""
    jp, o, v, z, rgb_gt, depth_gt = _inputs(12, 3)
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    zt = torch.from_numpy(z)
    mask = torch.arange(12) % 3 != 0
    tgt = F.pack_targets(torch.from_numpy(rgb_gt), torch.from_numpy(depth_gt), mask, 0.7 / 12,
                         0.3 / float(mask.sum()))
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)
    old = F.PLAIN_TRAIN_BLOCK_RAYS
    F.PLAIN_TRAIN_BLOCK_RAYS = 5
    try:
        for rgb_p in (1, 2):
            _, _, g = F.render_ray_loss_fused_plain(tp, rays, zt, tgt, tc, False, rgb_p, False)
            g_rgb, g_dist = -g["tgt"][:, 0:3], -g["tgt"][:, 3]
            runs = [F.render_rays_fused_bwd_plain(tp, rays, zt, g_rgb, g_dist, None, None, tc,
                                                  False) for _ in range(2)]
            got = dict(F.unpack_grads(runs[0][0], runs[0][1], tc), rays=runs[0][2], z=runs[0][3])
            ref = dict(g["params"], rays=g["rays"], z=g["z"])
            for k in ref:
                assert torch.equal(got[k], ref[k]), (rgb_p, k)
            for a, b in zip([*runs[0][0], *runs[0][1], *runs[0][2:]],
                            [*runs[1][0], *runs[1][1], *runs[1][2:]]):
                assert torch.equal(a, b)
    finally:
        F.PLAIN_TRAIN_BLOCK_RAYS = old


def test_white_background_gradient_arrives_through_the_weights():
    """A white background is applied outside the fused render: its gradient
    reaches the backward as a weights cotangent. The train program folds the
    same term in itself, so both give the same gradients up to f32 rounding
    of the cotangent sum."""
    jp, o, v, z, rgb_gt, depth_gt = _inputs(8, 4)
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    zt = torch.from_numpy(z)
    tgt = F.pack_targets(torch.from_numpy(rgb_gt), torch.from_numpy(depth_gt),
                         torch.ones(8, dtype=torch.bool), 0.7 / 8, 0.3 / 8)
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)
    _, _, ref = F.render_ray_loss_fused_plain(tp, rays, zt, tgt, tc, False, 2, True)
    leaves = {k: t.clone().requires_grad_(True) for k, t in tp.items()}
    rays_g = rays.clone().requires_grad_(True)
    rgb, dist, weights, _ = F.render_rays_fused(leaves, rays_g, zt, tc, False, want_aux=True)
    rgb = rgb + (1.0 - weights.sum(dim=-1))[:, None]
    loss = (0.7 / 8) * ((rgb - tgt[:, 0:3]) ** 2).sum() + (0.3 / 8) * (dist - tgt[:, 3]).abs().sum()
    loss.backward()
    for k, t in leaves.items():
        r = ref["params"][k]
        assert float((t.grad - r).abs().max()) <= 1e-3 * float(r.abs().max()) + 1e-7, k
    assert float((rays_g.grad - ref["rays"]).abs().max()) <= 1e-3 * float(ref["rays"].abs().max())


def test_render_nope_nerf_gradients_match_jax_with_white_background():
    """render_nope_nerf end to end: gradients w.r.t. the nerf params and the
    pixels (through the ray table, where pose gradients flow), white
    background on, every output touched, against the JAX package's fused path
    (as tests/test_pallas_render.py::test_fused_render_grads_match)."""
    n = 8
    rng = np.random.default_rng(5)
    jp = init_nerf_params(jax.random.key(5), JNerfConfig(hidden_dim=HIDDEN, white_background=True))
    jp = dict(jp, density_b=jp["density_b"] - 3.0)
    depth_prior = (1.0 + 3.0 * rng.uniform(size=(n, 1))).astype(np.float32)
    pixels = np.asarray(jax_pixel_grid((4, 4))[1])[:n]
    jc = JNerfConfig(hidden_dim=HIDDEN, use_pallas=True, white_background=True)
    jr = JRenderConfig(num_points=S, white_background=True, depth_range=(0.1, 6.0))
    cam_j = jax_camera_matrix(jnp.asarray(1.2), jnp.asarray(1.4))

    # JAX draws its jitter from the key: with add_noise off both sides sample the
    # same z, and the jitter's path is covered by the train-step tests
    def loss_j(p, px):
        out = jax_render_nope_nerf(p, px, jnp.asarray(depth_prior), cam_j, jnp.eye(4), None,
                                   None, jr, jc, add_noise=False)
        return (jnp.sum(out["rgb"] ** 2) + jnp.sum(out["depth_pred"] ** 2)
                + jnp.sum(out["weights"][:, ::7] ** 2) + jnp.sum(out["alpha"][:, 5]))

    with pltpu.force_tpu_interpret_mode():
        val_j, (gp, gpx) = jax.value_and_grad(loss_j, argnums=(0, 1))(jp, jnp.asarray(pixels))

    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True, white_background=True)
    tr = RenderConfig(num_points=S, white_background=True, depth_range=(0.1, 6.0))
    leaves = {k: torch.from_numpy(np.array(a)).requires_grad_(True) for k, a in jp.items()}
    px = torch.from_numpy(pixels.copy()).requires_grad_(True)
    cam = camera_matrix_from_focal(torch.tensor(1.2), torch.tensor(1.4))
    out = render_nope_nerf(leaves, px, torch.from_numpy(depth_prior), cam, torch.eye(4), None,
                           None, tr, tc, add_noise=False)
    loss = ((out["rgb"] ** 2).sum() + (out["depth_pred"] ** 2).sum()
            + (out["weights"][:, ::7] ** 2).sum() + out["alpha"][:, 5].sum())
    loss.backward()
    np.testing.assert_allclose(float(loss), float(val_j), rtol=2e-3)
    for k in sorted(gp):
        _assert_block(k, leaves[k].grad.numpy(), np.asarray(gp[k]))
    _assert_block("pixels", px.grad.numpy(), np.asarray(gpx))


def test_no_graph_without_grad_and_bad_inputs():
    jp, o, v, z, rgb_gt, depth_gt = _inputs(4, 6)
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    zt = torch.from_numpy(z)
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)
    plain = F.render_rays_fused_plain(tp, rays, zt, tc, False, True)
    out = F.render_rays_fused(tp, rays, zt, tc)
    assert all(not t.requires_grad and t.grad_fn is None for t in out)
    with torch.no_grad():
        out_ng = F.render_rays_fused({k: t.clone().requires_grad_(True) for k, t in tp.items()},
                                     rays, zt, tc)
    assert all(t.grad_fn is None for t in out_ng)
    tracked = F.render_rays_fused(tp, rays.clone().requires_grad_(True), zt, tc)
    for a, b, c in zip(out, out_ng, tracked):
        assert torch.equal(a, b) and torch.equal(a, c.detach())
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    g = torch.ones(4, 3), torch.ones(4)
    with pytest.raises(ValueError):
        F.render_rays_fused_bwd_plain(tp, rays, zt, g[0][:3], g[1], None, None, tc)
    with pytest.raises(ValueError):
        F.render_rays_fused_bwd_plain(tp, rays, zt, g[0], g[1], torch.ones(4, 5), None, tc)
    with pytest.raises(ValueError):
        F.render_rays_fused_bwd_plain(tp, rays[:0], zt[:0], g[0][:0], g[1][:0], None, None, tc)
    with pytest.raises(NotImplementedError):
        F.render_rays_fused(tp, rays.to("meta"), zt.to("meta"), tc)


def test_plain_versions_switch_is_scoped_and_the_backward_keeps_the_forwards_route():
    from nope_nerf_torch.ops._build import runs_plain
    elsewhere = torch.empty(1, device="meta")          # stands for a tensor that is not on the CPU
    assert runs_plain(torch.empty(1)) and not runs_plain(elsewhere)
    with F.plain_versions():
        assert runs_plain(elsewhere)
        with F.plain_versions():
            assert runs_plain(elsewhere)
        assert runs_plain(elsewhere)                   # the inner block restores, not clears
    assert not runs_plain(elsewhere)
    with pytest.raises(KeyError):
        with F.plain_versions():
            raise KeyError("inside")
    assert not runs_plain(elsewhere)                   # restored after an exception too

    jp, o, v, z, rgb_gt, depth_gt = _inputs(4, 8)
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)

    def grads(inside):
        rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v))).requires_grad_(True)
        if inside:
            with F.plain_versions():
                rgb, dist, _, _ = F.render_rays_fused(tp, rays, torch.from_numpy(z), tc)
        else:
            rgb, dist, _, _ = F.render_rays_fused(tp, rays, torch.from_numpy(z), tc)
        (rgb.sum() + dist.sum()).backward()            # after the block has ended
        return rays.grad

    assert torch.equal(grads(True), grads(False))      # on the CPU both are the plain route


def test_bwd_plain_summed_in_f64_is_the_same_function():
    """dtype=float64 keeps the bf16 operands and rounding points and sums
    exactly: f64 outputs that the f32 version meets to f32 summation error."""
    n = 8
    jp, o, v, z, rgb_gt, depth_gt = _inputs(n, 9)
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    zt = torch.from_numpy(z)
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)
    out = F.render_rays_fused_plain(tp, rays, zt, tc, True, True)
    cot = [torch.from_numpy(c) for c in _cotangents(out, rgb_gt, depth_gt, True)]
    f32 = F.render_rays_fused_bwd_plain(tp, rays, zt, *cot, tc, True)
    f64 = F.render_rays_fused_bwd_plain(tp, rays, zt, *cot, tc, True, dtype=torch.float64)
    for a, b in zip([*f32[0], *f32[1], f32[2], f32[3]], [*f64[0], *f64[1], f64[2], f64[3]]):
        assert a.dtype == torch.float32 and b.dtype == torch.float64 and a.shape == b.shape
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max()) + 1e-9
