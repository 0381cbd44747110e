"""Port parity for the point-query MLP (ops/fused_mlp.py): the plain versions of
the forward kernel (K5) and of the backward kernel (K6), on the CPU, against
nope_nerf_tpu at hidden width 128 (the smallest the JAX kernel path takes),
at a ragged M of 300 points (no multiple of the kernels' 128-point pass).

Fast tier: against the JAX package's nerf_apply with compute_dtype
"bfloat16", which pallas_mlp.py:26-28 calls equivalent to its kernel. The
forward rounds the same operands to bf16 and sums in f32 in another order:
within 1e-5 absolute (outputs lie in [0, 1]). The gradients differ in where
bf16 rounds a cotangent (the kernel rounds every cotangent before each
product, JAX's autodiff of nerf_apply rounds others) and so now and then in a
ReLU mask: every block within 5e-2 of its largest entry, the tolerance
tests/test_pallas_mlp.py holds the kernel itself to against nerf_apply.

Slow tier: against nerf_apply_fused itself under
pltpu.force_tpu_interpret_mode(), forward and every gradient (params, points,
directions): the gradients with the same tolerance, the forward within
1e-4 (the interpreted kernel sums its f32 products in yet another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params, nerf_apply

from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.ops import fused_mlp as FM
from nope_nerf_torch.ops.fused_render import unpack_grads

torch.set_num_threads(2)
HIDDEN = 128
M = 300
FLAGS = [("softplus", False), ("softplus", True), ("relu", False), ("relu", True)]


def _setup(occ, dist_alpha, seed=0):
    jc = JNerfConfig(hidden_dim=HIDDEN, compute_dtype="bfloat16", occ_activation=occ,
                     dist_alpha=dist_alpha, use_pallas=True)
    tc = NerfConfig(hidden_dim=HIDDEN, occ_activation=occ, dist_alpha=dist_alpha, use_pallas=True)
    jp = init_nerf_params(jax.random.key(seed), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(M, 3)) * 2.0).astype(np.float32)
    dirs = rng.normal(size=(M, 3)).astype(np.float32)
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    g_den = rng.normal(size=(M, 1)).astype(np.float32)
    return jc, tc, jp, tp, pts, dirs, g_rgb, g_den


def _jax_grads(fn, jp, pts, dirs, g_rgb, g_den, jc):
    def f(p, x, d):
        rgb, den = fn(p, x, d, jc)
        return jnp.sum(rgb * g_rgb) + jnp.sum(den * g_den)
    return jax.grad(f, argnums=(0, 1, 2))(jp, jnp.asarray(pts), jnp.asarray(dirs))


def _port_grads(tp, pts, dirs, g_rgb, g_den, tc):
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    rgb, den = FM.point_mlp(leaves, x, d, tc)
    ((rgb * torch.from_numpy(g_rgb)).sum() + (den * torch.from_numpy(g_den)).sum()).backward()
    return {k: v.grad for k, v in leaves.items()}, x.grad, d.grad


def _assert_grads(got, ref):
    g_params, g_pts, g_dirs = got
    r_params, r_pts, r_dirs = ref
    assert set(g_params) == set(r_params)
    for name, g, r in ([(k, g_params[k], r_params[k]) for k in r_params]
                       + [("points", g_pts, r_pts), ("directions", g_dirs, r_dirs)]):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-6)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 5e-2 * scale, f"{name}: {err} vs largest {scale}"
    assert float(g_pts.abs().max()) > 0 and float(g_dirs.abs().max()) > 0


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
def test_forward_matches_nerf_apply_bf16(occ, dist_alpha):
    jc, tc, jp, tp, pts, dirs, *_ = _setup(occ, dist_alpha)
    r_rgb, r_den = nerf_apply(jp, jnp.asarray(pts), jnp.asarray(dirs), jc)
    rgb, den = FM.point_mlp_fwd_plain(tp, torch.from_numpy(pts), torch.from_numpy(dirs), tc)
    assert rgb.shape == (M, 3) and den.shape == (M, 1)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(r_rgb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(den.numpy(), np.asarray(r_den), rtol=0, atol=1e-5)


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
def test_gradients_match_nerf_apply_bf16(occ, dist_alpha):
    jc, tc, jp, tp, pts, dirs, g_rgb, g_den = _setup(occ, dist_alpha, seed=1)
    ref = _jax_grads(nerf_apply, jp, pts, dirs, g_rgb, g_den, jc)
    _assert_grads(_port_grads(tp, pts, dirs, g_rgb, g_den, tc), ref)


def test_autograd_route_is_the_plain_backward():
    """point_mlp's backward is point_mlp_bwd_plain, bit for bit, and two runs
    of it give the same bits."""
    _, tc, _, tp, pts, dirs, g_rgb, g_den = _setup("softplus", False, seed=2)
    g_params, g_pts, g_dirs = _port_grads(tp, pts, dirs, g_rgb, g_den, tc)
    args = (tp, torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(g_rgb),
            torch.from_numpy(g_den), tc)
    dWs, dBs, dpts, ddirs = FM.point_mlp_bwd_plain(*args)
    again = FM.point_mlp_bwd_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(dWs + dBs + [dpts, ddirs],
                                                  again[0] + again[1] + [again[2], again[3]]))
    assert torch.equal(g_pts, dpts) and torch.equal(g_dirs, ddirs)
    grads = unpack_grads(dWs, dBs, tc)
    for k, g in g_params.items():
        assert torch.equal(g, grads[k]), k


def test_blocks_sum_in_order_and_shapes_are_checked(monkeypatch):
    """The plain versions work in blocks of points; a batch over several blocks
    gives what one block gives, up to the order of the dW sums."""
    _, tc, _, tp, pts, dirs, g_rgb, g_den = _setup("relu", False, seed=3)
    args = (tp, torch.from_numpy(pts), torch.from_numpy(dirs))
    whole = FM.point_mlp_fwd_plain(*args, tc)
    whole_b = FM.point_mlp_bwd_plain(*args, torch.from_numpy(g_rgb), torch.from_numpy(g_den), tc)
    monkeypatch.setattr(FM, "PLAIN_BLOCK_POINTS", 128)
    blocked = FM.point_mlp_fwd_plain(*args, tc)
    blocked_b = FM.point_mlp_bwd_plain(*args, torch.from_numpy(g_rgb), torch.from_numpy(g_den),
                                       tc)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocked))
    assert torch.equal(whole_b[2], blocked_b[2]) and torch.equal(whole_b[3], blocked_b[3])
    for a, b in zip(whole_b[0] + whole_b[1], blocked_b[0] + blocked_b[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    rgb, den = FM.point_mlp(tp, torch.zeros(0, 3), torch.zeros(0, 3), tc)
    assert rgb.shape == (0, 3) and den.shape == (0, 1)
    with pytest.raises(ValueError):
        FM.point_mlp(tp, torch.zeros(4, 3), torch.zeros(5, 3), tc)
    with pytest.raises(ValueError):
        FM.point_mlp(tp, torch.zeros(4, 2), torch.zeros(4, 2), tc)


@pytest.mark.slow
@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
def test_plain_versions_match_pallas_kernels_interpret(occ, dist_alpha):
    """K5's and K6's plain versions against nerf_apply_fused and its custom VJP
    in interpret mode, as tests/test_pallas_mlp.py runs them."""
    from jax.experimental.pallas import tpu as pltpu
    from nope_nerf_tpu.ops.pallas_mlp import nerf_apply_fused

    jc, tc, jp, tp, pts, dirs, g_rgb, g_den = _setup(occ, dist_alpha, seed=4)
    with pltpu.force_tpu_interpret_mode():
        r_rgb, r_den = nerf_apply_fused(jp, jnp.asarray(pts), jnp.asarray(dirs), jc)
        ref = _jax_grads(nerf_apply_fused, jp, pts, dirs, g_rgb, g_den, jc)
    rgb, den = FM.point_mlp_fwd_plain(tp, torch.from_numpy(pts), torch.from_numpy(dirs), tc)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(r_rgb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(den.numpy(), np.asarray(r_den), rtol=0, atol=1e-4)
    _assert_grads(_port_grads(tp, pts, dirs, g_rgb, g_den, tc), ref)
