"""Port parity for the train-fused program (K1): the plain PyTorch version
`render_ray_loss_fused_plain` against nope_nerf_tpu's `render_ray_loss_fused`,
the Pallas kernel run in interpret mode as tests/test_pallas_render.py runs it.

Inputs come from a numpy seed: 8 or 16 rays x 128 samples at hidden width
128, over {softplus, relu} x dist_alpha x rgb_p x white_bg. Tolerances: total
and sums 2e-3 relative; each gradient block 2e-2 x its largest entry (+1e-6):
both sides round the same cotangents to bf16 before every product, but sum
the f32 products in another order, so a rounding flips now and then and
propagates down the chain.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.ops import pallas_render as jpr

from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.ops import fused_render as F

torch.set_num_threads(2)
HIDDEN = 128
S = 128


def _inputs(n, seed, white=False, dist_alpha=False):
    rng = np.random.default_rng(seed)
    jp = init_nerf_params(jax.random.key(seed), JNerfConfig(hidden_dim=HIDDEN,
                                                            white_background=white))
    # The weights should spread over the whole ray, so that the composite's
    # backward sees every sample and no single sample carries the gradient (the
    # encoding derivative multiplies a cotangent's bf16 rounding by up to 2^9, so
    # one dominant sample makes d(rays) a coin toss). Occupancy 1 - exp(-sigma)
    # needs a lower density bias for that; delta-scaled opacity does not, and
    # with a lower one its forced last hit would take most of the weight.
    if not dist_alpha:
        jp = dict(jp, density_b=jp["density_b"] - 3.0)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(n, S)).astype(np.float32), axis=1)
    rgb_gt = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    depth_gt = rng.uniform(1.0, 5.0, size=(n,)).astype(np.float32)
    mask = (np.arange(n) % 3) != 0
    return jp, o, v, z, rgb_gt, depth_gt, mask


def _jax_run(jp, o, v, z, rgb_gt, depth_gt, mask, jc, dist_alpha, rgb_p, white):
    rays = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    tgt = jpr.pack_targets(jnp.asarray(rgb_gt), jnp.asarray(depth_gt), jnp.asarray(mask),
                           jnp.asarray(0.7 / len(o)), jnp.asarray(0.3 / max(mask.sum(), 1)))

    def f(p, r, zz, t):
        total, sums = jpr.render_ray_loss_fused(p, r, zz, t, jc, dist_alpha, rgb_p, white)
        return total, sums

    with pltpu.force_tpu_interpret_mode():
        (total, sums), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
            jp, rays, jnp.asarray(z), tgt)
    gp, gr, gz, gt = grads
    return (float(total), np.asarray(sums), {k: np.asarray(a) for k, a in gp.items()},
            np.asarray(gr)[:, :9], np.asarray(gz), np.asarray(gt)[:, :7])


def _port_inputs(jp, o, v, z, rgb_gt, depth_gt, mask):
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    tgt = F.pack_targets(torch.from_numpy(rgb_gt), torch.from_numpy(depth_gt),
                         torch.from_numpy(mask), 0.7 / len(o), 0.3 / max(mask.sum(), 1))
    return tp, rays, torch.from_numpy(z), tgt


def _assert_block(name, got, ref):
    tol = 2e-2 * float(np.max(np.abs(ref))) + 1e-6
    err = float(np.max(np.abs(got - ref)))
    assert got.shape == ref.shape, name
    assert err <= tol, f"{name}: err {err} > {tol}"


def _compare(n, seed, occ, dist_alpha, rgb_p, white):
    data = _inputs(n, seed, white, dist_alpha)
    jc = JNerfConfig(hidden_dim=HIDDEN, use_pallas=True, occ_activation=occ,
                     dist_alpha=dist_alpha, white_background=white)
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True, occ_activation=occ,
                    dist_alpha=dist_alpha, white_background=white)
    r_total, r_sums, r_gp, r_gr, r_gz, r_gt = _jax_run(*data, jc, dist_alpha, rgb_p, white)
    tp, rays, z, tgt = _port_inputs(*data)
    total, sums, grads = F.render_ray_loss_fused_plain(tp, rays, z, tgt, tc, dist_alpha,
                                                       rgb_p, white)
    np.testing.assert_allclose(float(total), r_total, rtol=2e-3)
    np.testing.assert_allclose(sums.numpy(), r_sums, rtol=2e-3)
    assert set(grads["params"]) == set(r_gp)
    for k in sorted(r_gp):
        _assert_block(k, grads["params"][k].numpy(), r_gp[k])
    _assert_block("rays", grads["rays"].numpy(), r_gr)
    _assert_block("z", grads["z"].numpy(), r_gz)
    _assert_block("tgt", grads["tgt"].numpy(), r_gt)
    return tp, rays, z, tgt, tc, total, grads


def test_plain_matches_pallas_train_kernel_default_flags():
    """The default config's flags (softplus, no dist_alpha, L1, black
    background), and the autograd wrapper over the same plain version: its
    gradients are the stashed ones scaled by the cotangent of `total`."""
    tp, rays, z, tgt, tc, total, grads = _compare(8, 0, "softplus", False, 1, False)
    leaves = {k: t.clone().requires_grad_(True) for k, t in tp.items()}
    rays_g, z_g, tgt_g = (t.clone().requires_grad_(True) for t in (rays, z, tgt))
    tot, sums = F.render_ray_loss_fused(leaves, rays_g, z_g, tgt_g, tc, False, 1, False)
    assert not sums.requires_grad
    np.testing.assert_array_equal(float(tot), float(total))
    (3.0 * tot).backward()
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), 3.0 * grads["params"][k].numpy(), rtol=1e-6)
    np.testing.assert_allclose(rays_g.grad.numpy(), 3.0 * grads["rays"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(z_g.grad.numpy(), 3.0 * grads["z"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(tgt_g.grad.numpy(), 3.0 * grads["tgt"].numpy(), rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("rgb_p", [1, 2])
@pytest.mark.parametrize("dist_alpha", [False, True])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
def test_plain_matches_pallas_train_kernel_flag_grid(occ, dist_alpha, rgb_p, white):
    _compare(16, 1, occ, dist_alpha, rgb_p, white)


def test_plain_blocks_and_bit_equality():
    """Blocks of rays are summed in order: a batch spanning several blocks
    matches one block within f32 summation noise, and two runs give the same
    bits."""
    jp, o, v, z, rgb_gt, depth_gt, mask = _inputs(12, 2)
    tp, rays, zt, tgt = _port_inputs(jp, o, v, z, rgb_gt, depth_gt, mask)
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)
    one = F.render_ray_loss_fused_plain(tp, rays, zt, tgt, tc, False, 1, False)
    old = F.PLAIN_TRAIN_BLOCK_RAYS
    F.PLAIN_TRAIN_BLOCK_RAYS = 5
    try:
        many = F.render_ray_loss_fused_plain(tp, rays, zt, tgt, tc, False, 1, False)
        again = F.render_ray_loss_fused_plain(tp, rays, zt, tgt, tc, False, 1, False)
    finally:
        F.PLAIN_TRAIN_BLOCK_RAYS = old
    np.testing.assert_allclose(float(many[0]), float(one[0]), rtol=1e-5)
    for k in one[2]["params"]:
        a, b = many[2]["params"][k], one[2]["params"][k]
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-9, k
        assert torch.equal(a, again[2]["params"][k])
    for k in ("rays", "z", "tgt"):
        assert torch.equal(many[2][k], again[2][k])
        np.testing.assert_allclose(many[2][k].numpy(), one[2][k].numpy(), rtol=1e-5, atol=1e-7)


def test_pack_targets_and_unpack_grads_layout():
    """pack_targets' columns are the JAX table's live lanes, and unpack_grads
    undoes pack_weights: unpacking the packed (in, out) weights themselves
    returns the params."""
    rng = np.random.default_rng(3)
    rgb, dep = rng.uniform(size=(5, 3)).astype(np.float32), rng.uniform(size=5).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], bool)
    ref = np.asarray(jpr.pack_targets(jnp.asarray(rgb), jnp.asarray(dep), jnp.asarray(mask),
                                      jnp.asarray(0.25), jnp.asarray(0.5)))
    got = F.pack_targets(torch.from_numpy(rgb), torch.from_numpy(dep), torch.from_numpy(mask),
                         0.25, torch.tensor(0.5))
    assert got.shape == (5, F.TGT_DIM)
    np.testing.assert_array_equal(got.numpy(), ref[:, :7])
    assert not ref[:, 7:].any()
    assert (F.TGT_DEPTH, F.TGT_MASK, F.TGT_WRGB, F.TGT_WDEPTH) == (
        jpr.TGT_DEPTH, jpr.TGT_MASK, jpr.TGT_WRGB, jpr.TGT_WDEPTH)

    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)
    jp = init_nerf_params(jax.random.key(4), JNerfConfig(hidden_dim=HIDDEN))
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    W, Wt, B = F.pack_weights_both(tp, tc)
    for a, b in zip(W, Wt):
        assert torch.equal(a.t(), b)
    dWs = [w.to(torch.float32) for w in Wt]
    dWs[9], dWs[13] = dWs[9][:, :1], dWs[13][:, :3]
    dBs = list(B)
    dBs[8], dBs[11] = dBs[8][:1], dBs[11][:3]
    back = F.unpack_grads(dWs, dBs, tc)
    assert set(back) == set(tp)
    for k, t in tp.items():
        ref_t = t if k.endswith("_b") else t.to(torch.bfloat16).to(torch.float32)
        assert torch.equal(back[k], ref_t), k


def test_train_wrapper_rejects_bad_inputs():
    jp, o, v, z, rgb_gt, depth_gt, mask = _inputs(4, 5)
    tp, rays, zt, tgt = _port_inputs(jp, o, v, z, rgb_gt, depth_gt, mask)
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True)
    with pytest.raises(ValueError):
        F.render_ray_loss_fused(tp, rays, zt, tgt[:, :5], tc, False, 1, False)
    with pytest.raises(ValueError):
        F.render_ray_loss_fused(tp, rays[:0], zt[:0], tgt[:0], tc, False, 1, False)
    with pytest.raises(ValueError):
        F.render_ray_loss_fused(tp, rays, zt, tgt, tc, False, 3, False)
    with pytest.raises(NotImplementedError):
        F.render_ray_loss_fused(tp, rays.to("meta"), zt.to("meta"), tgt.to("meta"), tc,
                                False, 1, False)
