"""The weight gradients of K1 (the render train step) and K4 full (the render
backward) as the kernels split them, on the CPU: the dW kernel's plain
version (ops/fused_mlp.py::dw_plain) over the 11 blocks of
fused_mlp.render_dw_table, on the operands the plain backward forms
(fused_render.render_dw_operands), and the blocks the kernels keep in their
chain (dW[9] = x7^T g_sig, dW[13] = h^T g_rgb and the per-ray dW[12] =
de^T ghsum), against the dW blocks of the plain versions _train_plain (K1)
and _bwd_plain (K4), at hidden width 128:

- the {softplus, relu} x dist_alpha grid, K1 with each of its rgb_p and
  white_bg, K4 with cotangents of the weights and alpha as well; S = 128 and
  256; 133 rays (no multiple of the card's 132 SMs), whose 133 row tiles
  split unevenly over dw_chunks' 12 chunks, so the last chunk is ragged.
  Both sides sum the same exact f32 products of bf16 values in another
  order: within 1e-5 of the sum of the products' magnitudes (an f32 rtol
  of 1e-5 on each term).
- The split against the JAX package's train kernel (pallas_render.py's
  render_ray_loss_fused, the Pallas kernel in interpret mode as
  tests/test_pallas_render.py runs it): each block within 2e-2 of its
  largest entry, the tolerance of tests/test_torch_train_kernel.py.
- The table's blocks and the operand bytes the kernels write (9,600 B a
  sample at hidden width 256) checked in Python.
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
from nope_nerf_torch.ops import fused_mlp as FM
from nope_nerf_torch.ops import fused_render as F

torch.set_num_threads(2)
HIDDEN = 128
SMS = 132
FLAGS = [("softplus", False), ("softplus", True), ("relu", False), ("relu", True)]


def _case(n, S, seed, occ="softplus", dist_alpha=False):
    """Seeded params (the JAX package's initialiser), rays from near the
    origin, sorted z on [0.1, 6] and a target table with a mixed depth mask,
    made with numpy: (JAX params, JAX config, torch config, torch params,
    rays, z, tgt, the numpy arrays (o, v, z, rgb_gt, depth_gt, mask))."""
    rng = np.random.default_rng(seed)
    jc = JNerfConfig(hidden_dim=HIDDEN, use_pallas=True, occ_activation=occ,
                     dist_alpha=dist_alpha)
    jp = init_nerf_params(jax.random.key(seed), jc)
    # softplus occupancy 1 - exp(-sigma) saturates within a few samples at
    # the seeded bias: lower it, so that the weights spread over the ray (relu
    # would be cut to zero density, and no gradient)
    if occ == "softplus" and not dist_alpha:
        jp = dict(jp, density_b=jp["density_b"] - 3.0)
    tc = NerfConfig(hidden_dim=HIDDEN, use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha)
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(n, S)).astype(np.float32), axis=1)
    rgb_gt = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    depth_gt = rng.uniform(1.0, 5.0, size=(n,)).astype(np.float32)
    mask = (np.arange(n) % 3) != 0
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    tgt = F.pack_targets(torch.from_numpy(rgb_gt), torch.from_numpy(depth_gt),
                         torch.from_numpy(mask), 0.7 / n, 0.3 / max(mask.sum(), 1))
    return jp, jc, tc, tp, rays, torch.from_numpy(z), tgt, (o, v, z, rgb_gt, depth_gt, mask)


def _aux_cotangents(n, S, seed):
    """K4's four cotangents, numpy-seeded: rgb (n,3), dist (n,), weights and
    alpha (n,S)."""
    rng = np.random.default_rng(seed + 100)
    return tuple(torch.from_numpy(a) for a in (
        (rng.normal(size=(n, 3)) * 1e-2).astype(np.float32),
        (rng.normal(size=(n,)) * 1e-2).astype(np.float32),
        (rng.normal(size=(n, S)) * 1e-3).astype(np.float32),
        (rng.normal(size=(n, S)) * 1e-3).astype(np.float32)))


def _magnitude(x, g):
    """The sum over the samples of |x| |g|, per dW entry (f64)."""
    return x.double().abs().t() @ g.double().abs()


def _split_dws(X, G, chain, n, S):
    """The 14 dW blocks as K1 and K4 full form them: the table's 11 by
    dw_plain in the dW kernel's chunks of samples, dW[9], dW[13] and the
    per-ray dW[12] from the chain's factors. Returns (dWs, the magnitude of
    each block's sum)."""
    chunks = FM.dw_chunks(FM.dw_cta_tiles(K for *_, K, _ in FM.render_dw_table(HIDDEN)), n * S,
                          SMS)
    dws, mags = [None] * 14, [None] * 14
    for wi, xn, gn, K, N in FM.render_dw_table(HIDDEN):
        x, g = X[xn], G[gn]
        assert tuple(x.shape) == (n * S, K) and tuple(g.shape) == (n * S, N), (wi, x.shape, g.shape)
        assert torch.equal(x, x.to(torch.bfloat16).to(torch.float32)), xn
        assert torch.equal(g, g.to(torch.bfloat16).to(torch.float32)), gn
        dws[wi], mags[wi] = FM.dw_plain(x, g, chunks), _magnitude(x, g)
    for wi, x, g in ((9, chain["x7"], chain["g_sig"][:, None]), (13, chain["h"], chain["g_rgb"]),
                     (12, chain["de"], chain["ghsum"])):
        dws[wi], mags[wi] = x.t() @ g, _magnitude(x, g)
    return dws, mags


def _assert_split_matches(dws, mags, ref):
    for wi in range(14):
        assert dws[wi].shape == ref[wi].shape, wi
        err = (dws[wi].double() - ref[wi].double()).abs()
        assert bool((err <= 1e-5 * mags[wi] + 1e-12).all()), (wi, float(err.max()))
    assert float(ref[0].abs().max()) > 0 and float(ref[12].abs().max()) > 0


def _k1(n, S, seed, occ, dist_alpha, rgb_p, white_bg):
    _, _, tc, tp, rays, z, tgt, _ = _case(n, S, seed, occ, dist_alpha)
    _, dW, _, _, _, dtgt = F._train_plain(tp, rays, z, tgt, tc, dist_alpha, rgb_p, white_bg)
    # K1 forms g_rgb and g_dist itself and writes their negatives into d(tgt)
    X, G, chain = F.render_dw_operands(tp, rays, z, -dtgt[:, 0:3], -dtgt[:, 3], None, None, tc,
                                       dist_alpha, white_bg)
    _assert_split_matches(*_split_dws(X, G, chain, n, S), dW)


def _k4(n, S, seed, occ, dist_alpha):
    _, _, tc, tp, rays, z, _, _ = _case(n, S, seed, occ, dist_alpha)
    cot = _aux_cotangents(n, S, seed)
    dW, _, _, _ = F._bwd_plain(tp, rays, z, *cot, tc, dist_alpha)
    X, G, chain = F.render_dw_operands(tp, rays, z, *cot, tc, dist_alpha)
    _assert_split_matches(*_split_dws(X, G, chain, n, S), dW)


@pytest.mark.parametrize("occ,dist_alpha,rgb_p,white_bg",
                         [("softplus", False, 1, False), ("softplus", True, 2, True),
                          ("relu", False, 2, False), ("relu", True, 1, True)])
def test_k1_split_matches_the_train_plain_version(occ, dist_alpha, rgb_p, white_bg):
    _k1(9, 128, 1, occ, dist_alpha, rgb_p, white_bg)


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
def test_k4_split_matches_the_backward_plain_version(occ, dist_alpha):
    _k4(9, 128, 2, occ, dist_alpha)


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_split_at_256_samples(kernel):
    if kernel == "K1":
        _k1(5, 256, 3, "softplus", False, 1, True)
    else:
        _k4(5, 256, 3, "relu", True)


def test_split_over_133_rays_and_a_ragged_last_chunk():
    n, S = 133, 128
    tiles = FM.dw_cta_tiles(K for *_, K, _ in FM.render_dw_table(HIDDEN))
    chunks = FM.dw_chunks(tiles, n * S, SMS)
    bounds = FM._chunk_bounds(n * S, chunks)
    assert (tiles, chunks) == (11, 12)
    assert len({b - a for a, b in bounds}) > 1          # the chunks are not all alike
    _k4(n, S, 4, "softplus", False)


def test_split_matches_the_jax_train_kernel():
    """dw_plain over the table, plus the chain's blocks, on the operands the
    plain version forms, against the gradients of the JAX package's
    render_ray_loss_fused (the Pallas train kernel, interpret mode)."""
    n, S = 8, 128
    jp, jc, tc, tp, rays, z, tgt, (o, v, zn, rgb_gt, depth_gt, mask) = _case(n, S, 0)
    jrays = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    jtgt = jpr.pack_targets(jnp.asarray(rgb_gt), jnp.asarray(depth_gt), jnp.asarray(mask),
                            jnp.asarray(0.7 / n), jnp.asarray(0.3 / max(mask.sum(), 1)))

    def f(p):
        total, _ = jpr.render_ray_loss_fused(p, jrays, jnp.asarray(zn), jtgt, jc, False, 1, False)
        return total

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(f)(jp)
    ref = {k: np.asarray(a) for k, a in grads.items()}
    _, _, _, _, _, dtgt = F._train_plain(tp, rays, z, tgt, tc, False, 1, False)
    X, G, chain = F.render_dw_operands(tp, rays, z, -dtgt[:, 0:3], -dtgt[:, 3], None, None, tc)
    dws, _ = _split_dws(X, G, chain, n, S)
    dBs = [torch.zeros_like(b) for b in F.pack_weights(tp, tc)[1]]
    dBs[8], dBs[11] = dBs[8][:1], dBs[11][:3]
    dws[9], dws[13] = dws[9][:, :1], dws[13][:, :3]
    got = F.unpack_grads(dws, dBs, tc)
    for k in ref:
        if k.endswith("_b"):
            continue                                   # bias gradients: not dW products
        tol = 2e-2 * float(np.max(np.abs(ref[k]))) + 1e-6
        err = float(np.max(np.abs(got[k].numpy() - ref[k])))
        assert err <= tol, f"{k}: err {err} > {tol}"


@pytest.mark.parametrize("D", [128, 256])
def test_render_dw_table_is_k6_without_the_direction_block(D):
    table = FM.render_dw_table(D)
    assert table == FM.point_dw_table(D)[:11]
    assert sorted(w for w, *_ in table) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11]
    assert all(xn != "de" for _, xn, *_ in table)
    # every operand of the table is one the render kernels write
    X = {"pe": F.PE_DIM, "feat": D, **{f"x{i}": D for i in range(8)}}
    G = {"g_h": D // 2, "g_feat": D, **{f"g{i}": D for i in range(8)}}
    assert {xn for _, xn, *_ in table} == set(X) and {gn for _, _, gn, *_ in table} == set(G)
    for _, xn, gn, K, N in table:
        assert (K, N) == (X[xn], G[gn])
    assert FM.dw_cta_tiles(K for *_, K, _ in table) == (20 if D == 256 else 11)


@pytest.mark.parametrize("D", [128, 256])
def test_render_operand_bytes(D):
    x, g = F.render_operand_bytes(D, 1, 128)
    # per sample: pe (64 columns), x0..x7 and feat (D each); g_h (D/2), g_feat, g7..g0 (D each)
    assert (x / 128, g / 128) == (2 * (64 + 9 * D), 2 * (D // 2 + 9 * D))
    if D == 256:
        assert (x / 128, g / 128, (x + g) / 128) == (4736, 4864, 9600)
        # the main path's 1024 rays x 128 samples: 1.26 GB written once and read once
        assert sum(F.render_operand_bytes(D, 1024, 128)) == 9600 * 131072
    assert F.render_operand_bytes(D, 133, 256) == (266 * x, 266 * g)
