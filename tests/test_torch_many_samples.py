"""Port parity at more than 256 samples a ray: the plain versions of
K1 (`render_ray_loss_fused_plain`), K4 (`render_rays_fused_bwd_plain`) and K3
(`render_rays_fused_plain`) against nope_nerf_tpu's Pallas kernels in
interpret mode (as tests/test_torch_train_kernel.py runs them) at S = 384,
and, marked slow, 512 and 1024 (2048 for the forward). The Pallas kernels
bound S by nothing but S % 128 == 0; the CUDA kernels now take the same
range, and the card holds them against these plain versions (chip_smoke.py
phase 12). Also the chunk plan of K1 and K4 full (`render_chunks`), a pure
function of (n_rays, S, D).

Inputs come from a numpy seed: 8 rays at hidden width 128. Tolerances, the
bf16 class of PERF.md section 2: values 2e-3 (relative for the loss sums,
x max(1, max|ref|) for the forward's outputs); each weight and bias gradient
block 2e-2 x its largest entry (+1e-6): both sides round the same cotangents
to bf16 before every product, but sum the f32 products in another order, so
a rounding flips now and then and travels down that sample's chain. The
per-sample blocks, d(rays) and dz, 5e-2: there nothing averages a flip away,
the encoding derivative multiplies it by up to 2^9, and a ray of S samples
has S chains in which one can flip.
"""

import math

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
N_RAYS = 8
SAMPLES = [384, pytest.param(512, marks=pytest.mark.slow),
           pytest.param(1024, marks=pytest.mark.slow)]
# (occupancy activation, head and renderer dist_alpha, rgb_p, white_bg)
FLAGS = [("softplus", False, 1, False), ("relu", True, 2, True)]
PER_SAMPLE = 5e-2       # the tolerance of d(rays) and dz (see above)


def _inputs(S, seed, occ, dist_alpha, white):
    """Seeded params, rays, z and targets. Occupancy without dist_alpha is per
    sample: its density bias drops by 3 + log(S / 128), so that the weights
    spread over the whole ray at every S (see tests/test_torch_train_kernel.py)."""
    rng = np.random.default_rng(seed)
    jp = init_nerf_params(jax.random.key(seed), JNerfConfig(hidden_dim=HIDDEN,
                                                            white_background=white))
    if occ == "softplus" and not dist_alpha:
        jp = dict(jp, density_b=jp["density_b"] - 3.0 - math.log(S / 128))
    o = rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.5
    v = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(N_RAYS, S)).astype(np.float32), axis=1)
    rgb_gt = rng.uniform(0, 1, size=(N_RAYS, 3)).astype(np.float32)
    depth_gt = rng.uniform(1.0, 5.0, size=(N_RAYS,)).astype(np.float32)
    mask = (np.arange(N_RAYS) % 3) != 0
    return jp, o, v, z, rgb_gt, depth_gt, mask


def _configs(occ, dist_alpha, white):
    kw = dict(hidden_dim=HIDDEN, use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha,
              white_background=white)
    return JNerfConfig(**kw), NerfConfig(**kw)


def _port(jp, o, v, z):
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    return tp, rays, torch.from_numpy(z)


def _assert_block(name, got, ref, rel=2e-2):
    tol = rel * float(np.max(np.abs(ref))) + 1e-6
    err = float(np.max(np.abs(got - ref)))
    assert got.shape == ref.shape, name
    assert err <= tol, f"{name}: err {err} > {tol}"


def _assert_values(name, got, ref):
    ref = np.asarray(ref)
    tol = 2e-3 * max(1.0, float(np.abs(ref).max()))
    assert float(np.max(np.abs(np.asarray(got) - ref))) <= tol, name


@pytest.mark.parametrize("flags", FLAGS, ids=["softplus", "relu-dist_alpha"])
@pytest.mark.parametrize("S", SAMPLES)
def test_train_plain_matches_pallas_train_kernel(S, flags):
    """K1: loss sums and every gradient (params, rays, z, targets)."""
    occ, dist_alpha, rgb_p, white = flags
    jp, o, v, z, rgb_gt, depth_gt, mask = _inputs(S, 0, occ, dist_alpha, white)
    jc, tc = _configs(occ, dist_alpha, white)
    w_rgb, w_depth = 0.7 / N_RAYS, 0.3 / max(int(mask.sum()), 1)
    rays_j = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    tgt_j = jpr.pack_targets(jnp.asarray(rgb_gt), jnp.asarray(depth_gt), jnp.asarray(mask),
                             jnp.asarray(w_rgb), jnp.asarray(w_depth))

    def loss(p, r, zz, t):
        return jpr.render_ray_loss_fused(p, r, zz, t, jc, dist_alpha, rgb_p, white)

    with pltpu.force_tpu_interpret_mode():
        (total_j, sums_j), (gp, gr, gz, gt) = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True)(jp, rays_j, jnp.asarray(z), tgt_j)

    tp, rays, zt = _port(jp, o, v, z)
    tgt = F.pack_targets(torch.from_numpy(rgb_gt), torch.from_numpy(depth_gt),
                         torch.from_numpy(mask), w_rgb, w_depth)
    total, sums, grads = F.render_ray_loss_fused_plain(tp, rays, zt, tgt, tc, dist_alpha, rgb_p,
                                                       white)
    np.testing.assert_allclose(float(total), float(total_j), rtol=2e-3)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=2e-3)
    assert set(grads["params"]) == set(gp)
    for k in sorted(gp):
        _assert_block(k, grads["params"][k].numpy(), np.asarray(gp[k]))
    _assert_block("rays", grads["rays"].numpy(), np.asarray(gr)[:, :9], PER_SAMPLE)
    _assert_block("z", grads["z"].numpy(), np.asarray(gz), PER_SAMPLE)
    _assert_block("tgt", grads["tgt"].numpy(), np.asarray(gt)[:, :7])


@pytest.mark.parametrize("flags", FLAGS, ids=["softplus", "relu-dist_alpha"])
@pytest.mark.parametrize("S", SAMPLES)
def test_bwd_plain_matches_pallas_bwd_kernel(S, flags):
    """K3's outputs and K4, the VJP of render_rays_fused, at the cotangents of a
    smooth loss of the forward's own outputs (an L2 colour and depth term, the
    squared weights of every 7th sample, one column of alpha)."""
    occ, dist_alpha, _, _ = flags
    jp, o, v, z, rgb_gt, depth_gt, _ = _inputs(S, 1, occ, dist_alpha, False)
    jc, tc = _configs(occ, dist_alpha, False)
    rays_j = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    with pltpu.force_tpu_interpret_mode():
        out_j, vjp = jax.vjp(lambda p, r, zz: jpr.render_rays_fused(p, r, zz, jc, dist_alpha),
                             jp, rays_j, jnp.asarray(z))
        rgb, dist, weights, alpha = (np.asarray(a) for a in out_j)
        g_w = np.zeros_like(weights)
        g_w[:, ::7] = 2.0 / N_RAYS * weights[:, ::7]
        g_a = np.zeros_like(alpha)
        g_a[:, 5] = 1.0 / N_RAYS
        cot = ((1.4 / N_RAYS * (rgb - rgb_gt)).astype(np.float32),
               (0.6 / N_RAYS * (dist - depth_gt)).astype(np.float32), g_w, g_a)
        gp, gr, gz = vjp(tuple(jnp.asarray(c) for c in cot))

    tp, rays, zt = _port(jp, o, v, z)
    out = F.render_rays_fused_plain(tp, rays, zt, tc, dist_alpha, want_aux=True)
    for name, g, r in zip(("rgb", "dist", "weights", "alpha"), out, out_j):
        _assert_values(name, g.numpy(), r)
    dWs, dBs, drays, dz = F.render_rays_fused_bwd_plain(
        tp, rays, zt, *(torch.from_numpy(c) for c in cot), tc, dist_alpha)
    grads = F.unpack_grads(dWs, dBs, tc)
    assert set(grads) == set(gp)
    for k in sorted(gp):
        _assert_block(k, grads[k].numpy(), np.asarray(gp[k]))
    _assert_block("rays", drays.numpy(), np.asarray(gr)[:, :9], PER_SAMPLE)
    _assert_block("z", dz.numpy(), np.asarray(gz), PER_SAMPLE)


@pytest.mark.slow
@pytest.mark.parametrize("flags", FLAGS, ids=["softplus", "relu-dist_alpha"])
def test_forward_plain_matches_pallas_forward_kernel_at_2048(flags):
    """K3 alone at 2048 samples, the frame render's FRAME_POINTS on the card."""
    occ, dist_alpha, _, _ = flags
    jp, o, v, z, _, _, _ = _inputs(2048, 2, occ, dist_alpha, False)
    jc, tc = _configs(occ, dist_alpha, False)
    rays_j = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    with pltpu.force_tpu_interpret_mode():
        out_j = jpr.render_rays_fused(jp, rays_j, jnp.asarray(z), jc, dist_alpha)
    tp, rays, zt = _port(jp, o, v, z)
    out = F.render_rays_fused_plain(tp, rays, zt, tc, dist_alpha, want_aux=True)
    for name, g, r in zip(("rgb", "dist", "weights", "alpha"), out, out_j):
        _assert_values(name, g.numpy(), r)


# ---- the chunk plan of K1 and K4 full -------------------------------------------------

@pytest.mark.parametrize("D", [256, 128])
@pytest.mark.parametrize("n_rays", [1, 133, 1024])
@pytest.mark.parametrize("S", [128, 256])
def test_one_chunk_up_to_the_parents_largest_call(S, n_rays, D):
    """Every call up to 1024 rays x 256 samples at D = 256 (2.52 GB of dW
    operands, the budget) is one chunk: one launch of the chain, bit for bit
    the kernels' single-chunk results."""
    assert F.render_chunks(n_rays, S, D) == [(0, n_rays)]


def test_the_budget_is_the_parents_largest_call():
    assert F.OPERAND_BUDGET_BYTES == sum(F.render_operand_bytes(256, 1024, 256))
    assert F.OPERAND_BUDGET_BYTES == 1024 * 256 * 9600
    assert F.render_chunks(1025, 256, 256) == [(0, 513), (513, 1025)]


@pytest.mark.parametrize("D", [256, 128])
@pytest.mark.parametrize("S", [384, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("n_rays", [1, 7, 133, 1000, 1024, 4099])
def test_chunks_cover_the_rays_in_order_within_the_budget(n_rays, S, D):
    """Consecutive chunks from ray 0 to the last, none empty, all of one size
    but the last (which takes the rest), each within the budget unless a single
    ray exceeds it, and no more chunks than the budget needs."""
    chunks = F.render_chunks(n_rays, S, D)
    assert chunks[0][0] == 0 and chunks[-1][1] == n_rays
    assert all(a < b for a, b in chunks)
    assert all(chunks[i][1] == chunks[i + 1][0] for i in range(len(chunks) - 1))
    sizes = [b - a for a, b in chunks]
    assert all(s == sizes[0] for s in sizes[:-1]) and sizes[-1] <= sizes[0]
    per_ray = sum(F.render_operand_bytes(D, 1, S))
    assert all(sum(F.render_operand_bytes(D, s, S)) <= F.OPERAND_BUDGET_BYTES or s == 1
               for s in sizes)
    fit = max(1, F.OPERAND_BUDGET_BYTES // per_ray)
    assert len(chunks) == -(-n_rays // fit)


def test_chunks_at_the_main_paths_shapes():
    """The 512-sample path: two chunks of 512 rays; the 2048-sample step: eight
    of 128 (D = 256). At D = 128 a sample's operands are 4,864 B, about half,
    so 1010 rays fit at 512 samples and 252 at 2048."""
    assert F.render_chunks(1024, 512, 256) == [(0, 512), (512, 1024)]
    assert F.render_chunks(1024, 2048, 256) == [(128 * i, 128 * (i + 1)) for i in range(8)]
    assert sum(F.render_operand_bytes(128, 1, 128)) == 4864 * 128
    assert F.render_chunks(1024, 512, 128) == [(0, 512), (512, 1024)]
    assert F.render_chunks(1024, 2048, 128) == [(205 * i, min(205 * (i + 1), 1024))
                                                for i in range(5)]


@pytest.mark.parametrize("S", [100, 200, 0])
def test_every_kernel_refuses_an_s_the_tpu_kernels_refuse(S):
    """S % 128 != 0 raises NotImplementedError before any device work, as does a
    width no kernel is built for (1152); any S % 128 == 0 passes the check, at
    every width the kernels take (512 included, for the backward kernels too)."""
    for kernel in ("render", "train", "render-backward"):
        with pytest.raises(NotImplementedError, match="S % 128"):
            F._check_kernel_shapes(kernel, S, 256)
        with pytest.raises(NotImplementedError, match="hidden_dim"):
            F._check_kernel_shapes(kernel, 384, 1152)
        for ok in (128, 384, 2048, 8192):
            F._check_kernel_shapes(kernel, ok, 128)
        F._check_kernel_shapes(kernel, 384, 512)
