"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither JAX nor nope_nerf_tpu, so it also runs on a machine
that has only PyTorch; there the repository's conftest.py (which imports JAX)
is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances. Forward values: 2e-3 x max(1, max|plain|): the kernel and the plain
version sum the same bf16 products in another order (see chip_smoke.tolerance).
The train and backward kernels' gradients: 5e-3 of each weight block's largest entry; for
d(rays) and dz, per ray and per sample, an L2 error within 2e-2 of the block's
norm with at most 1 entry in 1000 off by more than 2e-2 of the largest: a
flipped bf16 rounding or ReLU mask travels down one point's chain and nothing
averages it away there (chip_smoke.grad_share). The Chamfer sweep: matched distances within
2^-10 relative, since 13 of d2's 23 mantissa bits are masked.
"""

import numpy as np
import pytest
import torch

from nope_nerf_torch.config import load_config
from nope_nerf_torch.data import SceneData, batch_for_frame, make_synthetic_scene
from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
from nope_nerf_torch.ops import chamfer as C
from nope_nerf_torch.ops import fused_mlp as M
from nope_nerf_torch.ops import fused_render as F
from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(dev, n, S, seed=0, spread=3.0, far=8.1):
    gen = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    rays = F.pack_rays(torch.randn(n, 3, generator=gen) * spread, v, -v).to(dev)
    z = torch.sort(torch.rand(n, S, generator=gen) * (far - 0.1) + 0.1, dim=1).values.to(dev)
    return gen, rays, z


def _assert_close(got, ref):
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            assert torch.isfinite(g).all()
            assert float((g - r).abs().max()) <= 2e-3 * max(1.0, float(r.abs().max()))


# 384 and 512: the 64-point trunk of csrc/mlp_fwd_wide_sm90.cuh
@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
# 4096: z and the raw heads (D = 256) or the composite's arrays (D = 128) past shared
# memory; at D = 512 z and the raw heads from 768 samples on
@pytest.mark.parametrize("S", [128, 256, 1024, 2048, 4096])
@pytest.mark.parametrize("want_aux", [False, True])
def test_render_fwd_matches_plain(cuda_device, hidden, S, want_aux):
    gen, rays, z = _inputs(cuda_device, 301, S)          # 301: no tile multiple
    ncfg = NerfConfig(hidden_dim=hidden, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    got = F.render_rays_fused(params, rays, z, ncfg, False, want_aux)
    _assert_close(got, F.render_rays_fused_plain(params, rays, z, ncfg, False, want_aux))


@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_render_fwd_flags(cuda_device, occ, dist_alpha):
    gen, rays, z = _inputs(cuda_device, 64, 128, seed=1)
    ncfg = NerfConfig(occ_activation=occ, dist_alpha=dist_alpha, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    got = F.render_rays_fused(params, rays, z, ncfg, dist_alpha, True)
    _assert_close(got, F.render_rays_fused_plain(params, rays, z, ncfg, dist_alpha, True))


@pytest.mark.parametrize("n_rays", [1, 2, 133, 265])
def test_render_fwd_ray_counts_around_a_persistent_wave(cuda_device, n_rays):
    """The kernel launches at most one CTA per SM and each walks over the rays
    r, r + grid, ...: fewer rays than SMs, and counts just past one and two
    waves of the card's 132 SMs."""
    gen, rays, z = _inputs(cuda_device, n_rays, 128, seed=2)
    ncfg = NerfConfig(use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    got = F.render_rays_fused(params, rays, z, ncfg, False, True)
    _assert_close(got, F.render_rays_fused_plain(params, rays, z, ncfg, False, True))


def test_render_fwd_counts_launches_and_rejects_bad_inputs(cuda_device):
    gen, rays, z = _inputs(cuda_device, 8, 128)
    ncfg = NerfConfig(use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    before = F.RENDER_FWD.launches
    F.render_rays_fused(params, rays, z, ncfg)
    assert F.RENDER_FWD.launches == before + 1
    rgb, dist, _, _ = F.render_rays_fused(params, rays[:0], z[:0], ncfg)   # no launch
    assert rgb.shape == (0, 3) and dist.shape == (0,)
    with pytest.raises(NotImplementedError):
        F.render_rays_fused(params, rays, z[:, :100].contiguous(), ncfg)
    with pytest.raises(ValueError):
        F.render_rays_fused(params, rays, z.t().contiguous().t(), ncfg)
    assert F.RENDER_FWD.launches == before + 1


# ---- render_train (K1) -------------------------------------------------------

def _train_case(dev, n, S, hidden, seed=0, **flags):
    gen, rays, z = _inputs(dev, n, S, seed, flags.get("spread", 3.0), flags.get("far", 8.1))
    ncfg = NerfConfig(hidden_dim=hidden, use_pallas=True,
                      occ_activation=flags.get("occ", "softplus"),
                      dist_alpha=flags.get("dist_alpha", False))
    params = init_nerf_params(ncfg, gen, device=dev)
    # softplus opacity that is not scaled by the sample spacing saturates within a few
    # samples at the seeded bias: lower it, so that the weights spread over the ray
    if ncfg.occ_activation == "softplus" and not flags.get("render_dist_alpha", ncfg.dist_alpha):
        params["density_b"] = params["density_b"] - 4.0
    mask = (torch.arange(n) % 3 != 0).to(dev)
    tgt = F.pack_targets(torch.rand(n, 3, generator=gen).to(dev),
                         (1 + 4 * torch.rand(n, generator=gen)).to(dev), mask, 0.7 / n,
                         0.3 / max(float(mask.sum()), 1.0))       # one ray: an empty mask
    return params, rays, z, tgt, ncfg


def _assert_train_close(params, rays, z, tgt, ncfg, dist_alpha, rgb_p, white_bg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ins = [t.clone().requires_grad_(True) for t in (rays, z, tgt)]
    total, sums = F.render_ray_loss_fused(leaves, *ins, ncfg, dist_alpha, rgb_p, white_bg)
    total.backward()
    r_total, r_sums, r_grads = F.render_ray_loss_fused_plain(params, rays, z, tgt, ncfg,
                                                             dist_alpha, rgb_p, white_bg)
    assert abs(float(total) - float(r_total)) <= 2e-3 * abs(float(r_total))
    assert float(((sums - r_sums).abs() / r_sums.abs().clamp_min(1e-12)).max()) <= 2e-3
    got = dict({k: v.grad for k, v in leaves.items()}, rays=ins[0].grad, z=ins[1].grad,
               tgt=ins[2].grad)
    ref = dict(r_grads["params"], rays=r_grads["rays"], z=r_grads["z"], tgt=r_grads["tgt"])
    for k, r in ref.items():
        assert torch.isfinite(got[k]).all(), k
        err, top = (got[k] - r).abs(), float(r.abs().max())
        if k in ("rays", "z"):
            assert float(err.norm()) <= 2e-2 * float(r.norm()) + 1e-9, k
            assert float((err > 2e-2 * top + 1e-6).float().mean()) <= 1e-3, k
        else:
            assert float(err.max()) <= 5e-3 * top + 1e-6, k


@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("S", [128, 256, 384, 1024, 2048])
def test_render_train_matches_plain(cuda_device, hidden, S):
    args = _train_case(cuda_device, 301, S, hidden)          # 301: more rays than SMs, ragged
    _assert_train_close(*args, False, 1, False)


@pytest.mark.parametrize("white_bg", [False, True])
@pytest.mark.parametrize("rgb_p", [1, 2])
@pytest.mark.parametrize("dist_alpha", [False, True])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
def test_render_train_flags(cuda_device, occ, dist_alpha, rgb_p, white_bg):
    args = _train_case(cuda_device, 64, 128, 256, seed=1, occ=occ, dist_alpha=dist_alpha)
    _assert_train_close(*args, dist_alpha, rgb_p, white_bg)


def test_render_train_bit_equal_counts_launches_and_rejects_bad_inputs(cuda_device):
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 200, 128, 256)
    before = F.RENDER_TRAIN.launches
    a = F._train_cuda(params, rays, z, tgt, ncfg, False, 1, False)
    b = F._train_cuda(params, rays, z, tgt, ncfg, False, 1, False)
    assert F.RENDER_TRAIN.launches == before + 2
    for x, y in zip([a[0], *a[1], *a[2], *a[3:]], [b[0], *b[1], *b[2], *b[3:]]):
        assert torch.equal(x, y)
    with F.plain_versions():
        F.render_ray_loss_fused(params, rays, z, tgt, ncfg, False, 1, False)
    assert F.RENDER_TRAIN.launches == before + 2              # the plain route launches nothing
    with pytest.raises(NotImplementedError):
        F.render_ray_loss_fused(params, rays, z[:, :100].contiguous(), tgt, ncfg, False, 1, False)
    # 384 samples, three tiles a ray: it runs and matches the plain version
    big = torch.sort(torch.rand(200, 384, device=cuda_device) * 8 + 0.1, dim=1).values
    _assert_train_close(params, rays, big, tgt, ncfg, False, 1, False)
    with pytest.raises(ValueError):
        F.render_ray_loss_fused(params, rays, z.t().contiguous().t(), tgt, ncfg, False, 1, False)
    assert F.RENDER_TRAIN.launches == before + 3


# ---- render_bwd (K4) -------------------------------------------------------------

def _bwd_cotangents(params, rays, z, tgt, ncfg, dist_alpha, aux):
    """Cotangents of a smooth loss of the forward's own outputs (an L2 colour
    and depth term; with aux a sum of squared weights on every 7th sample and
    one column of alpha)."""
    rgb, dist, weights, alpha = F.render_rays_fused_plain(params, rays, z, ncfg, dist_alpha, True)
    n = rays.shape[0]
    g_rgb = (1.4 / n * (rgb - tgt[:, 0:3])).contiguous()
    g_dist = (0.6 / n * (dist - tgt[:, F.TGT_DEPTH])).contiguous()
    if not aux:
        return g_rgb, g_dist, None, None
    g_w = torch.zeros_like(weights)
    g_w[:, ::7] = 2.0 / n * weights[:, ::7]
    g_a = torch.zeros_like(alpha)
    g_a[:, 5] = 1.0 / n
    return g_rgb, g_dist, g_w, g_a


def _assert_grads_close(got, ref):
    for k, r in ref.items():
        assert torch.isfinite(got[k]).all(), k
        err, top = (got[k] - r).abs(), float(r.abs().max())
        if k in ("rays", "z"):
            assert float(err.norm()) <= 2e-2 * float(r.norm()) + 1e-9, k
            assert float((err > 2e-2 * top + 1e-6).float().mean()) <= 1e-3, k
        else:
            assert float(err.max()) <= 5e-3 * top + 1e-6, k


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("dist_alpha", [False, True])
@pytest.mark.parametrize("head_dist_alpha", [False, True])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
def test_render_bwd_flags(cuda_device, occ, head_dist_alpha, dist_alpha, aux):
    # rays from near the origin over [0.1, 6], the scale of a scene: bias gradients, which
    # no product averages, sit near their tolerance for rays scattered three times as far
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 301, 128, 256, seed=1, occ=occ,
                                             dist_alpha=head_dist_alpha,
                                             render_dist_alpha=dist_alpha, spread=0.5, far=6.0)
    cot = _bwd_cotangents(params, rays, z, tgt, ncfg, dist_alpha, aux)
    before = F.RENDER_BWD.launches
    runs = [F._render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha) for _ in range(2)]
    assert F.RENDER_BWD.launches == before + 2
    for a, b in zip([*runs[0][0], *runs[0][1], *runs[0][2:]], [*runs[1][0], *runs[1][1], *runs[1][2:]]):
        assert torch.equal(a, b)                         # no float atomics
    ref = F.render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, dist_alpha)
    _assert_grads_close(dict(F.unpack_grads(runs[0][0], runs[0][1], ncfg), rays=runs[0][2],
                             z=runs[0][3]),
                        dict(F.unpack_grads(ref[0], ref[1], ncfg), rays=ref[2], z=ref[3]))
    # the frozen-network variant: the same d(rays) and dz, no parameter gradients
    dWs, dBs, drays, dz = F._render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha,
                                             want_param_grads=False)
    assert dWs is None and dBs is None
    assert torch.equal(drays, runs[0][2]) and torch.equal(dz, runs[0][3])


@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("S", [128, 256])
def test_render_bwd_widths_and_train_kernel_cotangents(cuda_device, hidden, S):
    """Fed the cotangents the train kernel forms itself, the backward kernel
    returns the train kernel's gradients bit for bit: they share one chain."""
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 200, S, hidden)
    sums, dWs, dBs, drays, dz, dtgt = F._train_cuda(params, rays, z, tgt, ncfg, False, 2, False)
    got = F._render_bwd_cuda(params, rays, z, (-dtgt[:, 0:3]).contiguous(),
                             (-dtgt[:, 3]).contiguous(), None, None, ncfg, False)
    for a, b in zip([*dWs, *dBs, drays, dz], [*got[0], *got[1], got[2], got[3]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("dist_alpha", [False, True])
@pytest.mark.parametrize("head_dist_alpha", [False, True])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("hidden", [128, 256])
def test_render_bwd_frozen_variant(cuda_device, hidden, S, occ, head_dist_alpha, dist_alpha,
                                   aux):
    """K4's frozen-network variant (render_bwd_frozen.cu, the wgmma dX chain)
    gives the full variant's d(rays) and dz bit for bit, two launches give the
    same bits, and it is within the per-sample tolerance of the plain version.
    133 rays: one more than the card's SMs, so one CTA takes a second ray."""
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 133, S, hidden, seed=4, occ=occ,
                                             dist_alpha=head_dist_alpha,
                                             render_dist_alpha=dist_alpha, spread=0.5, far=6.0)
    cot = _bwd_cotangents(params, rays, z, tgt, ncfg, dist_alpha, aux)
    full = F._render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha)
    counts = (F.RENDER_BWD.launches, F.RENDER_BWD_FROZEN.launches)
    runs = [F._render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha, want_param_grads=False)
            for _ in range(2)]
    assert (F.RENDER_BWD.launches - counts[0], F.RENDER_BWD_FROZEN.launches - counts[1]) == (2, 2)
    for dWs, dBs, drays, dz in runs:
        assert dWs is None and dBs is None
        assert torch.equal(drays, full[2]) and torch.equal(dz, full[3])
    ref = F.render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, dist_alpha)
    _assert_grads_close(dict(rays=runs[0][2], z=runs[0][3]), dict(rays=ref[2], z=ref[3]))


@pytest.mark.parametrize("n_rays", [1, 133, 301])
@pytest.mark.parametrize("S", [128, 256, 1024, 2048])
@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
def test_render_bwd_full_dx_equals_the_frozen_variant(cuda_device, hidden, S, n_rays):
    """K4 full (render_full_sm90.cuh: the chain that also saves the operands
    of its dW products; at 384 and 512 its wide kernel on the 64-point
    chain) gives the frozen variant's d(rays) and dz bit for bit: the same
    dX chain and the same per-ray pieces. It launches the dW kernel once per
    chunk of rays (3 at 301 x 2048, D = 256), the frozen variant never. 1
    ray: one CTA; 133: one CTA takes a second ray; 301: three rays on some
    CTAs, two on the others."""
    params, rays, z, tgt, ncfg = _train_case(cuda_device, n_rays, S, hidden, seed=5, spread=0.5,
                                             far=6.0)
    cot = _bwd_cotangents(params, rays, z, tgt, ncfg, False, True)
    before = M.DW_SM90.launches
    full = F._render_bwd_cuda(params, rays, z, *cot, ncfg, False)
    chunks = len(F.render_chunks(n_rays, S, hidden))
    assert M.DW_SM90.launches == before + chunks
    frozen = F._render_bwd_cuda(params, rays, z, *cot, ncfg, False, want_param_grads=False)
    assert M.DW_SM90.launches == before + chunks
    assert torch.equal(full[2], frozen[2]) and torch.equal(full[3], frozen[3])
    assert all(torch.isfinite(t).all() for t in (*full[0], *full[1]))


def _flat(out):
    return [t for item in out for t in (item if isinstance(item, (list, tuple)) else [item])]


@pytest.mark.parametrize("kernel", ["render_train", "render_bwd"])
def test_render_full_kernels_bit_equal_and_launch_the_dw_kernel_once(cuda_device, kernel):
    """K1 and K4 full: two launches give the same bits (no float atomics in
    the chain, its partial sums or the dW kernel), and each launch of either
    launches the dW kernel once (render_dw_launches: its table fits one
    launch up to 512)."""
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 301, 256, 256, seed=6)
    assert M.render_dw_launches(256) == 1
    if kernel == "render_train":
        lib = F.RENDER_TRAIN
        run = lambda: F._train_cuda(params, rays, z, tgt, ncfg, False, 2, True)   # noqa: E731
    else:
        lib = F.RENDER_BWD
        cot = _bwd_cotangents(params, rays, z, tgt, ncfg, False, True)
        run = lambda: F._render_bwd_cuda(params, rays, z, *cot, ncfg, False)    # noqa: E731
    before = (lib.launches, M.DW_SM90.launches)
    a, b = run(), run()
    assert (lib.launches - before[0], M.DW_SM90.launches - before[1]) == (2, 2)
    for x, y in zip(_flat(a), _flat(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kernel", ["render_train", "render_bwd"])
@pytest.mark.parametrize("hidden", [384, 512, 640, 1024])
def test_render_full_wide(cuda_device, hidden, kernel):
    """K1 and K4 full at 384 and 512 (render_full_sm90.cuh's wide kernel)
    and 640 and 1024 (its xwide kernel, in two chunks of rays): two launches
    bit-equal, the chain launched once a chunk of rays and the dW kernel
    render_dw_launches times a chunk (once up to 512, twice past it), K4 full
    fed K1's cotangents giving K1's dW, dB, d(rays) and dz bit for bit, and
    dW, dB within 5e-3 of each block's largest entry of the plain version's
    on the train step's 1024 rays."""
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 1024, 128, hidden, seed=11,
                                             spread=0.5, far=6.0)
    if kernel == "render_train":
        lib = F.RENDER_TRAIN
        run = lambda: F._train_cuda(params, rays, z, tgt, ncfg, False, 1, False)   # noqa: E731
    else:
        lib = F.RENDER_BWD
        cot = _bwd_cotangents(params, rays, z, tgt, ncfg, False, True)
        run = lambda: F._render_bwd_cuda(params, rays, z, *cot, ncfg, False)    # noqa: E731
    before = (lib.launches, M.DW_SM90.launches)
    a, b = run(), run()
    chunks = len(F.render_chunks(1024, 128, hidden))
    assert chunks == (2 if hidden > 512 else 1)
    assert (lib.launches - before[0], M.DW_SM90.launches - before[1]) == (
        2 * chunks, 2 * chunks * M.render_dw_launches(hidden))
    for x, y in zip(_flat(a), _flat(b)):
        assert torch.equal(x, y)
    if kernel == "render_train":
        fed = F._render_bwd_cuda(params, rays, z, (-a[5][:, 0:3]).contiguous(),
                                 (-a[5][:, 3]).contiguous(), None, None, ncfg, False)
        for x, y in zip(_flat(fed), _flat(a[1:5])):
            assert torch.equal(x, y)
        ref = F._train_plain(params, rays, z, tgt, ncfg, False, 1, False)[1:3]
        got = a[1:3]
    else:
        ref = F.render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, False)[:2]
        got = a[:2]
    for x, y in zip(_flat(got), _flat(ref)):
        assert float((x - y).abs().max()) <= 5e-3 * float(y.abs().max()) + 1e-6


@pytest.mark.parametrize("hidden", [128, 256])
def test_render_full_narrow_relu_dist_alpha(cuda_device, hidden):
    """K1 and K4 full at 128 and 256 on the train step's 1024 rays x 128, relu
    with dist_alpha (the second flag set of chip_smoke.py's phases 13 and 14,
    whose seeded weights, unshifted on this set, put most of a ray's weight on
    its forced last sample): every dW and dB block within 5e-3 of its largest
    entry of the plain version's; K4 full's d(rays) and dz torch.equal to the
    frozen-network variant's (I1); K4 full fed K1's cotangents gives K1's dW,
    dB, d(rays) and dz bit for bit (I2)."""
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 1024, 128, hidden, seed=13, occ="relu",
                                             dist_alpha=True, render_dist_alpha=True,
                                             spread=0.5, far=6.0)
    k1 = F._train_cuda(params, rays, z, tgt, ncfg, True, 2, False)
    fed = F._render_bwd_cuda(params, rays, z, (-k1[5][:, 0:3]).contiguous(),
                             (-k1[5][:, 3]).contiguous(), None, None, ncfg, True)
    for x, y in zip(_flat(fed), _flat(k1[1:5])):
        assert torch.equal(x, y)
    cot = _bwd_cotangents(params, rays, z, tgt, ncfg, True, True)
    k4 = F._render_bwd_cuda(params, rays, z, *cot, ncfg, True)
    frozen = F._render_bwd_cuda(params, rays, z, *cot, ncfg, True, want_param_grads=False)
    assert torch.equal(frozen[2], k4[2]) and torch.equal(frozen[3], k4[3])
    ref1 = F._train_plain(params, rays, z, tgt, ncfg, True, 2, False)
    ref4 = F.render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, True)
    for got, ref in ((k1[1:3], ref1[1:3]), (k4[:2], ref4[:2])):
        for x, y in zip(_flat(got), _flat(ref)):
            assert float((x - y).abs().max()) <= 5e-3 * float(y.abs().max()) + 1e-6


@pytest.mark.parametrize("kernel", ["train", "bwd"])
def test_render_full_kernels_in_chunks_of_rays(cuda_device, kernel):
    """With the operand budget cut to 80 rays, 301 rays go through K1 or K4 full
    in 4 chunks (76, 76, 76, 73): each launch counts 4 of the chain kernel and
    of the dW kernel, two launches bit-equal, the per-ray outputs bit-equal to
    one chunk's, dW and dB (summed over the chunks in order) within the weight
    gradients' tolerance of one chunk's."""
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 301, 256, 256, seed=6, spread=0.5,
                                             far=6.0)
    if kernel == "train":
        def run():
            sums, dWs, dBs, drays, dz, dtgt = F._train_cuda(params, rays, z, tgt, ncfg, False, 1,
                                                            False)
            return [sums, *dWs, *dBs], [drays, dz, dtgt]
    else:
        cot = _bwd_cotangents(params, rays, z, tgt, ncfg, False, True)

        def run():
            dWs, dBs, drays, dz = F._render_bwd_cuda(params, rays, z, *cot, ncfg, False)
            return [*dWs, *dBs], [drays, dz]
    one = run()
    saved = F.OPERAND_BUDGET_BYTES
    F.OPERAND_BUDGET_BYTES = sum(F.render_operand_bytes(ncfg.hidden_dim, 80, 256))
    try:
        assert [b - a for a, b in F.render_chunks(301, 256, 256)] == [76, 76, 76, 73]
        lib = F.RENDER_TRAIN if kernel == "train" else F.RENDER_BWD
        before = (lib.launches, M.DW_SM90.launches)
        a, b = run(), run()
        assert (lib.launches - before[0], M.DW_SM90.launches - before[1]) == (8, 8)
    finally:
        F.OPERAND_BUDGET_BYTES = saved
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)
    for x, y in zip(a[1], one[1]):
        assert torch.equal(x, y)
    for x, y in zip(a[0], one[0]):
        assert float((x - y).abs().max()) <= 5e-3 * float(y.abs().max()) + 1e-6


def test_render_rays_fused_differentiates_on_card(cuda_device):
    """Under grad the wrapper launches the forward kernel, then the backward
    kernel: it raises nothing, and its gradients match the plain route's."""
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 301, 128, 256, spread=0.5, far=6.0)

    def grads(frozen, z=z):
        leaves = {k: v.clone().requires_grad_(not frozen) for k, v in params.items()}
        r, zz = rays.clone().requires_grad_(True), z.clone().requires_grad_(True)
        rgb, dist, w, a = F.render_rays_fused(leaves, r, zz, ncfg, False, want_aux=True)
        loss = (((rgb - tgt[:, 0:3]) ** 2).mean() + ((dist - tgt[:, 3]) ** 2).mean()
                + (w[:, ::7] ** 2).sum(dim=1).mean() + a[:, 5].mean())
        loss.backward()
        out = dict(rays=r.grad, z=zz.grad)
        if not frozen:
            out.update({k: v.grad for k, v in leaves.items()})
        return out

    counts = [lib.launches for lib in (F.RENDER_FWD, F.RENDER_BWD, F.RENDER_TRAIN)]
    got = grads(False)
    after = [lib.launches for lib in (F.RENDER_FWD, F.RENDER_BWD, F.RENDER_TRAIN)]
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 0]
    with F.plain_versions():
        plain = grads(False)
    _assert_grads_close(got, plain)
    assert [lib.launches for lib in (F.RENDER_FWD, F.RENDER_BWD, F.RENDER_TRAIN)] == after
    frozen = grads(True)                   # the frozen-network variant
    assert torch.equal(frozen["rays"], got["rays"]) and torch.equal(frozen["z"], got["z"])
    with torch.no_grad():
        out = F.render_rays_fused({k: v.clone().requires_grad_(True) for k, v in params.items()},
                                  rays, z, ncfg)
    assert all(t.grad_fn is None for t in out)
    assert F.RENDER_BWD.launches == after[1] + 1
    # 384 samples, three tiles a ray: the kernels' gradients match the plain route's;
    # S % 128 != 0 raises before any launch
    z384 = torch.sort(torch.rand(301, 384, device=cuda_device) * 5.9 + 0.1, dim=1).values
    got = grads(False, z384)
    with F.plain_versions():
        plain = grads(False, z384)
    _assert_grads_close(got, plain)
    before = [lib.launches for lib in (F.RENDER_FWD, F.RENDER_BWD)]
    with pytest.raises(NotImplementedError):
        F.render_rays_fused(params, rays.clone().requires_grad_(True),
                            torch.sort(torch.rand(301, 100, device=cuda_device), dim=1).values, ncfg)
    assert [lib.launches for lib in (F.RENDER_FWD, F.RENDER_BWD)] == before


def test_render_nope_nerf_gradients_on_card(cuda_device):
    """render_nope_nerf's gradients w.r.t. the nerf params and the world matrix
    (where the pose gradient flows), kernel route against the plain route,
    with a white background."""
    from nope_nerf_torch.geometry.camera import camera_matrix_from_focal, pixel_grid_on
    from nope_nerf_torch.ops.render import RenderConfig, render_nope_nerf
    gen = torch.Generator().manual_seed(2)
    ncfg = NerfConfig(use_pallas=True, white_background=True)
    rcfg = RenderConfig(white_background=True, depth_range=(0.1, 6.0))
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    params["density_b"] = params["density_b"] - 4.0
    pixels = pixel_grid_on((16, 24), cuda_device)
    prior = (1 + 3 * torch.rand(pixels.shape[0], 1, generator=gen)).to(cuda_device)
    cam = camera_matrix_from_focal(torch.tensor(1.2), torch.tensor(1.4)).to(cuda_device)
    gt = torch.rand(pixels.shape[0], 3, generator=gen).to(cuda_device)

    def grads():
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        world = torch.eye(4, device=cuda_device).requires_grad_(True)
        out = render_nope_nerf(leaves, pixels, prior, cam, world, None, None, rcfg, ncfg,
                               add_noise=False)
        (((out["rgb"] - gt) ** 2).mean() + 0.1 * (out["depth_pred"] - out["depth_gt"]).abs().mean()
         ).backward()
        return dict({k: v.grad for k, v in leaves.items()}), world.grad

    gp, gw = grads()
    with F.plain_versions():
        rp, rw = grads()
    _assert_grads_close(gp, rp)
    assert float((gw - rw).abs().max()) <= 5e-2 * float(rw.abs().max())


def test_resume_is_bit_equal_on_card(cuda_device, tmp_path):
    """2 epochs straight against 1 + checkpoint + resume + 1 at the full model
    width: every kernel is deterministic, so parameters, Adam's moments and
    the generator's state are bit-equal."""
    from nope_nerf_torch.cli.train import train

    def cfg_for(out):
        return load_config(overrides={
            "training": {"out_dir": str(out), "n_training_points": 256, "vis_geo": False,
                         "print_every": 0, "checkpoint_every": 1, "visualize_every": 0,
                         "vis_reprojection_every": 0, "backup_every": 0},
            "pose": {"learn_pose": True, "init_pose": True}})

    state_a, _, _ = train(cfg_for(tmp_path / "a"), synthetic=True, max_epochs=2,
                          device=cuda_device)
    train(cfg_for(tmp_path / "b"), synthetic=True, max_epochs=1, device=cuda_device)
    state_b, _, _ = train(cfg_for(tmp_path / "b"), synthetic=True, max_epochs=2,
                          device=cuda_device)
    assert state_a.it == state_b.it == 15
    for g, d in state_a.params.items():
        for k, v in d.items():
            assert torch.equal(v, state_b.params[g][k]), (g, k)
            assert torch.equal(state_a.opt_state[g].mu[k], state_b.opt_state[g].mu[k]), (g, k)
            assert torch.equal(state_a.opt_state[g].nu[k], state_b.opt_state[g].nu[k]), (g, k)
    assert torch.equal(state_a.generator.get_state(), state_b.generator.get_state())


# ---- chamfer_bidir (K2) ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(7285, 7285), (8192, 1), (301, 77), (5, 4000)])
def test_chamfer_matches_plain_by_distance(cuda_device, shape):
    gen = torch.Generator().manual_seed(shape[0])
    x = (torch.rand(shape[0], 3, generator=gen) * 6 - 3).to(cuda_device)
    y = (torch.rand(shape[1], 3, generator=gen) * 6 - 3).to(cuda_device)
    before = C.CHAMFER_BIDIR.launches
    got = C.nearest_idx_bidirectional(x, y)
    assert C.CHAMFER_BIDIR.launches == before + 1
    ref = C.nearest_idx_bidirectional_plain(x, y)
    for ig, ir, src, dst in ((got[0], ref[0], x, y), (got[1], ref[1], y, x)):
        assert ig.dtype == torch.int64 and ig.shape == ir.shape
        assert int(ig.min()) >= 0 and int(ig.max()) < dst.shape[0]
        d_g, d_r = (src - dst[ig]).norm(dim=1), (src - dst[ir]).norm(dim=1)
        assert bool(((d_g - d_r).abs() <= 2.0 ** -10 * d_r + 1e-6).all())


def test_chamfer_loss_gradients_and_cloud_limit(cuda_device):
    gen = torch.Generator().manual_seed(3)
    side = torch.arange(12.0)
    lattice = torch.stack(torch.meshgrid(side, side, side, indexing="ij"), -1).reshape(-1, 3)
    x = (lattice + 0.1 * (torch.rand(lattice.shape, generator=gen) - 0.5)).to(cuda_device)
    y = (lattice.flip(0) + 0.1 * (torch.rand(lattice.shape, generator=gen) - 0.5)).to(cuda_device)
    got = C.nearest_idx_bidirectional(x, y)
    ref = C.nearest_idx_bidirectional_plain(x, y)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])    # no near-ties
    xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    C.chamfer_loss(xg, yg).backward()
    xp, yp = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    with F.plain_versions():
        C.chamfer_loss(xp, yp).backward()
    assert torch.equal(xg.grad, xp.grad) and torch.equal(yg.grad, yp.grad)
    with pytest.raises(NotImplementedError, match="8192"):
        C.nearest_idx_bidirectional(torch.zeros(8193, 3, device=cuda_device), y)


# ---- chamfer_nearest (K7) -------------------------------------------------------

@pytest.mark.parametrize("shape", [(9000, 9100), (301, 77), (5, 40000), (1, 1)])
def test_chamfer_nearest_is_bit_equal_to_plain(cuda_device, shape):
    gen = torch.Generator().manual_seed(shape[1])
    x = (torch.rand(shape[0], 3, generator=gen) * 6 - 3).to(cuda_device)
    y = (torch.rand(shape[1], 3, generator=gen) * 6 - 3).to(cuda_device)
    before = C.CHAMFER_NEAREST.launches
    d2, idx = C.nearest_idx(x, y)
    assert C.CHAMFER_NEAREST.launches == before + 1
    d2_p, idx_p = C.nearest_idx_plain(x, y)
    assert idx.dtype == torch.int64 and d2.dtype == torch.float32
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)


@pytest.mark.parametrize("shape", [(9000, 9100), (47628, 47628), (300, 40000), (5, 40000)])
def test_chamfer_nearest_segment_edge_duplicates(cuda_device, shape):
    """The dst point before every segment edge of K7's grid is copied onto the
    one after it and a src point sits 1e-3 from the pair: the merge must keep
    the earlier segment's copy, as the plain version's strict < does."""
    gen = torch.Generator().manual_seed(shape[0] + 1)
    x = torch.rand(shape[0], 3, generator=gen) * 6 - 3
    y = torch.rand(shape[1], 3, generator=gen) * 6 - 3
    seg = C.nearest_geometry(*shape).seg_len
    edges = torch.arange(seg, shape[1], seg)[:shape[0]]
    y[edges] = y[edges - 1]
    x[:len(edges)] = y[edges] + torch.tensor([1e-3, 0.0, 0.0])
    x, y = x.to(cuda_device), y.to(cuda_device)
    d2, idx = C.nearest_idx(x, y)
    d2_p, idx_p = C.nearest_idx_plain(x, y)
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    assert torch.equal(idx[:len(edges)].cpu(), edges - 1)


@pytest.mark.parametrize("shape", [(47628, 47628), (5, 40000), (301, 77)])
def test_chamfer_nearest_two_launches_bit_equal(cuda_device, shape):
    gen = torch.Generator().manual_seed(shape[0] + 2)
    x = (torch.rand(shape[0], 3, generator=gen) * 6 - 3).to(cuda_device)
    y = (torch.rand(shape[1], 3, generator=gen) * 6 - 3).to(cuda_device)
    a, b = C.nearest_idx(x, y), C.nearest_idx(x, y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("shape", [(7285, 7285), (8192, 8192), (301, 77)])
def test_chamfer_bidir_two_launches_bit_equal(cuda_device, shape):
    gen = torch.Generator().manual_seed(shape[0] + 3)
    x = (torch.rand(shape[0], 3, generator=gen) * 6 - 3).to(cuda_device)
    y = (torch.rand(shape[1], 3, generator=gen) * 6 - 3).to(cuda_device)
    before = C.CHAMFER_BIDIR.launches
    a, b = C.nearest_idx_bidirectional(x, y), C.nearest_idx_bidirectional(x, y)
    assert C.CHAMFER_BIDIR.launches == before + 2
    for u, v in zip(a, b):
        assert u.dtype == torch.int64 and torch.equal(u, v)


@pytest.mark.parametrize("n_side", [9, 18, 20])
def test_chamfer_bidir_lattice_indices_equal_plain(cuda_device, n_side):
    """Without near-ties the packed keys leave one winner: indices equal."""
    gen = torch.Generator().manual_seed(n_side)
    side = torch.arange(float(n_side))
    lattice = torch.stack(torch.meshgrid(side, side, side, indexing="ij"), -1).reshape(-1, 3)
    x = (lattice + 0.1 * (torch.rand(lattice.shape, generator=gen) - 0.5)).to(cuda_device)
    y = (lattice[torch.randperm(len(lattice), generator=gen)]
         + 0.1 * (torch.rand(lattice.shape, generator=gen) - 0.5)).to(cuda_device)
    got, ref = C.nearest_idx_bidirectional(x, y), C.nearest_idx_bidirectional_plain(x, y)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_chamfer_loss_above_the_gate_launches_k7_twice(cuda_device):
    gen = torch.Generator().manual_seed(4)
    x = (torch.rand(C.MAX_POINTS + 100, 3, generator=gen) * 20).to(cuda_device)
    y = (torch.rand(C.MAX_POINTS + 7, 3, generator=gen) * 20).to(cuda_device)
    k2, k7 = C.CHAMFER_BIDIR.launches, C.CHAMFER_NEAREST.launches
    xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    loss = C.chamfer_loss(xg, yg)
    loss.backward()
    assert (C.CHAMFER_BIDIR.launches - k2, C.CHAMFER_NEAREST.launches - k7) == (0, 2)
    xp, yp = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    with F.plain_versions():
        loss_p = C.chamfer_loss(xp, yp)
        loss_p.backward()
    assert C.CHAMFER_NEAREST.launches - k7 == 2
    # the same indices, so the same gather tail: equal up to index_add's atomic order
    assert torch.equal(loss.detach(), loss_p.detach())
    for g, p in ((xg.grad, xp.grad), (yg.grad, yp.grad)):
        assert float((g - p).abs().max()) <= 1e-6 * float(p.abs().max())
    w = torch.rand(x.shape[0], generator=gen).to(cuda_device)
    xs, ys = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    (w * C.nearest_dists(xs, ys)).sum().backward()
    assert torch.isfinite(xs.grad).all() and torch.isfinite(ys.grad).all()


# ---- the train step on the card -------------------------------------------------

def test_train_step_on_card_counts_launches_fused_and_not(cuda_device):
    cfg = load_config(overrides={"training": {"n_training_points": 256},
                                 "pose": {"learn_pose": True, "init_pose": True}})
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=48, w=64)).to_device(cuda_device)
    mc = ModelConfigs.from_cfg(cfg, 4)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device=cuda_device)
    trainer = Trainer(cfg, mc)
    counts = [lib.launches for lib in (F.RENDER_TRAIN, C.CHAMFER_BIDIR, F.RENDER_FWD)]
    state, lds = trainer.run_steps(state, scene, np.array([0, 3, 1]), np.array([1, 2, 2]),
                                   epoch=0, scheduling_start=10000)
    after = [lib.launches for lib in (F.RENDER_TRAIN, C.CHAMFER_BIDIR, F.RENDER_FWD)]
    assert [a - b for a, b in zip(after, counts)] == [3, 3, 0]
    assert all(torch.isfinite(v).all() for v in lds.values()) and state.it == 2

    # outside the fused-loss gate the step renders through the forward and backward kernels
    cfg["training"]["depth_loss_type"] = "invariant"
    mc_inv = ModelConfigs.from_cfg(cfg, 4)
    libs = (F.RENDER_TRAIN, C.CHAMFER_BIDIR, F.RENDER_FWD, F.RENDER_BWD)
    counts = [lib.launches for lib in libs]
    state, ld = Trainer(cfg, mc_inv).step(state, batch_for_frame(scene, 0, ref_idx=1), 0, 10000)
    assert [lib.launches - c for lib, c in zip(libs, counts)] == [0, 1, 1, 1]
    assert all(torch.isfinite(v).all() for v in ld.values()) and float(ld["loss_depth"]) > 0

    # the configs the fused render cannot serve take a step through the point-query
    # MLP kernels (num_points 100: one K5 and one K6 launch) or through nerf_apply
    # on the card (use_pallas_renderer false: no kernel at all)
    libs = (F.RENDER_TRAIN, F.RENDER_FWD, F.RENDER_BWD, M.POINT_MLP_FWD, M.POINT_MLP_BWD)
    for section, key, value, expected in (("tpu", "use_pallas_renderer", False, [0, 0, 0, 0, 0]),
                                          ("rendering", "num_points", 100, [0, 0, 0, 1, 1])):
        other = load_config(overrides={"training": {"n_training_points": 256},
                                       "pose": {"learn_pose": True, "init_pose": True},
                                       section: {key: value}})
        counts = [lib.launches for lib in libs]
        state, ld = Trainer(other, ModelConfigs.from_cfg(other, 4)).step(
            state, batch_for_frame(scene, 0, ref_idx=1), 0, 10000)
        assert [lib.launches - c for lib, c in zip(libs, counts)] == expected, key
        assert all(torch.isfinite(v).all() for v in ld.values())


# ---- the point-query MLP kernels (K5, K6) and the hierarchical path -------------

def _points(dev, m, seed=0):
    gen = torch.Generator().manual_seed(seed)
    pts = (torch.randn(m, 3, generator=gen) * 1.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(m, 3, generator=gen), dim=1).to(dev)
    return gen, pts, dirs


@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_point_mlp_fwd_matches_plain(cuda_device, hidden, occ, dist_alpha):
    gen, pts, dirs = _points(cuda_device, 3 * 128 + 37)       # a ragged last pass
    ncfg = NerfConfig(hidden_dim=hidden, occ_activation=occ, dist_alpha=dist_alpha,
                      use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    before = M.POINT_MLP_FWD.launches
    with torch.no_grad():
        got = M.point_mlp(params, pts, dirs, ncfg)
    assert M.POINT_MLP_FWD.launches == before + 1
    _assert_close(got, M.point_mlp_fwd_plain(params, pts, dirs, ncfg))


@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
@pytest.mark.parametrize("m", [1, 127, 128, 128 * 265 + 5])
def test_point_mlp_fwd_point_counts(cuda_device, hidden, m):
    """Persistent CTAs (one per SM) walk over the 128-point passes (64-point
    ones at 384 and 512): a single point, a ragged and a full single pass,
    and two waves of the card's 132 SMs and more, ending in a ragged pass."""
    gen, pts, dirs = _points(cuda_device, m, seed=3)
    ncfg = NerfConfig(hidden_dim=hidden, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    with torch.no_grad():
        got = M.point_mlp(params, pts, dirs, ncfg)
    _assert_close(got, M.point_mlp_fwd_plain(params, pts, dirs, ncfg))


def _assert_point_grads_close(got, ref, ncfg):
    """The render-backward rule (_assert_grads_close) with d(points) and
    d(directions) as the per-sample blocks."""
    g = dict(F.unpack_grads(got[0], got[1], ncfg), rays=got[2], z=got[3])
    r = dict(F.unpack_grads(ref[0], ref[1], ncfg), rays=ref[2], z=ref[3])
    _assert_grads_close(g, r)


@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_point_mlp_bwd_matches_plain_and_is_bit_reproducible(cuda_device, hidden, occ,
                                                             dist_alpha):
    gen, pts, dirs = _points(cuda_device, 300 * 128 + 37, seed=1)
    ncfg = NerfConfig(hidden_dim=hidden, occ_activation=occ, dist_alpha=dist_alpha,
                      use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    # the cotangents of a smooth loss, mean |rgb - 0.5|^2 / 3 + 0.1 density: noise
    # cotangents would make each block a random walk that one flip moves far
    # (chip_smoke.point_cotangents)
    m = pts.shape[0]
    g_rgb = (2.0 / (3 * m) * (M.point_mlp_fwd_plain(params, pts, dirs, ncfg)[0] - 0.5)).contiguous()
    g_den = torch.full((m, 1), 0.1 / m, device=cuda_device)
    a = M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)
    b = M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)
    for x, y in zip([*a[0], *a[1], a[2], a[3]], [*b[0], *b[1], b[2], b[3]]):
        assert torch.equal(x, y)
    _assert_point_grads_close(a, M.point_mlp_bwd_plain(params, pts, dirs, g_rgb, g_den, ncfg),
                              ncfg)


def _point_cotangents(params, pts, dirs, ncfg):
    m = pts.shape[0]
    g_rgb = (2.0 / (3 * m) * (M.point_mlp_fwd_plain(params, pts, dirs, ncfg)[0] - 0.5)).contiguous()
    return g_rgb, torch.full((m, 1), 0.1 / m, device=pts.device)


def _assert_frozen_point_grads(params, pts, dirs, g_rgb, g_den, ncfg):
    """K6's frozen-network variant: d(points), d(directions) bit-equal to the
    full variant's in two launches, within the per-sample tolerance of the
    plain version, no dW/dB."""
    full = M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)
    counts = (M.POINT_MLP_BWD.launches, M.POINT_MLP_BWD_FROZEN.launches)
    runs = [M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg, want_param_grads=False)
            for _ in range(2)]
    assert (M.POINT_MLP_BWD.launches - counts[0],
            M.POINT_MLP_BWD_FROZEN.launches - counts[1]) == (2, 2)
    for dWs, dBs, dpts, ddirs in runs:
        assert dWs is None and dBs is None
        assert torch.equal(dpts, full[2]) and torch.equal(ddirs, full[3])
    ref = M.point_mlp_bwd_plain(params, pts, dirs, g_rgb, g_den, ncfg, want_param_grads=False)
    assert ref[0] is None and ref[1] is None
    if ref[2].numel() >= 1000:
        _assert_grads_close(dict(rays=runs[0][2], z=runs[0][3]), dict(rays=ref[2], z=ref[3]))
    else:
        # under 1000 entries the "1 entry in 1000" outlier allowance admits no flipped
        # mask at all, and K6's full variant (bit-equal above) shows one at M = 127:
        # the L2 rule holds here, the outlier rule at the counts that have 1000 entries
        for got, r in ((runs[0][2], ref[2]), (runs[0][3], ref[3])):
            assert torch.isfinite(got).all()
            assert float((got - r).norm()) <= 2e-2 * float(r.norm()) + 1e-9


@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("m", [1, 127, 128, 128 * 265 + 5])
def test_point_mlp_bwd_frozen_point_counts(cuda_device, hidden, m):
    """A single point, a ragged and a full single pass, and two waves of the
    card's 132 SMs and more, ending in a ragged pass."""
    gen, pts, dirs = _points(cuda_device, m, seed=5)
    ncfg = NerfConfig(hidden_dim=hidden, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    _assert_frozen_point_grads(params, pts, dirs, *_point_cotangents(params, pts, dirs, ncfg),
                               ncfg)


@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_point_mlp_bwd_frozen_flags(cuda_device, occ, dist_alpha):
    gen, pts, dirs = _points(cuda_device, 300 * 128 + 37, seed=6)
    ncfg = NerfConfig(occ_activation=occ, dist_alpha=dist_alpha, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    _assert_frozen_point_grads(params, pts, dirs, *_point_cotangents(params, pts, dirs, ncfg),
                               ncfg)


def test_point_mlp_autograd_takes_the_frozen_variant(cuda_device):
    """With no nerf parameter requiring a gradient, point_mlp's backward is
    K6's frozen-network variant, and the points' gradient is the full one's."""
    gen, pts, dirs = _points(cuda_device, 1000, seed=7)
    ncfg = NerfConfig(use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)

    def grad(frozen):
        leaves = {k: v.clone().requires_grad_(not frozen) for k, v in params.items()}
        x = pts.clone().requires_grad_(True)
        rgb, den = M.point_mlp(leaves, x, dirs, ncfg)
        (rgb.sum() + den.sum()).backward()
        return x.grad

    counts = (M.POINT_MLP_BWD.launches, M.POINT_MLP_BWD_FROZEN.launches)
    full = grad(False)
    assert (M.POINT_MLP_BWD.launches - counts[0], M.POINT_MLP_BWD_FROZEN.launches - counts[1]) == (1, 0)
    frozen = grad(True)
    assert (M.POINT_MLP_BWD.launches - counts[0], M.POINT_MLP_BWD_FROZEN.launches - counts[1]) == (2, 1)
    assert torch.equal(frozen, full)


def test_point_mlp_autograd_launches_its_kernels(cuda_device):
    gen, pts, dirs = _points(cuda_device, 1000, seed=2)
    ncfg = NerfConfig(use_pallas=True)
    params = {k: v.requires_grad_(True) for k, v in
              init_nerf_params(ncfg, gen, device=cuda_device).items()}
    pts.requires_grad_(True)
    counts = (M.POINT_MLP_FWD.launches, M.POINT_MLP_BWD.launches)
    rgb, den = M.point_mlp(params, pts, dirs, ncfg)
    (rgb.sum() + den.sum()).backward()
    assert (M.POINT_MLP_FWD.launches - counts[0], M.POINT_MLP_BWD.launches - counts[1]) == (1, 1)
    assert torch.isfinite(pts.grad).all() and float(params["trunk0_0_w"].grad.abs().max()) > 0
    with pytest.raises(NotImplementedError, match="hidden_dim"):
        M.point_mlp({k: v.detach() for k, v in init_nerf_params(
            NerfConfig(hidden_dim=64), gen, device=cuda_device).items()}, pts.detach(), dirs,
            NerfConfig(hidden_dim=64, use_pallas=True))


def _dw_operands(dev, shapes, m, seed):
    """Seeded bf16 operands (m, K), (m, N) for each (K, N), their tiled copies
    with the padding rows of the last row tile NaN (rows past m must read as
    zero), and the chunk count K6 would use."""
    gen = torch.Generator().manual_seed(seed)
    xs, gs, xt, gt = [], [], [], []
    for K, N in shapes:
        x = torch.randn(m, K, generator=gen).to(dev).to(torch.bfloat16)
        g = torch.randn(m, N, generator=gen).to(dev).to(torch.bfloat16)
        X, G = M.tile_operand(x), M.tile_operand(g)
        if m % M.DW_ROWS:
            X[-1, :, m % M.DW_ROWS:] = float("nan")
            G[-1, :, m % M.DW_ROWS:] = float("nan")
        xs, gs, xt, gt = xs + [x], gs + [g], xt + [X], gt + [G]
    chunks = M.dw_chunks(M.dw_cta_tiles(K for K, _ in shapes), m,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    return xs, gs, xt, gt, chunks


@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("m", [1, 127, 128, 196_645])
def test_dw_kernel_matches_plain_for_every_block_shape(cuda_device, hidden, m):
    """The weight-gradient kernel against dw_plain over every block shape of
    K6's work table: each entry within 1e-4 of the sum of its products'
    magnitudes (f32 sums of up to ~33,000 terms a chunk, the tensor cores'
    order against matmul's in full f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = sorted({(K, N) for *_, K, N in M.point_dw_table(hidden)})
    xs, gs, xt, gt, chunks = _dw_operands(cuda_device, shapes, m, seed=m)
    count = M.DW_SM90.launches
    got = M.dw_sm90(xt, gt, [K for K, _ in shapes], m, chunks)
    assert M.DW_SM90.launches - count == 1
    for d, x, g, (K, N) in zip(got, xs, gs, shapes):
        assert tuple(d.shape) == (K, N) and torch.isfinite(d).all()
        ref = M.dw_plain(x, g, chunks)
        mag = x.float().abs().t() @ g.float().abs()
        assert bool(((d - ref).abs() <= 1e-4 * mag).all()), (K, N)


@pytest.mark.parametrize("m", [127, 196_645])
def test_dw_kernel_two_launches_bit_equal(cuda_device, m):
    shapes = sorted({(K, N) for *_, K, N in M.point_dw_table(256)})
    _, _, xt, gt, chunks = _dw_operands(cuda_device, shapes, m, seed=3)
    Ks = [K for K, _ in shapes]
    for a, b in zip(M.dw_sm90(xt, gt, Ks, m, chunks), M.dw_sm90(xt, gt, Ks, m, chunks)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hidden", [128, 256, 640, 1024])
@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_point_mlp_bwd_full_dx_equals_the_frozen_variant(cuda_device, hidden, occ, dist_alpha):
    """K6 full and its frozen-network variant run the same dX chain: d(points)
    and d(directions) torch.equal; K6 full launches the dW kernel once (twice
    past 512, where its table takes two launches)."""
    gen, pts, dirs = _points(cuda_device, 300 * 128 + 37, seed=8)
    ncfg = NerfConfig(hidden_dim=hidden, occ_activation=occ, dist_alpha=dist_alpha,
                      use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    g_rgb, g_den = _point_cotangents(params, pts, dirs, ncfg)
    launches = 1 if hidden <= 512 else 2
    count = M.DW_SM90.launches
    full = M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)
    assert M.DW_SM90.launches - count == launches
    frozen = M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg, want_param_grads=False)
    assert M.DW_SM90.launches - count == launches
    assert torch.equal(full[2], frozen[2]) and torch.equal(full[3], frozen[3])


def test_hierarchical_train_step_and_frame_on_card(cuda_device):
    """n_importance 64: per step K5 twice (coarse, fine) and K6 once, no fused
    render kernel; render_frame launches K5 twice per chunk."""
    cfg = load_config(overrides={"training": {"n_training_points": 256},
                                 "rendering": {"n_importance": 64},
                                 "pose": {"learn_pose": True, "init_pose": True}})
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=48, w=64)).to_device(cuda_device)
    mc = ModelConfigs.from_cfg(cfg, 4)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device=cuda_device)
    trainer = Trainer(cfg, mc)
    libs = (M.POINT_MLP_FWD, M.POINT_MLP_BWD, C.CHAMFER_BIDIR, F.RENDER_TRAIN, F.RENDER_FWD,
            F.RENDER_BWD)
    counts = [lib.launches for lib in libs]
    state, lds = trainer.run_steps(state, scene, np.array([0, 3]), np.array([1, 2]), epoch=0,
                                   scheduling_start=10000)
    assert [lib.launches - c for lib, c in zip(libs, counts)] == [4, 2, 2, 0, 0, 0]
    assert all(torch.isfinite(v).all() for v in lds.values())
    counts = M.POINT_MLP_FWD.launches
    frame = trainer.render_frame(state, batch_for_frame(scene, 1), (48, 64), chunk=1000)
    assert M.POINT_MLP_FWD.launches - counts == 2 * 4                # 3072 rays in 4 chunks
    assert frame["rgb"].shape == (48, 64, 3) and np.isfinite(frame["rgb"]).all()


# ---- captured step graphs (training/graphs.py) -----------------------------------------

def _graph_setup(dev, **extra):
    over = {"training": {"n_training_points": 256},
            "pose": {"learn_pose": True, "init_pose": True}}
    for k, v in extra.items():
        over.setdefault(k, {}).update(v)
    cfg = load_config(overrides=over)
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=48, w=64)).to_device(dev)
    mc = ModelConfigs.from_cfg(cfg, 4)
    return cfg, scene, mc


def _copy_state(state):
    from nope_nerf_torch.cli.train import _clone_state
    return _clone_state(state)


@pytest.mark.parametrize("extra", [{}, {"training": {"depth_loss_type": "invariant"}},
                                   {"rendering": {"n_importance": 64}}])
def test_replayed_steps_equal_eager_steps(cuda_device, extra):
    """Trainer.run_steps replays its captured step: states, loss terms and the
    generator torch.equal to Trainer(graphs=False)'s eager steps from a copy
    of the same state, the launch counts through the replays equal."""
    cfg, scene, mc = _graph_setup(cuda_device, **extra)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device=cuda_device)
    a, b = _copy_state(state), _copy_state(state)
    order, refs = np.array([0, 3, 1, 2]), np.array([1, 2, 2, 3])
    libs = [lib for lib in (F.RENDER_TRAIN, F.RENDER_FWD, F.RENDER_BWD, M.POINT_MLP_FWD,
                            M.POINT_MLP_BWD, M.DW_SM90, C.CHAMFER_BIDIR)]
    counts = []
    for trainer, st in ((Trainer(cfg, mc, graphs=False), a), (Trainer(cfg, mc), b)):
        before = [lib.launches for lib in libs]
        st, lds = trainer.run_steps(st, scene, order, refs, epoch=0, scheduling_start=10000)
        counts.append([lib.launches - c for lib, c in zip(libs, before)])
        if trainer.use_graphs:
            assert len(trainer.captured_steps()) == 1
            ld_b = lds
        else:
            ld_a = lds
    assert counts[0] == counts[1] and sum(counts[0]) > 0
    assert all(torch.equal(ld_a[k], ld_b[k]) for k in ld_a)
    assert torch.equal(a.generator.get_state(), b.generator.get_state()) and a.it == b.it
    for g in a.params:
        assert torch.equal(a.opt_state[g].count, b.opt_state[g].count)
        for k in a.params[g]:
            assert torch.equal(a.params[g][k], b.params[g][k])
            assert torch.equal(a.opt_state[g].nu[k], b.opt_state[g].nu[k])


def test_replays_draw_from_the_registered_generator(cuda_device):
    """A replay draws what the eager body draws from the same generator state,
    and advances the generator as far; a draw after the replays continues
    where the eager run's would."""
    from nope_nerf_torch.training.graphs import CapturedStep
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    out = torch.zeros((4, 1000), dtype=torch.int64, device=cuda_device)
    row = torch.zeros((1,), dtype=torch.int64, device=cuda_device)

    def body():
        draw = torch.randperm(100_000, generator=gen, device=cuda_device)[:1000]
        out.index_copy_(0, row, draw[None])
        row.add_(1)
    ref_gen = torch.Generator(device=cuda_device).manual_seed(3)
    ref = [torch.randperm(100_000, generator=ref_gen, device=cuda_device)[:1000] for _ in range(4)]
    step = CapturedStep(body, [row], gen, "a randperm")
    for _ in range(4):
        step.replay()
    assert torch.equal(out, torch.stack(ref))
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert torch.equal(torch.rand(8, generator=gen, device=cuda_device),
                       torch.rand(8, generator=ref_gen, device=cuda_device))


def test_a_body_that_reads_back_fails_to_capture_naming_the_operation(cuda_device):
    from nope_nerf_torch.training.graphs import CapturedStep, GraphCaptureError
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.ones(4, device=cuda_device)

    def body():
        if float(x.sum()) > 0:          # a host readback: no graph can hold it
            x.mul_(2.0)
    with pytest.raises(GraphCaptureError, match=r"test_torch_cuda.py:\d+ in body"):
        CapturedStep(body, [x], gen, "a readback")


def test_pose_opt_replays_equal_eager_run(cuda_device):
    """optimize_test_poses replayed against graphs=False: equal poses."""
    from nope_nerf_torch.evaluation.pose_opt import optimize_test_poses
    cfg, scene, mc = _graph_setup(cuda_device)
    nerf = init_nerf_params(mc.nerf, torch.Generator().manual_seed(1), device=cuda_device)
    view = SceneData.from_dict(make_synthetic_scene(n_frames=2, h=48, w=64))
    runs = [optimize_test_poses(nerf, None, view, mc.nerf, mc.render, init_c2ws=view.c2ws_gt,
                                n_points=256, n_epochs=3, log_every=0, device=cuda_device,
                                graphs=graphs) for graphs in (False, True)]
    assert np.array_equal(runs[0][1], runs[1][1])
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])


@pytest.mark.parametrize("hidden", [384, 512])
def test_wide_frames_launch_k3_once_and_k5_twice(cuda_device, hidden):
    """Trainer.render_frame at hidden_dim 384 and 512 on the card: one K3 launch
    a chunk of rays, or with n_importance 64 two of K5; rows 0-3 as the plain
    versions render them."""
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=2, h=24, w=32)).to_device(
        cuda_device)
    state = None
    for extra, counter in (({}, F.RENDER_FWD), ({"rendering": {"n_importance": 64}},
                                                M.POINT_MLP_FWD)):
        cfg = load_config(overrides={"model": {"hidden_dim": hidden},
                                     "pose": {"learn_pose": True, "init_pose": True}, **extra})
        mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
        if state is None:
            state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device=cuda_device)
        trainer = Trainer(cfg, mc)
        batch = batch_for_frame(scene, 1)
        before = counter.launches
        frame = trainer.render_frame(state, batch, (24, 32))
        assert counter.launches == before + (1 if counter is F.RENDER_FWD else 2)
        with F.plain_versions():
            slab = trainer.render_frame(state, batch, (24, 32), rows=(0, 4))
        for key in ("rgb", "depth"):
            ref = torch.as_tensor(slab[key])
            assert np.isfinite(frame[key]).all()
            assert float((torch.as_tensor(frame[key][:4]) - ref).abs().max()) <= 2e-3 * max(
                1.0, float(ref.abs().max()))


def test_xwide_render_fwd_matches_plain(cuda_device):
    """K3 at hidden_dim 768 (csrc/mlp_fwd_xwide_sm90.cuh's trunk: passes of 128
    columns, all but the last staged in device memory) on 133 rays x 128,
    launched once, against its plain version."""
    gen, rays, z = _inputs(cuda_device, 133, 128, seed=4)
    ncfg = NerfConfig(hidden_dim=768, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    params["density_b"] = params["density_b"] - 4.0   # transmittance alive past sample 0
    before = F.RENDER_FWD.launches
    got = F.render_rays_fused(params, rays, z, ncfg, False, True)
    assert F.RENDER_FWD.launches == before + 1
    _assert_close(got, F.render_rays_fused_plain(params, rays, z, ncfg, False, True))


def test_xwide_point_mlp_fwd_matches_plain(cuda_device):
    """K5 at hidden_dim 1024 on 127 points (a full 64-point pass and a ragged
    one of 63), launched once, against its plain version."""
    gen, pts, dirs = _points(cuda_device, 127, seed=5)
    ncfg = NerfConfig(hidden_dim=1024, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    before = M.POINT_MLP_FWD.launches
    with torch.no_grad():
        got = M.point_mlp(params, pts, dirs, ncfg)
    assert M.POINT_MLP_FWD.launches == before + 1
    _assert_close(got, M.point_mlp_fwd_plain(params, pts, dirs, ncfg))


def test_wide_backward_kernels_raise_before_any_launch(cuda_device):
    """Past hidden_dim 1024 the render kernels that form weight gradients
    (K1, K4 full) raise NotImplementedError naming Queue 3 (c) with no
    launch, and so does render_rays_fused under autograd when a nerf
    parameter wants a gradient: its forward checks the backward's variant
    before K3 launches. At 512 the same three calls launch: K1 once, K4 full
    once (after K3), each with the dW kernel once."""
    gen, rays, z = _inputs(cuda_device, 133, 128)
    tgt = F.pack_targets(torch.rand(133, 3, device=cuda_device),
                         torch.ones(133, device=cuda_device),
                         torch.ones(133, dtype=torch.bool, device=cuda_device), 1.0, 1.0)
    g_rgb, g_dist = torch.ones(133, 3, device=cuda_device), torch.ones(133, device=cuda_device)
    libs = (F.RENDER_TRAIN, F.RENDER_BWD, F.RENDER_BWD_FROZEN, M.POINT_MLP_BWD,
            M.POINT_MLP_BWD_FROZEN, M.DW_SM90, M.POINT_MLP_FWD, F.RENDER_FWD)
    params = init_nerf_params(NerfConfig(hidden_dim=512, use_pallas=True), gen,
                              device=cuda_device)
    past = NerfConfig(hidden_dim=1152, use_pallas=True)
    before = [lib.launches for lib in libs]
    with pytest.raises(NotImplementedError, match=r"Queue 3 \(c\)"):
        F.render_ray_loss_fused(params, rays, z, tgt, past, False, 1, False)
    with pytest.raises(NotImplementedError, match=r"Queue 3 \(c\)"):
        F._render_bwd_cuda(params, rays, z, g_rgb, g_dist, None, None, past, False)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with pytest.raises(NotImplementedError, match=r"Queue 3 \(c\)"):
        F.render_rays_fused(leaves, rays, z, past, False, False)
    assert [lib.launches for lib in libs] == before
    ncfg = NerfConfig(hidden_dim=512, use_pallas=True)
    F.render_ray_loss_fused(params, rays, z, tgt, ncfg, False, 1, False)
    F._render_bwd_cuda(params, rays, z, g_rgb, g_dist, None, None, ncfg, False)
    rgb, dist, _, _ = F.render_rays_fused(leaves, rays, z, ncfg, False, False)
    (rgb.sum() + dist.sum()).backward()
    torch.cuda.synchronize()
    assert [lib.launches - b for lib, b in zip(libs, before)] == [1, 2, 0, 0, 0, 3, 0, 1]
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())


@pytest.mark.parametrize("flags", [("softplus", False), ("relu", True)], ids=["softplus", "relu"])
@pytest.mark.parametrize("S", [128, 256, 1024])
@pytest.mark.parametrize("hidden", [384, 512, 640, 1024])
def test_render_bwd_frozen_wide(cuda_device, hidden, S, flags):
    """K4's frozen-network variant at 384 and 512 (csrc/mlp_dx_wide_sm90.cuh's
    64-point chain; the masks of a ray's tiles in device memory, its arrays
    past shared memory from S = 256 at 512) and at 640 and 1024
    (csrc/mlp_dx_xwide_sm90.cuh's passes of 128 columns, staged in device
    memory; the arrays past shared memory from S = 512 at 1024): two launches bit-equal, within
    the per-sample tolerance of the plain version. The pose-opt step's 1024
    rays (7 or 8 a CTA): on 133 the rule's 1 entry in 1000 of d(rays) is less
    than one flipped bf16 rounding moves, and the f32 plain version itself
    misses it against the f64 sum (PERF.md section 2)."""
    occ, dist_alpha = flags
    params, rays, z, tgt, ncfg = _train_case(cuda_device, 1024, S, hidden, seed=8, occ=occ,
                                             dist_alpha=dist_alpha, render_dist_alpha=dist_alpha,
                                             spread=0.5, far=6.0)
    cot = _bwd_cotangents(params, rays, z, tgt, ncfg, dist_alpha, True)
    counts = (F.RENDER_BWD.launches, F.RENDER_BWD_FROZEN.launches)
    runs = [F._render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha, want_param_grads=False)
            for _ in range(2)]
    assert (F.RENDER_BWD.launches - counts[0], F.RENDER_BWD_FROZEN.launches - counts[1]) == (2, 2)
    assert torch.equal(runs[0][2], runs[1][2]) and torch.equal(runs[0][3], runs[1][3])
    ref = F.render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, dist_alpha)
    _assert_grads_close(dict(rays=runs[0][2], z=runs[0][3]), dict(rays=ref[2], z=ref[3]))


@pytest.mark.parametrize("m", [1, 63, 64, 65, 127, 64 * 265 + 5])
@pytest.mark.parametrize("hidden", [384, 512, 640, 1024])
def test_point_mlp_bwd_frozen_wide(cuda_device, hidden, m):
    """K6's frozen-network variant at 384 to 1024 on 64-point passes: one
    point, a ragged, a full and a two-pass count, and two waves of the SMs
    ending ragged; two launches bit-equal, within the per-sample tolerance of
    the plain version (the L2 rule alone under 1000 entries)."""
    gen, pts, dirs = _points(cuda_device, m, seed=9)
    ncfg = NerfConfig(hidden_dim=hidden, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    g_rgb, g_den = _point_cotangents(params, pts, dirs, ncfg)
    runs = [M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg, want_param_grads=False)
            for _ in range(2)]
    assert torch.equal(runs[0][2], runs[1][2]) and torch.equal(runs[0][3], runs[1][3])
    ref = M.point_mlp_bwd_plain(params, pts, dirs, g_rgb, g_den, ncfg, want_param_grads=False)
    if ref[2].numel() >= 1000:
        _assert_grads_close(dict(rays=runs[0][2], z=runs[0][3]), dict(rays=ref[2], z=ref[3]))
    else:
        for got, r in ((runs[0][2], ref[2]), (runs[0][3], ref[3])):
            assert torch.isfinite(got).all()
            assert float((got - r).norm()) <= 2e-2 * float(r.norm()) + 1e-9


def test_wide_frozen_autograd_launches_k3_and_k4_frozen(cuda_device):
    """render_rays_fused under autograd at hidden_dim 512 with a frozen nerf
    and the rays wanting a gradient: K3 once, K4's frozen variant once."""
    ncfg = NerfConfig(hidden_dim=512, use_pallas=True)
    gen, rays, z = _inputs(cuda_device, 133, 128, spread=0.5, far=6.0)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    x = rays.clone().requires_grad_(True)
    counts = (F.RENDER_FWD.launches, F.RENDER_BWD_FROZEN.launches)
    rgb, dist, _, _ = F.render_rays_fused(params, x, z, ncfg, False, False)
    (rgb.sum() + dist.sum()).backward()
    assert (F.RENDER_FWD.launches - counts[0], F.RENDER_BWD_FROZEN.launches - counts[1]) == (1, 1)
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("m", [1, 63, 65, 129, 64 * 265 + 37])
@pytest.mark.parametrize("hidden", [384, 512])
def test_point_mlp_bwd_full_wide(cuda_device, hidden, m):
    """K6 full at 384 and 512 (csrc/mlp_dx_wide_sm90.cuh's 64-point chain with
    mlp_dw_chain_sm90.cuh's OperandSaveW; the dW kernel's column pieces; half
    a 128-row operand tile per 64-point pass): two launches bit-equal,
    d(points) and d(directions) torch.equal to the frozen-network variant's,
    the dW kernel launched once, and against the plain version: at two waves
    of the SMs every dW and dB block within 5e-3 of its largest entry and
    the per-sample rule; at the small counts, where one flipped bf16 rounding
    at a single point moves a block by more than 5e-3 of its largest entry
    (tools/backward_noise.py --full), each block by the L2 rule."""
    gen, pts, dirs = _points(cuda_device, m, seed=10)
    ncfg = NerfConfig(hidden_dim=hidden, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    g_rgb, g_den = _point_cotangents(params, pts, dirs, ncfg)
    count = M.DW_SM90.launches
    a = M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)
    assert M.DW_SM90.launches - count == 1
    b = M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)
    for x, y in zip([*a[0], *a[1], a[2], a[3]], [*b[0], *b[1], b[2], b[3]]):
        assert torch.equal(x, y)
    frozen = M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg, want_param_grads=False)
    assert torch.equal(frozen[2], a[2]) and torch.equal(frozen[3], a[3])
    ref = M.point_mlp_bwd_plain(params, pts, dirs, g_rgb, g_den, ncfg)
    if m >= 1000:
        _assert_point_grads_close(a, ref, ncfg)
        return
    got = dict(F.unpack_grads(a[0], a[1], ncfg), points=a[2], directions=a[3])
    want = dict(F.unpack_grads(ref[0], ref[1], ncfg), points=ref[2], directions=ref[3])
    for k, r in want.items():
        assert torch.isfinite(got[k]).all(), k
        assert float((got[k] - r).norm()) <= 2e-2 * float(r.norm()) + 1e-9, k


def test_point_mlp_bwd_full_narrow_ragged_relu(cuda_device):
    """K6 full at 128 on chip_smoke.py phase 14's draw of 127 points, relu with
    dist_alpha (its generator replayed through check_wide_full's cases before
    this one), where the narrow chain's forward, summed from the bias over all
    of K, put d(points) at 1.98 of the per-sample rule: every block within
    phase 14's rule (wide_full_share) of the plain version's, d(points) and
    d(directions) torch.equal to the frozen-network variant's."""
    import chip_smoke as cs
    gen = torch.Generator().manual_seed(cs.SEED + 38)
    case = None
    for m in cs.WIDE_FULL_M:
        pts, dirs = cs.point_inputs(torch, cuda_device, gen, m)
        for occ, da in cs.WIDE_FLAGS:
            ncfg = NerfConfig(hidden_dim=128, occ_activation=occ, dist_alpha=da, use_pallas=True)
            params = init_nerf_params(ncfg, gen, device=cuda_device)
            if (m, occ) == (127, "relu"):
                case = params, pts, dirs, ncfg
                break
        if case is not None:
            break
    params, pts, dirs, ncfg = case
    cot = cs.point_cotangents(torch, params, pts, dirs, ncfg)
    a = M._mlp_bwd_cuda(params, pts, dirs, *cot, ncfg)
    frozen = M._mlp_bwd_cuda(params, pts, dirs, *cot, ncfg, want_param_grads=False)
    assert torch.equal(frozen[2], a[2]) and torch.equal(frozen[3], a[3])
    ref = M.point_mlp_bwd_plain(params, pts, dirs, *cot, ncfg)
    got = dict(F.unpack_grads(a[0], a[1], ncfg), points=a[2], directions=a[3])
    want = dict(F.unpack_grads(ref[0], ref[1], ncfg), points=ref[2], directions=ref[3])
    for k, r in want.items():
        assert torch.isfinite(got[k]).all(), k
        assert cs.wide_full_share(got[k], r, k, 127) <= 1.0, k


@pytest.mark.parametrize("hidden", [384, 512])
def test_point_mlp_autograd_trains_wide(cuda_device, hidden):
    """point_mlp under autograd with nerf parameters that want gradients at
    384 and 512: K5 once, K6 full once (with the dW kernel), every parameter
    gradient finite and equal to _mlp_bwd_cuda's unpacked blocks."""
    gen, pts, dirs = _points(cuda_device, 3000, seed=11)
    ncfg = NerfConfig(hidden_dim=hidden, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    counts = (M.POINT_MLP_FWD.launches, M.POINT_MLP_BWD.launches, M.DW_SM90.launches)
    rgb, den = M.point_mlp(leaves, pts, dirs, ncfg)
    g_rgb, g_den = torch.full_like(rgb, 1e-3), torch.full_like(den, 1e-4)
    torch.autograd.backward((rgb, den), (g_rgb, g_den))
    assert (M.POINT_MLP_FWD.launches - counts[0], M.POINT_MLP_BWD.launches - counts[1],
            M.DW_SM90.launches - counts[2]) == (1, 1, 1)
    ref = F.unpack_grads(*M._mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)[:2], ncfg)
    for k, v in leaves.items():
        assert torch.isfinite(v.grad).all(), k
        assert torch.equal(v.grad, ref[k].to(v.dtype)), k


# One forward: the check builds of K3 and K5 write the X operands of the dW
# products from the forward they run, which must be the backward kernels' own
# (chip_smoke.py phase 15 holds every width and case).
@pytest.mark.parametrize("hidden, n_rays, occ, dist_alpha",
                         [(256, 133, "softplus", False), (512, 1024, "relu", True)])
def test_render_fwd_operands_equal_the_render_backward_kernels(cuda_device, hidden, n_rays, occ,
                                                               dist_alpha):
    """K3's check build on n_rays x 128: its X operands torch.equal to those K4
    full and K1 hand the dW kernel (chip_smoke.operands_differ), its rgb and
    dist to the main build's."""
    import chip_smoke as cs
    gen = torch.Generator().manual_seed(25)
    rays, z, tgt = cs.train_inputs(torch, cuda_device, gen, n_rays, 128)
    ncfg, params = cs.many_params(torch, cuda_device, gen, hidden, occ, dist_alpha, 128)
    g_rgb = (torch.randn(n_rays, 3, generator=gen) * 1e-3).to(cuda_device)
    g_dist = (torch.randn(n_rays, generator=gen) * 1e-3).to(cuda_device)
    rgb, dist, xk3 = F.render_fwd_operands(params, rays, z, ncfg, dist_alpha)
    k4, k1 = [], []
    F._render_bwd_cuda(params, rays, z, g_rgb, g_dist, None, None, ncfg, dist_alpha, operands=k4)
    F._train_cuda(params, rays, z, tgt, ncfg, dist_alpha, 1, False, operands=k1)
    main = F.render_rays_fused(params, rays, z, ncfg, dist_alpha, want_aux=False)
    assert xk3.numel() * 2 == F.render_operand_bytes(hidden, n_rays, 128)[0]
    assert cs.operands_differ(torch, xk3, k4[0], hidden, n_rays * 128, False) == []
    assert cs.operands_differ(torch, xk3, k1[0], hidden, n_rays * 128, False) == []
    assert torch.equal(rgb, main[0]) and torch.equal(dist, main[1])


@pytest.mark.parametrize("hidden", [128, 384])
def test_point_mlp_fwd_operands_equal_k6_full(cuda_device, hidden):
    """K5's check build on a ragged 127 points: its X operands torch.equal to
    those K6 full hands the dW kernel (each operand's own columns:
    chip_smoke.operands_differ), its outputs to the main build's."""
    import chip_smoke as cs
    gen, pts, dirs = _points(cuda_device, 127, seed=25)
    ncfg = NerfConfig(hidden_dim=hidden, occ_activation="relu", use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=cuda_device)
    rgb, density, xk5 = M.point_mlp_fwd_operands(params, pts, dirs, ncfg)
    k6 = []
    M._mlp_bwd_cuda(params, pts, dirs, torch.full_like(pts, 1e-6),
                    torch.full((127, 1), 1e-3, device=cuda_device), ncfg, operands=k6)
    main = M._mlp_fwd_cuda(params, pts, dirs, ncfg)
    assert xk5.numel() * 2 == M.point_operand_bytes(hidden, 127)
    assert cs.operands_differ(torch, xk5, k6[0], hidden, 127, True) == []
    assert torch.equal(rgb, main[0]) and torch.equal(density, main[1])
