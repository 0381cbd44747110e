"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither JAX nor nope_nerf_tpu, so it also runs on a machine
that has only PyTorch; there the repository's conftest.py (which imports JAX)
is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances. Forward values: 2e-3 x max(1, max|plain|): the kernel and the plain
version sum the same bf16 products in another order (see chip_smoke.tolerance).
The train kernel's gradients: 5e-3 of each weight block's largest entry; for
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
from nope_nerf_torch.ops import fused_render as F
from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(dev, n, S, seed=0):
    gen = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    rays = F.pack_rays(torch.randn(n, 3, generator=gen) * 3.0, v, -v).to(dev)
    z = torch.sort(torch.rand(n, S, generator=gen) * 8 + 0.1, dim=1).values.to(dev)
    return gen, rays, z


def _assert_close(got, ref):
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            assert torch.isfinite(g).all()
            assert float((g - r).abs().max()) <= 2e-3 * max(1.0, float(r.abs().max()))


@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("S", [128, 256])
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
    gen, rays, z = _inputs(dev, n, S, seed)
    ncfg = NerfConfig(hidden_dim=hidden, use_pallas=True,
                      occ_activation=flags.get("occ", "softplus"),
                      dist_alpha=flags.get("dist_alpha", False))
    params = init_nerf_params(ncfg, gen, device=dev)
    if ncfg.occ_activation == "softplus" and not ncfg.dist_alpha:
        params["density_b"] = params["density_b"] - 4.0    # weights spread over the ray
    mask = (torch.arange(n) % 3 != 0).to(dev)
    tgt = F.pack_targets(torch.rand(n, 3, generator=gen).to(dev),
                         (1 + 4 * torch.rand(n, generator=gen)).to(dev), mask, 0.7 / n,
                         0.3 / float(mask.sum()))
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
@pytest.mark.parametrize("S", [128, 256])
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
    F.render_ray_loss_fused(params, rays, z, tgt, ncfg, False, 1, False, force_plain=True)
    assert F.RENDER_TRAIN.launches == before + 2              # the plain route launches nothing
    with pytest.raises(NotImplementedError):
        F.render_ray_loss_fused(params, rays, z[:, :100].contiguous(), tgt, ncfg, False, 1, False)
    big = torch.sort(torch.rand(200, 384, device=cuda_device) * 8 + 0.1, dim=1).values
    with pytest.raises(NotImplementedError):
        F.render_ray_loss_fused(params, rays, big, tgt, ncfg, False, 1, False)
    with pytest.raises(ValueError):
        F.render_ray_loss_fused(params, rays, z.t().contiguous().t(), tgt, ncfg, False, 1, False)
    with pytest.raises(NotImplementedError, match="K4"):
        F.render_rays_fused({k: v.requires_grad_(True) for k, v in params.items()}, rays, z, ncfg)
    assert F.RENDER_TRAIN.launches == before + 2


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
    C.chamfer_loss(xp, yp, force_plain=True).backward()
    assert torch.equal(xg.grad, xp.grad) and torch.equal(yg.grad, yp.grad)
    with pytest.raises(NotImplementedError, match="8192"):
        C.nearest_idx_bidirectional(torch.zeros(8193, 3, device=cuda_device), y)


# ---- the train step on the card -------------------------------------------------

def test_train_step_on_card_counts_launches_and_rejects_unfused(cuda_device):
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

    cfg["training"]["depth_loss_type"] = "invariant"
    mc_inv = ModelConfigs.from_cfg(cfg, 4)
    with pytest.raises(NotImplementedError, match="K4"):
        Trainer(cfg, mc_inv).step(state, batch_for_frame(scene, 0, ref_idx=1), 0, 10000)
