"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither JAX nor nope_nerf_tpu, so it also runs on a machine
that has only PyTorch; there the repository's conftest.py (which imports JAX)
is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance 2e-3 x max(1, max|plain|): the kernel and the plain version sum the
same bf16 products in another order (see chip_smoke.tolerance).
"""

import pytest
import torch

from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
from nope_nerf_torch.ops import fused_render as F

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
