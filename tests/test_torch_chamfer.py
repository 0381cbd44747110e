"""Port parity for the Chamfer loss and its nearest-neighbour sweep (K2's plain
version) against nope_nerf_tpu's chamfer_loss(use_pallas=False), on the CPU.

The JAX sweep picks its winners from bf16 products, so winners among near-ties
differ from any f32 computation (PARITY.md). The clouds here are built without
near-ties (a jittered lattice, or a perturbed copy): then both sides match the
same pairs and the loss and its gradients agree at f32 tolerance (rtol 1e-5).
On general clouds the plain version is held to brute-force f32 distances by
the kernel's own rule: 13 of d2's 23 mantissa bits are masked, so the matched
distance may exceed the true minimum by 2^-10 relative (+1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.ops.chamfer import chamfer_loss as jax_chamfer

from nope_nerf_torch.ops import chamfer as C

torch.set_num_threads(2)


def _lattice_clouds(seed, n_side=5, jitter=0.1):
    """Two jittered copies of a unit lattice, the second shuffled and cut short:
    every nearest neighbour is at most 0.35 away, the runner-up at least 0.65."""
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(*[np.arange(float(n_side))] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = base + rng.uniform(-jitter, jitter, size=base.shape)
    y = base[rng.permutation(len(base))][:len(base) - 7]
    y = y + rng.uniform(-jitter, jitter, size=y.shape)
    return x.astype(np.float32), y.astype(np.float32)


def _brute(x, y):
    d = torch.cdist(x.double(), y.double())
    return d.min(dim=1).values, d.min(dim=0).values


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chamfer_loss_and_gradients_match_jax(seed):
    x, y = _lattice_clouds(seed)
    ref, (gx, gy) = jax.value_and_grad(lambda a, b: jax_chamfer(a, b, use_pallas=False),
                                       argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    got = C.chamfer_loss(tx, ty)
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), rtol=1e-5, atol=1e-7)


def test_indices_match_brute_force_without_near_ties():
    x, y = (torch.from_numpy(a) for a in _lattice_clouds(3, n_side=6))
    idx_xy, idx_yx = C.nearest_idx_bidirectional(x, y)
    d = torch.cdist(x.double(), y.double())
    assert idx_xy.dtype == idx_yx.dtype == torch.int64
    assert torch.equal(idx_xy, d.argmin(dim=1)) and torch.equal(idx_yx, d.argmin(dim=0))


@pytest.mark.parametrize("shape", [(700, 650), (33, 1500), (1, 5)])
def test_matched_distances_on_general_clouds(shape):
    """Random clouds have near-ties: hold the matched distance, not the index."""
    gen = torch.Generator().manual_seed(shape[0])
    x = torch.rand(shape[0], 3, generator=gen) * 6 - 3
    y = torch.rand(shape[1], 3, generator=gen) * 6 - 3
    idx_xy, idx_yx = C.nearest_idx_bidirectional_plain(x, y)
    best_x, best_y = _brute(x, y)
    d_x = (x - y[idx_xy]).double().norm(dim=1)
    d_y = (y - x[idx_yx]).double().norm(dim=1)
    assert bool((d_x - best_x <= 2.0 ** -10 * best_x + 1e-6).all())
    assert bool((d_y - best_y <= 2.0 ** -10 * best_y + 1e-6).all())


def test_coincident_points_have_finite_gradients():
    x = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], requires_grad=True)
    y = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.5, 0.0]], requires_grad=True)
    loss = C.chamfer_loss(x, y)
    loss.backward()
    np.testing.assert_allclose(float(loss), 0.5, rtol=1e-6)
    assert torch.isfinite(x.grad).all() and torch.isfinite(y.grad).all()


def test_large_clouds_and_bad_inputs():
    """Beyond 8,192 points the plain version widens its key and still serves the
    CPU; the CUDA route refuses such clouds before any device work."""
    gen = torch.Generator().manual_seed(9)
    x = torch.rand(9000, 3, generator=gen) * 20
    y = x[torch.randperm(9000, generator=gen)] + 1e-3
    idx_xy, idx_yx = C.nearest_idx_bidirectional(x, y)
    assert int(idx_xy.max()) > C.MAX_POINTS - 1 or int(idx_yx.max()) > C.MAX_POINTS - 1
    assert float((x - y[idx_xy]).norm(dim=1).max()) < 3e-3
    with pytest.raises(NotImplementedError, match="8192"):
        C._nearest_idx_cuda(x.to("meta"), y.to("meta"))
    with pytest.raises(ValueError):
        C.nearest_idx_bidirectional(torch.zeros(4, 2), torch.zeros(4, 3))
    with pytest.raises(ValueError):
        C.nearest_idx_bidirectional(torch.zeros(0, 3), torch.zeros(4, 3))
    with pytest.raises(NotImplementedError):
        C.nearest_idx_bidirectional(torch.zeros(4, 3, device="meta"),
                                    torch.zeros(4, 3, device="meta"))
