"""Port parity for the one-direction nearest-neighbour sweep (K7's plain
version `nearest_idx_plain`), `nearest_dists` with its VJP, and chamfer_loss
above the 8,192-point gate, against nope_nerf_tpu on the CPU.

The JAX package's XLA routes pick their winners from bf16 distances, K7 from
f32 ones, so among near-ties the two differ (PARITY.md). The clouds of the fast
tests are jittered lattices without near-ties: every nearest neighbour lies
within 0.35, the runner-up beyond 0.65. There the indices are equal and the
distances and gradients agree at f32 tolerance (rtol 1e-5). The slow test
holds the port against the Pallas kernel itself (interpret mode) on general
random clouds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.ops.chamfer import _nearest_idx_bidirectional as jax_bidir
from nope_nerf_tpu.ops.chamfer import chamfer_loss as jax_chamfer
from nope_nerf_tpu.ops.chamfer import nearest_dists as jax_nearest_dists

from nope_nerf_torch.ops import chamfer as C
from nope_nerf_torch.ops import nearest_dists

torch.set_num_threads(2)


def _lattice_clouds(seed, n_side, jitter=0.1):
    """Two jittered copies of a unit lattice, the second shuffled and cut short."""
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(*[np.arange(float(n_side))] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = base + rng.uniform(-jitter, jitter, size=base.shape)
    y = base[rng.permutation(len(base))][:len(base) - 7]
    y = y + rng.uniform(-jitter, jitter, size=y.shape)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("seed,n_side", [(0, 5), (1, 7), (2, 9)])
def test_nearest_idx_and_dists_match_jax(seed, n_side):
    x, y = _lattice_clouds(seed, n_side)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    j_xy, j_yx = jax_bidir(jnp.asarray(x), jnp.asarray(y), 512)
    d2_xy, i_xy = C.nearest_idx_plain(tx, ty)
    _, i_yx = C.nearest_idx_plain(ty, tx)
    assert i_xy.dtype == torch.int64 and d2_xy.dtype == torch.float32
    assert np.array_equal(i_xy.numpy(), np.asarray(j_xy))
    assert np.array_equal(i_yx.numpy(), np.asarray(j_yx))
    # nearest_idx on a CPU tensor is the plain version
    d2_b, i_b = C.nearest_idx(tx, ty)
    assert torch.equal(i_b, i_xy) and torch.equal(d2_b, d2_xy)
    # d2 against the matched pair's exact squared distance (no clamp: may be
    # below it by the rounding of |x|^2 + |y|^2 - 2<x,y>)
    exact = ((tx.double() - ty.double()[i_xy]) ** 2).sum(dim=1)
    scale = (tx.double() ** 2).sum(1) + (ty.double()[i_xy] ** 2).sum(1)
    assert bool(((d2_xy.double() - exact).abs() <= 8 * 2.0 ** -24 * scale).all())

    got = nearest_dists(tx, ty)
    want = jax_nearest_dists(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("seed,n_side", [(3, 6), (4, 8)])
def test_nearest_dists_gradients_match_jax(seed, n_side):
    x, y = _lattice_clouds(seed, n_side)
    w = np.random.default_rng(seed + 10).uniform(0.5, 1.5, size=len(x)).astype(np.float32)
    gx, gy = jax.grad(lambda a, b: jnp.sum(jnp.asarray(w) * jax_nearest_dists(a, b)),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    (torch.from_numpy(w) * nearest_dists(tx, ty)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), rtol=1e-5, atol=1e-7)


def test_chamfer_loss_above_the_gate_matches_jax():
    """21^3 = 9,261 lattice points: above 8,192, so K7's route, twice."""
    x, y = _lattice_clouds(5, 21)
    assert min(len(x), len(y)) > C.MAX_POINTS
    ref, (gx, gy) = jax.value_and_grad(lambda a, b: jax_chamfer(a, b, use_pallas=False),
                                       argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    got = C.chamfer_loss(tx, ty)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n,k7_calls,k2_calls", [(C.MAX_POINTS + 1, 2, 0), (C.MAX_POINTS, 0, 1)])
def test_chamfer_loss_routes_by_cloud_size(monkeypatch, n, k7_calls, k2_calls):
    calls = {"k7": 0, "k2": 0}
    k7_plain, k2_plain = C.nearest_idx_plain, C.nearest_idx_bidirectional_plain

    def count_k7(*a):
        calls["k7"] += 1
        return k7_plain(*a)

    def count_k2(*a):
        calls["k2"] += 1
        return k2_plain(*a)

    monkeypatch.setattr(C, "nearest_idx_plain", count_k7)
    monkeypatch.setattr(C, "nearest_idx_bidirectional_plain", count_k2)
    gen = torch.Generator().manual_seed(n)
    x = torch.rand(n, 3, generator=gen)
    y = torch.rand(40, 3, generator=gen)
    loss = C.chamfer_loss(x, y)
    assert torch.isfinite(loss)
    assert calls == {"k7": k7_calls, "k2": k2_calls}


def test_nearest_idx_ties_bad_inputs_and_devices():
    # exact ties: the lowest index wins, across chunk borders too
    y = torch.zeros(2 * C.PLAIN_CHUNK + 5, 3)
    y[:, 0] = 1.0
    d2, idx = C.nearest_idx(torch.zeros(4, 3), y)
    assert idx.tolist() == [0, 0, 0, 0] and d2.tolist() == [1.0] * 4
    y[C.PLAIN_CHUNK + 3, 0] = 0.5
    y[2 * C.PLAIN_CHUNK + 1, 0] = 0.5
    assert C.nearest_idx(torch.zeros(1, 3), y)[1].tolist() == [C.PLAIN_CHUNK + 3]
    with pytest.raises(ValueError):
        C.nearest_idx(torch.zeros(4, 2), torch.zeros(4, 3))
    with pytest.raises(ValueError):
        C.nearest_idx(torch.zeros(4, 3), torch.zeros(0, 3))
    with pytest.raises(NotImplementedError):
        C.nearest_idx(torch.zeros(4, 3, device="meta"), torch.zeros(4, 3, device="meta"))


def test_nearest_dists_coincident_points_have_finite_gradients():
    x = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], requires_grad=True)
    y = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.5, 0.0]], requires_grad=True)
    d = nearest_dists(x, y)
    d.sum().backward()
    np.testing.assert_allclose(d.detach().numpy(), [0.0, 0.5], atol=1e-7)
    assert torch.isfinite(x.grad).all() and torch.isfinite(y.grad).all()
    assert x.grad[0].abs().sum() == 0


@pytest.mark.slow
def test_against_the_pallas_kernel_in_interpret_mode():
    """General random clouds (700 x 900, as tests/test_pallas_chamfer.py): the
    Pallas kernel sums d2 in its own order, so near-ties may pick another
    winner. Where the indices agree, d2 matches up to the cancellation in
    |x|^2 + |y|^2 - 2<x,y> (8 f32 ulps of |x|^2 + |y|^2) and the distances at
    rtol 1e-5; the VJP is held on the rows and dst points whose matches agree."""
    from jax.experimental.pallas import tpu as pltpu

    from nope_nerf_tpu.ops.pallas_chamfer import _nearest_idx, nearest_dists_pallas

    rng = np.random.RandomState(0)
    x = rng.randn(700, 3).astype(np.float32)
    y = rng.randn(900, 3).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=700).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        j_d2, j_idx = (np.asarray(a) for a in _nearest_idx(jnp.asarray(x), jnp.asarray(y)))
        j_dist = np.asarray(nearest_dists_pallas(jnp.asarray(x), jnp.asarray(y)))
        gx, gy = (np.asarray(g) for g in jax.grad(
            lambda a, b: jnp.sum(jnp.asarray(w) * nearest_dists_pallas(a, b)),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y)))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    d2, idx = C.nearest_idx_plain(tx, ty)
    dist = nearest_dists(tx, ty)
    (torch.from_numpy(w) * dist).sum().backward()

    agree = idx.numpy() == j_idx
    assert agree.mean() >= 0.99, agree.mean()
    scale = (x ** 2).sum(1) + (y[j_idx] ** 2).sum(1)
    assert np.all(np.abs(d2.detach().numpy() - j_d2)[agree]
                  <= 1e-5 * np.abs(j_d2[agree]) + 8 * 2.0 ** -24 * scale[agree])
    np.testing.assert_allclose(dist.detach().numpy()[agree], j_dist[agree], rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy()[agree], gx[agree], rtol=1e-5, atol=1e-7)
    clean = np.ones(900, bool)
    clean[idx.numpy()[~agree]] = False
    clean[j_idx[~agree]] = False
    np.testing.assert_allclose(ty.grad.numpy()[clean], gy[clean], rtol=1e-5, atol=1e-7)
