"""The weight-gradient kernel's plain version (ops/fused_mlp.py::dw_plain) and
the operands K6 full hands it, on the CPU, at hidden width 128 and a ragged
M of 300 points (no multiple of the kernel's 128-row tiles).

- dw_plain against the JAX package's `_dmat` (pallas_mlp.py:197, the TPU
  kernel's dW = x^T g) on the same bf16-rounded operands: both sum exact f32
  products in f32 in their own orders, so within 1e-5 of the sum of the
  products' magnitudes.
- dw_plain over the operands the plain backward forms (point_mlp_dw_operands)
  against point_mlp_bwd_plain's dW blocks, for every block of K6's work table
  and each {softplus, relu} x dist_alpha case: the same products summed in
  another order, within 1e-5 of the sum of magnitudes.
- Chunk counts 1, 3 and 7 agree within f32 round-off, and one chunk count
  gives the same bits twice.
- tile_operand's layout: undone by its inverse, each element at its
  swizzled place, padding zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.ops import pallas_mlp

from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.ops import fused_mlp as FM

torch.set_num_threads(2)
HIDDEN = 128
M = 300
FLAGS = [("softplus", False), ("softplus", True), ("relu", False), ("relu", True)]


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def _operands(K, N, seed, m=M):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.normal(size=(m, K)).astype(np.float32)),
            _bf16(rng.normal(size=(m, N)).astype(np.float32)))


def _untile(t, m, c):
    """tile_operand's inverse: the (m, c) bf16 operand (the swizzle undoes itself)."""
    nt, cb = t.shape[0], t.shape[1]
    r = torch.arange(128)[:, None]
    idx = (torch.arange(8)[None, :] ^ (r % 8))[None, None, :, :, None].expand(nt, cb, 128, 8, 8)
    u = torch.gather(t.reshape(nt, cb, 128, 8, 8), 3, idx)
    return u.permute(0, 2, 1, 3, 4).reshape(nt * 128, cb * 64)[:m, :c]


def _magnitude(x, g):
    """The sum over the points of |x| |g|, per dW entry (f64)."""
    return np.abs(x.astype(np.float64)).T @ np.abs(g.astype(np.float64))


@pytest.mark.parametrize("K,N", [(64, 128), (128, 128), (128, 64), (32, 64)])
def test_dw_plain_matches_jax_dmat(K, N):
    x, g = _operands(K, N, seed=K + N)
    ref = np.asarray(pallas_mlp._dmat(jnp.asarray(x), jnp.asarray(g)))
    got = FM.dw_plain(torch.from_numpy(x), torch.from_numpy(g), chunks=3).numpy()
    assert got.shape == (K, N) and got.dtype == np.float32
    assert np.all(np.abs(got - ref) <= 1e-5 * _magnitude(x, g))


def _setup(occ, dist_alpha, seed=0):
    jc = JNerfConfig(hidden_dim=HIDDEN, compute_dtype="bfloat16", occ_activation=occ,
                     dist_alpha=dist_alpha, use_pallas=True)
    tc = NerfConfig(hidden_dim=HIDDEN, occ_activation=occ, dist_alpha=dist_alpha, use_pallas=True)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in init_nerf_params(jax.random.key(seed), jc).items()}
    rng = np.random.default_rng(seed)
    ins = [(rng.normal(size=(M, 3)) * 2.0).astype(np.float32),
           rng.normal(size=(M, 3)).astype(np.float32),
           rng.normal(size=(M, 3)).astype(np.float32),
           rng.normal(size=(M, 1)).astype(np.float32)]
    return tc, tp, [torch.from_numpy(a) for a in ins]


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
def test_dw_plain_over_k6_operands_matches_the_plain_backward(occ, dist_alpha):
    tc, tp, (pts, dirs, g_rgb, g_den) = _setup(occ, dist_alpha)
    dWs, _, _, _ = FM.point_mlp_bwd_plain(tp, pts, dirs, g_rgb, g_den, tc)
    X, G = FM.point_mlp_dw_operands(tp, pts, dirs, g_rgb, g_den, tc)
    table = FM.point_dw_table(HIDDEN)
    assert sorted(w for w, *_ in table) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12]
    for wi, xname, gname, K, N in table:
        x, g = X[xname], G[gname]
        assert tuple(x.shape) == (M, K) and tuple(g.shape) == (M, N), (wi, x.shape, g.shape)
        # the operands are bf16 values, as the chain writes them
        assert torch.equal(x, x.to(torch.bfloat16).to(torch.float32)), xname
        assert torch.equal(g, g.to(torch.bfloat16).to(torch.float32)), gname
        got = FM.dw_plain(x, g, chunks=FM.dw_chunks(12, M, 132)).numpy()
        ref = dWs[wi].numpy()
        tol = 1e-5 * _magnitude(x.numpy(), g.numpy())
        assert np.all(np.abs(got - ref) <= tol), (wi, float(np.abs(got - ref).max()))
    assert float(G["g0"].abs().max()) > 0 and float(G["g_h"].abs().max()) > 0


def test_dw_plain_chunk_counts_agree_and_repeat_bit_for_bit():
    x, g = (torch.from_numpy(a) for a in _operands(128, 64, seed=7, m=1000))
    one = FM.dw_plain(x, g, 1)
    mag = _magnitude(x.numpy(), g.numpy())
    for chunks in (3, 7):
        got = FM.dw_plain(x, g, chunks)
        assert np.all(np.abs(got.numpy() - one.numpy()) <= 1e-5 * mag), chunks
        assert torch.equal(got, FM.dw_plain(x, g, chunks))


def test_dw_chunks_rule():
    # one wave of (CTA tiles x chunks) over the SMs, at least 1, at most the row tiles
    assert FM.dw_chunks(21, 196_608, 132) == 6
    assert FM.dw_chunks(12, 196_608, 132) == 11
    assert FM.dw_chunks(21, 300, 132) == 3
    assert FM.dw_chunks(200, 196_608, 132) == 1
    assert FM.dw_cta_tiles(K for *_, K, _ in FM.point_dw_table(256)) == 21
    assert FM.dw_cta_tiles(K for *_, K, _ in FM.point_dw_table(128)) == 12
    bounds = FM._chunk_bounds(1000, 3)
    assert bounds[0][0] == 0 and bounds[-1][1] == 1000
    assert all(a % FM.DW_ROWS == 0 and b > a for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(2))


@pytest.mark.parametrize("m,c", [(1, 32), (127, 64), (300, 100), (256, 256)])
def test_tile_operand_layout(m, c):
    x = torch.from_numpy(np.random.default_rng(m + c).normal(size=(m, c)).astype(np.float32))
    t = FM.tile_operand(x)
    nt, cb = -(-m // 128), -(-c // 64)
    assert tuple(t.shape) == (nt, cb, 128, 64) and t.dtype == torch.bfloat16
    assert torch.equal(_untile(t, m, c), x.to(torch.bfloat16))
    rng = np.random.default_rng(0)
    for r, k in zip(rng.integers(0, m, 8), rng.integers(0, c, 8)):
        rr, kk = r % 128, k % 64
        assert t[r // 128, k // 64, rr, ((kk // 8) ^ (rr % 8)) * 8 + kk % 8] == x[r, k].to(torch.bfloat16)
    full = _untile(t, nt * 128, cb * 64)
    assert not full[m:].any() and not full[:, c:].any()
