"""Port parity: the NeRF MLP (models/nerf.py) and the fused kernel's weight
packing against nope_nerf_tpu, at hidden width 128.

Tolerances: float32 rtol 1e-5 (exact-f32 products, sums in another order);
bfloat16 2e-3 x max|ref|: both sides round the same operands to bf16 and sum
in f32, but in another order, so an activation now and then rounds to the
neighbouring bf16 value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.models import nerf as jnerf
from nope_nerf_tpu.ops.pallas_mlp import pack_weights as jpack_weights

from nope_nerf_torch.models import nerf as tnerf
from nope_nerf_torch.ops.fused_render import pack_weights as tpack_weights

torch.set_num_threads(2)
HIDDEN = 128


def _params(cfg, seed=0):
    jp = jnerf.init_nerf_params(jax.random.key(seed), cfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _points(seed, m=256, scale=3.0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(m, 3)) * scale).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("levels", [4, 10])
def test_encode_position(levels):
    x, _ = _points(0, 32)
    np.testing.assert_allclose(
        tnerf.encode_position(torch.from_numpy(x), levels).numpy(),
        np.asarray(jnerf.encode_position(jnp.asarray(x), levels)), rtol=0, atol=2e-6)


@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_nerf_apply_float32(occ, dist_alpha):
    cfg = dict(hidden_dim=HIDDEN, occ_activation=occ, dist_alpha=dist_alpha,
               compute_dtype="float32")
    jp, tp = _params(jnerf.NerfConfig(**cfg))
    pts, d = _points(1)
    rgb_j, den_j = jnerf.nerf_apply(jp, jnp.asarray(pts), jnp.asarray(d), jnerf.NerfConfig(**cfg))
    rgb_t, den_t = tnerf.nerf_apply(tp, torch.from_numpy(pts), torch.from_numpy(d),
                                    tnerf.NerfConfig(**cfg))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(den_t.numpy(), np.asarray(den_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tnerf.nerf_density(tp, torch.from_numpy(pts), tnerf.NerfConfig(**cfg)).numpy(),
        np.asarray(den_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("occ", ["softplus", "relu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_nerf_apply_bfloat16(occ, seed):
    cfg = dict(hidden_dim=HIDDEN, occ_activation=occ, compute_dtype="bfloat16")
    jp, tp = _params(jnerf.NerfConfig(**cfg), seed)
    pts, d = _points(seed + 5)
    rgb_j, den_j = jnerf.nerf_apply(jp, jnp.asarray(pts), jnp.asarray(d), jnerf.NerfConfig(**cfg))
    rgb_t, den_t = tnerf.nerf_apply(tp, torch.from_numpy(pts), torch.from_numpy(d),
                                    tnerf.NerfConfig(**cfg))
    for got, ref in ((rgb_t, rgb_j), (den_t, den_j)):
        ref = np.asarray(ref)
        assert np.max(np.abs(got.numpy() - ref)) <= 2e-3 * max(1e-3, np.abs(ref).max())


@pytest.mark.parametrize("white", [False, True])
def test_init_params_layout_and_constants(white):
    cfg = dict(hidden_dim=HIDDEN, white_background=white)
    jp = jnerf.init_nerf_params(jax.random.key(0), jnerf.NerfConfig(**cfg))
    tp = tnerf.init_nerf_params(tnerf.NerfConfig(**cfg), torch.Generator().manual_seed(0),
                                device="cpu")
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tp[k].dtype == torch.float32
    np.testing.assert_array_equal(tp["density_b"].numpy(), np.asarray(jp["density_b"]))
    np.testing.assert_array_equal(tp["rgb_b"].numpy(), np.asarray(jp["rgb_b"]))
    for k in ("trunk0_0_w", "trunk1_0_w", "rgb_hidden_w"):   # U(-1/sqrt(fan_in), +)
        bound = 1.0 / np.sqrt(jp[k].shape[0])
        assert float(tp[k].abs().max()) <= bound
        assert float(tp[k].abs().max()) > 0.9 * bound


def test_init_params_seeded():
    cfg = tnerf.NerfConfig(hidden_dim=HIDDEN)
    a = tnerf.init_nerf_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tnerf.init_nerf_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_from_cfg_matches():
    from nope_nerf_tpu.config import load_config
    for overrides in ({}, {"model": {"hidden_dim": 96}, "tpu": {"use_pallas_renderer": False}},
                      {"rendering": {"dist_alpha": True, "white_background": True}}):
        cfg = load_config(overrides=overrides)
        assert dataclasses.asdict(tnerf.NerfConfig.from_cfg(cfg)) == \
            dataclasses.asdict(jnerf.NerfConfig.from_cfg(cfg))


@pytest.mark.parametrize("hidden", [128, 256])
def test_pack_weights_matches_jax(hidden):
    cfg = dict(hidden_dim=hidden, use_pallas=True)
    jp, tp = _params(jnerf.NerfConfig(**cfg))
    Wj, Bj = jpack_weights(jp, jnerf.NerfConfig(**cfg))
    Wt, Bt = tpack_weights(tp, tnerf.NerfConfig(**cfg))
    assert len(Wt) == len(Wj) == 14 and len(Bt) == len(Bj) == 12
    for i, (wt, wj) in enumerate(zip(Wt, Wj)):
        wj = np.asarray(wj.astype(jnp.float32))
        wt = wt.to(torch.float32).t().numpy()       # the port stores (out, in)
        # JAX pads heads to 128 lanes, the port to 8: compare the port's part
        np.testing.assert_array_equal(wt, wj[:wt.shape[0], :wt.shape[1]], err_msg=str(i))
        assert not wj[:, wt.shape[1]:].any() and not wj[wt.shape[0]:].any()
    for i, (bt, bj) in enumerate(zip(Bt, Bj)):
        bj = np.asarray(bj)[0]
        np.testing.assert_array_equal(bt.numpy(), bj[:bt.shape[0]], err_msg=str(i))
        assert not bj[bt.shape[0]:].any()
