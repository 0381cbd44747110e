"""hidden_dim 384 and 512 on K6 full (the point-query MLP backward with every
weight gradient), on the CPU, where K6 full (csrc/point_mlp_bwd.cu's wide
kernel on the card: csrc/mlp_dx_wide_sm90.cuh's 64-point chain with
csrc/mlp_dw_chain_sm90.cuh's OperandSaveW and the dW kernel's column
pieces) runs as its plain version:

(i)   point_mlp_bwd_plain(want_param_grads=True) on 200 points against
      jax.grad of nerf_apply_fused with respect to the params, the points and
      the directions, its Pallas kernels in interpret mode, both flag sets the
      card's checks use, on the cotangents of a smooth loss of the forward's
      own outputs (chip_smoke.point_cotangents': noise cotangents make each
      bias gradient a random walk over the points, which one ReLU mask
      flipped at one point by another f32 summation order moves by 5% of its
      largest entry at 512); d(points) and d(directions) by the per-sample
      rule of PERF.md section 2 (the L2 part: 600 entries; one flipped mask
      at one point moves that point's entries by 7% of the block's largest
      at 512, and nothing averages it away), and equal to the frozen plain
      call's bit for bit, which tests/test_torch_wide_backward.py holds
      against the same VJP entry by entry;
(ii)  the dW kernel's work table at every width (point_dw_pieces, the mirror
      of chain_dw_pieces' column split): each block's columns covered once
      by pieces of 64, 128 or 256 columns, no more pieces than the kernel
      takes, and dw_plain over each piece's columns of the operands the plain
      backward forms giving those columns of the block;
(iii) one hierarchical train step (rendering.n_importance > 0, the unfused
      route through point_mlp) at hidden_dim 384 against the JAX package's,
      nerf_apply_fused in interpret mode, the draws pinned.

The 512 case of (i) and the train step (iii) are marked slow (`-m slow`): the
interpreted Pallas kernels take 10 to 60 s there. Tolerances, PERF.md
section 2's bf16 class: gradients within 2e-2 of each block's largest entry
for the kernel's function, 5e-2 for a train step's gradients (the render
and the losses around the MLP), the loss dict rtol 2e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nope_nerf_tpu.config import load_config as jax_load_config
from nope_nerf_tpu.data import SceneData as JSceneData, batch_for_frame as jax_batch
from nope_nerf_tpu.data import make_synthetic_scene
from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.training import ModelConfigs as JModelConfigs
from nope_nerf_tpu.training import compute_step_loss as jax_step_loss
from nope_nerf_tpu.training import create_train_state as jax_create

from nope_nerf_torch.config import load_config
from nope_nerf_torch.convert import params_from_numpy
from nope_nerf_torch.data import SceneData, batch_for_frame
from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.models.nerf import init_nerf_params as init_torch_params
from nope_nerf_torch.ops import fused_mlp as FM
from nope_nerf_torch.ops import fused_render as F
from nope_nerf_torch.training import ModelConfigs, Trainer
from nope_nerf_torch.training.trainer import step_gradients

torch.set_num_threads(2)
FLAGS = [("softplus", False), ("relu", True)]   # (occupancy, head dist_alpha)
WIDTHS = [384, pytest.param(512, marks=pytest.mark.slow)]


def _assert_block(name, got, ref, rel):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0 and got.shape == ref.shape, name
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale + 1e-6, f"{name}: err {err} vs largest {scale}"


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
@pytest.mark.parametrize("D", WIDTHS)
def test_full_point_backward_matches_pallas_vjp(D, occ, dist_alpha):
    """(i) every dW and dB block, d(points) and d(directions) of K6 full's
    plain version against the VJP of nerf_apply_fused in interpret mode."""
    from nope_nerf_tpu.ops.pallas_mlp import nerf_apply_fused

    m = 200
    jc = JNerfConfig(hidden_dim=D, compute_dtype="bfloat16", occ_activation=occ,
                     dist_alpha=dist_alpha, use_pallas=True)
    tc = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=dist_alpha, use_pallas=True)
    jp = init_nerf_params(jax.random.key(D + 13), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(D + 13)
    pts = (rng.normal(size=(m, 3)) * 2.0).astype(np.float32)
    dirs = rng.normal(size=(m, 3)).astype(np.float32)
    # mean over the points of |rgb - 0.5|^2 / 3 + 0.1 density
    rgb, _ = FM.point_mlp_fwd_plain(tp, torch.from_numpy(pts), torch.from_numpy(dirs), tc)
    g_rgb = (2.0 / (3 * m) * (rgb.numpy() - 0.5)).astype(np.float32)
    g_den = np.full((m, 1), 0.1 / m, np.float32)

    def f(p, x, d):
        rgb, den = nerf_apply_fused(p, x, d, jc)
        return jnp.sum(rgb * g_rgb) + jnp.sum(den * g_den)

    with pltpu.force_tpu_interpret_mode():
        r_params, r_pts, r_dirs = jax.grad(f, argnums=(0, 1, 2))(jp, jnp.asarray(pts),
                                                                  jnp.asarray(dirs))
    args = (tp, torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(g_rgb),
            torch.from_numpy(g_den), tc)
    dWs, dBs, dpts, ddirs = FM.point_mlp_bwd_plain(*args)
    grads = F.unpack_grads(dWs, dBs, tc)
    assert set(grads) == set(r_params)
    for k, r in r_params.items():
        _assert_block(k, grads[k].numpy(), r, 2e-2)
    for name, got, r in (("points", dpts.numpy(), r_pts), ("directions", ddirs.numpy(), r_dirs)):
        r = np.asarray(r)
        assert np.isfinite(got).all() and got.shape == r.shape, name
        assert np.linalg.norm(got - r) <= 2e-2 * np.linalg.norm(r), name
    frozen = FM.point_mlp_bwd_plain(*args, want_param_grads=False)
    assert torch.equal(frozen[2], dpts) and torch.equal(frozen[3], ddirs)


def _magnitude(x, g):
    """Per entry of x^T g, the sum of its products' magnitudes (f64)."""
    return np.abs(x.astype(np.float64)).T @ np.abs(g.astype(np.float64))


@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_dw_pieces_cover_every_block(D):
    """(ii) point_dw_pieces: each block of point_dw_table split into column
    pieces of 256, then 128, then 64, covering its columns once, at most
    DW_MAX_PIECES of them (24 at 384, 22 at 512, one a block at 128 and
    256); dw_plain over a piece's columns of the plain backward's operands is
    those columns of the block."""
    pieces = FM.point_dw_pieces(D)
    table = FM.point_dw_table(D)
    assert len(pieces) <= FM.DW_MAX_PIECES
    assert len(pieces) == {128: 12, 256: 12, 384: 24, 512: 22}[D]
    for wi, xname, gname, K, N in table:
        mine = [(c0, n) for w, x, g, k, c0, n in pieces if w == wi]
        assert all(x == xname and g == gname and k == K
                   for w, x, g, k, _, _ in pieces if w == wi)
        assert all(n in (64, 128, 256) for _, n in mine)
        cols = [c for c0, n in mine for c in range(c0, c0 + n)]
        assert cols == list(range(N)), (wi, mine)
        if D <= 256:
            assert mine == [(0, N)]
    m = 131
    tc = NerfConfig(hidden_dim=D, use_pallas=True)
    tp = init_torch_params(tc, torch.Generator().manual_seed(D), device="cpu")
    rng = np.random.default_rng(D)
    pts, dirs, g_rgb = (torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
                        for _ in range(3))
    g_den = torch.from_numpy(rng.normal(size=(m, 1)).astype(np.float32))
    dWs, _, _, _ = FM.point_mlp_bwd_plain(tp, pts, dirs, g_rgb, g_den, tc)
    X, G = FM.point_mlp_dw_operands(tp, pts, dirs, g_rgb, g_den, tc)
    for wi, xname, gname, K, c0, n in pieces:
        x, g = X[xname], G[gname][:, c0:c0 + n]
        got = FM.dw_plain(x, g).numpy()
        ref = dWs[wi][:, c0:c0 + n].numpy()
        tol = 1e-5 * _magnitude(x.numpy(), g.numpy())
        assert np.all(np.abs(got - ref) <= tol), (wi, c0, float(np.abs(got - ref).max()))


def jax_draws(key, n, steps, n_importance):
    """(stratified noise (n, steps), fine draw (n, n_importance)) that JAX's
    render_nope_nerf takes from `key` (tests/test_torch_hierarchical.py's)."""
    k0, knoise, _ = jax.random.split(key, 3)
    noise = jax.random.uniform(knoise, (n, steps), jnp.float32)
    u = jax.random.uniform(jax.random.fold_in(k0, 1), (n, n_importance), jnp.float32,
                           0.0, 1.0 - 1e-5)
    return np.array(noise), np.array(u)


@pytest.mark.slow
def test_hierarchical_train_step_at_384_matches_jax():
    """(iii) one train step with n_importance 16 at hidden_dim 384 on the
    kernels' route (use_pallas, bf16): the port's K5 and K6 full plain
    versions against nerf_apply_fused and its VJP in interpret mode, from a
    converted state with JAX's draws: the loss dict and every gradient."""
    n_rays, steps, n_imp = 16, 32, 16
    overrides = {"model": {"hidden_dim": 384},
                 "rendering": {"num_points": steps, "n_importance": n_imp},
                 "training": {"n_training_points": n_rays},
                 "pose": {"learn_pose": True, "init_pose": True}}
    scene_np = dict(make_synthetic_scene(n_frames=4, h=12, w=16))
    jcfg = jax_load_config(overrides=overrides)
    jscene = JSceneData.from_dict(scene_np)
    jmc = JModelConfigs.from_cfg(jcfg, 4)
    assert jmc.nerf.use_pallas and jmc.render.n_importance == n_imp
    jstate, _ = jax_create(jax.random.key(0), jmc, init_c2w=jnp.asarray(jscene.c2ws_gt))
    cfg = load_config(overrides=overrides)
    mc = ModelConfigs.from_cfg(cfg, 4)
    assert mc.nerf.use_pallas and mc.nerf.hidden_dim == 384
    weights = Trainer(cfg, mc).weights_at(0, 10000)

    ray_idx = np.random.default_rng(5).permutation(12 * 16)[:n_rays].astype(np.int32)
    key = jax.random.key(11)
    batch = {k: jnp.asarray(v) for k, v in jax_batch(jscene, 0, ref_idx=1).items()}
    w = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
    with pltpu.force_tpu_interpret_mode():
        g_ref, ld_ref = jax.grad(jax_step_loss, has_aux=True)(jstate.params, batch, w,
                                                              jnp.asarray(ray_idx), key, jmc,
                                                              "l1")
    noise, u = jax_draws(key, n_rays, steps, n_imp)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    scene = SceneData.from_dict(scene_np).to_device("cpu")
    g, ld = step_gradients(params, batch_for_frame(scene, 0, ref_idx=1), weights,
                           torch.from_numpy(ray_idx).long(), None, mc, "l1",
                           noise=torch.from_numpy(noise), fine_u=torch.from_numpy(u))
    assert set(ld) == set(ld_ref)
    for k in ld_ref:
        np.testing.assert_allclose(float(ld[k]), float(ld_ref[k]), rtol=2e-3, atol=1e-7,
                                   err_msg=k)
    for grp in g_ref:
        for k, r in g_ref[grp].items():
            r = np.asarray(r)
            if not r.size:
                continue
            err = float(np.max(np.abs(g[grp][k].numpy() - r)))
            assert err <= 5e-2 * float(np.max(np.abs(r))) + 1e-7, f"{grp}/{k}: {err}"
    assert float(np.abs(g["nerf"]["trunk0_0_w"].numpy()).max()) > 0
