"""hidden_dim 640 to 1024 on K6 full (the point-query MLP backward with every
weight gradient), on the CPU, where K6 full (csrc/point_mlp_bwd.cu's xwide
kernel on the card: csrc/mlp_dx_xwide_sm90.cuh's chain in passes of 128
columns with csrc/mlp_dw_chain_sm90.cuh's OperandSaveX, and the dW kernel's
column pieces in two launches) runs as its plain version:

(i)   point_mlp_bwd_plain(want_param_grads=True) on 200 points against
      jax.grad of nerf_apply_fused with respect to the params, the points and
      the directions, its Pallas kernels in interpret mode, both flag sets the
      card's checks use, on the cotangents of a smooth loss of the forward's
      own outputs (tests/test_torch_wide_full_backward.py's); d(points) and
      d(directions) by the per-sample rule of PERF.md section 2 and equal to
      the frozen plain call's bit for bit;
(ii)  the dW kernel's work table at 640, 768, 896 and 1024 (point_dw_pieces,
      the mirror of chain_dw_pieces' column split): each block's columns
      covered once by pieces of 64, 128 or 256 columns, 34, 34, 46 and 44
      pieces, two launches of at most DW_MAX_PIECES each
      (point_dw_launches, chain_dw_launch's cut), and dw_plain over each
      piece's columns of the operands the plain backward forms giving those
      columns of the block;
(iii) one hierarchical train step (rendering.n_importance > 0, the unfused
      route through point_mlp) at hidden_dim 640 against the JAX package's,
      nerf_apply_fused in interpret mode, the draws pinned;
(iv)  the dW kernel's chunks past 512 (point_dw_chunks: no chunk sums more
      than DW_XWIDE_CHUNK_TILES row tiles there, dw_chunks' rule at 128 to
      512), and chip_smoke.check_wide_full's reference on the CPU with the
      kernel stood in for: the plain version, or the plain version summed in
      f64 where the f32 plain version itself strays beyond the rule, and a
      kernel that strays fails either way.

The 1024 case of (i) and the train step (iii) are marked slow (`-m slow`):
the interpreted Pallas kernels take tens of seconds there. Tolerances,
PERF.md section 2's bf16 class: the dW and dB blocks within 2e-2 of each
block's largest entry for the kernel's function, 5e-2 for a train step's
gradients (the render and the losses around the MLP), the loss dict rtol
2e-3; d(points) and d(directions) by the per-sample rule (L2 within 2e-2,
at most 1 entry in 1000 off by more than 2e-2 of the largest; under 1000
entries the L2 part alone), which tests/test_torch_xwide_backward.py
explains at these widths.
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

import chip_smoke

torch.set_num_threads(2)
FLAGS = [("softplus", False), ("relu", True)]   # (occupancy, head dist_alpha)
WIDTHS = [640, pytest.param(1024, marks=pytest.mark.slow)]
PIECES = {640: 34, 768: 34, 896: 46, 1024: 44}


def _assert_block(name, got, ref, rel):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0 and got.shape == ref.shape, name
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale + 1e-6, f"{name}: err {err} vs largest {scale}"


def _assert_per_sample(name, got, ref):
    """The per-sample rule: L2 within 2e-2, and at most 1 entry in 1000 off by
    more than 2e-2 of the largest entry (none counted under 1000 entries)."""
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert np.isfinite(got).all() and scale > 0 and got.shape == ref.shape, name
    l2 = float(np.linalg.norm(got - ref)) / float(np.linalg.norm(ref))
    assert l2 <= 2e-2, f"{name}: L2 {l2}"
    if ref.size >= 1000:
        off = int((np.abs(got - ref) > 2e-2 * scale + 1e-6).sum())
        assert off <= ref.size // 1000, f"{name}: {off} entries off by more than 2e-2 of {scale}"


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
@pytest.mark.parametrize("D", WIDTHS)
def test_xwide_full_point_backward_matches_pallas_vjp(D, occ, dist_alpha):
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
    _assert_per_sample("points", dpts.numpy(), r_pts)
    _assert_per_sample("directions", ddirs.numpy(), r_dirs)
    frozen = FM.point_mlp_bwd_plain(*args, want_param_grads=False)
    assert torch.equal(frozen[2], dpts) and torch.equal(frozen[3], ddirs)


def _magnitude(x, g):
    """Per entry of x^T g, the sum of its products' magnitudes (f64)."""
    return np.abs(x.astype(np.float64)).T @ np.abs(g.astype(np.float64))


@pytest.mark.parametrize("D", [640, 768, 896, 1024])
def test_xwide_dw_pieces_cover_every_block(D):
    """(ii) point_dw_pieces past 512: each block of point_dw_table split into
    column pieces of 256, then 128, then 64, covering its columns once; the
    piece counts, and the two launches of at most DW_MAX_PIECES pieces the
    table takes; dw_plain over a piece's columns of the plain backward's
    operands is those columns of the block."""
    pieces = FM.point_dw_pieces(D)
    table = FM.point_dw_table(D)
    assert len(pieces) == PIECES[D]
    assert FM.point_dw_launches(D) == 2
    assert (FM.point_dw_launches(D) - 1) * FM.DW_MAX_PIECES < len(pieces)
    assert len(pieces) <= FM.point_dw_launches(D) * FM.DW_MAX_PIECES
    for wi, xname, gname, K, N in table:
        mine = [(c0, n) for w, x, g, k, c0, n in pieces if w == wi]
        assert all(x == xname and g == gname and k == K
                   for w, x, g, k, _, _ in pieces if w == wi)
        assert all(n in (64, 128, 256) for _, n in mine)
        cols = [c for c0, n in mine for c in range(c0, c0 + n)]
        assert cols == list(range(N)), (wi, mine)
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
def test_hierarchical_train_step_at_640_matches_jax():
    """(iii) one train step with n_importance 16 at hidden_dim 640 on the
    kernels' route (use_pallas, bf16): the port's K5 and K6 full plain
    versions against nerf_apply_fused and its VJP in interpret mode, from a
    converted state with JAX's draws: the loss dict and every gradient."""
    n_rays, steps, n_imp = 16, 32, 16
    overrides = {"model": {"hidden_dim": 640},
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
    assert mc.nerf.use_pallas and mc.nerf.hidden_dim == 640
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


@pytest.mark.parametrize("D", [256, 512, 640, 1024])
def test_xwide_dw_chunks(D):
    """(iv) K6 full's dW chunks: dw_chunks' below 640; past 512 each chunk
    sums at most DW_XWIDE_CHUNK_TILES row tiles (24 chunks at the fine pass's
    196,608 points), never more chunks than row tiles."""
    tiles = FM.dw_cta_tiles(k for _, _, _, k, _, _ in FM.point_dw_pieces(D))
    for M in (1, 129, 8192, 196_608, 196_645):
        nt = -(-M // FM.DW_ROWS)
        chunks = FM.point_dw_chunks(D, tiles, M, 132)
        assert 1 <= chunks <= nt
        if D <= 512:
            assert chunks == FM.dw_chunks(tiles, M, 132)
        else:
            assert -(-nt // chunks) <= FM.DW_XWIDE_CHUNK_TILES
    if D > 512:
        assert FM.point_dw_chunks(D, tiles, 196_608, 132) == 24


@pytest.mark.parametrize("stray", [None, "plain", "kernel"])
def test_full_hold_takes_the_f64_sum_where_the_plain_version_strays(monkeypatch, capsys, stray):
    """(iv) check_wide_full on the CPU at 128, one and three points, the
    kernel stood in for by the plain version summed in f64: it holds against
    the f32 plain version; where the f32 plain version strays beyond the rule
    (one dW block off by 10%) it holds against the f64 sum instead, and says
    so; a kernel off by as much fails whatever the reference."""
    plain = FM.point_mlp_bwd_plain

    def spoil(out):
        dWs = list(out[0])
        dWs[1] = dWs[1] * 1.1
        return (dWs, out[1], out[2], out[3])

    def kernel(params, pts, dirs, g_rgb, g_den, cfg, want_param_grads=True):
        out = plain(params, pts, dirs, g_rgb, g_den, cfg, want_param_grads, dtype=torch.float64)
        out = ([w.float() for w in out[0]] if out[0] is not None else None,
               [b.float() for b in out[1]] if out[1] is not None else None,
               out[2].float(), out[3].float())
        return spoil(out) if stray == "kernel" and want_param_grads else out

    def plain_version(*args, dtype=torch.float32, **kw):
        out = plain(*args, dtype=dtype, **kw)
        return spoil(out) if stray == "plain" and dtype == torch.float32 else out

    monkeypatch.setattr(FM, "_mlp_bwd_cuda", kernel)
    monkeypatch.setattr(FM, "point_mlp_bwd_plain", plain_version)
    monkeypatch.setattr(chip_smoke, "WIDE_FULL_M", (1, 3))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    dev = torch.device("cpu")
    if stray == "kernel":
        with pytest.raises(RuntimeError, match="disagrees with its plain version"):
            chip_smoke.check_wide_full(torch, dev, (128,))
    else:
        assert set(chip_smoke.check_wide_full(torch, dev, (128,))) == {128}
    out = capsys.readouterr().out
    assert out.count("point_mlp_bwd vs ") == 4
    assert out.count("point_mlp_bwd vs the f64 sum") == (4 if stray == "plain" else 0)
