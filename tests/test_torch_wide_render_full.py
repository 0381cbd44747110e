"""hidden_dim 384 and 512 on K1 (the render train step) and K4 full (the
render backward with every weight gradient), on the CPU, where the two
kernels (csrc/render_full_sm90.cuh's wide kernel on the card: the 64-point
chain of csrc/mlp_dx_wide_sm90.cuh with csrc/mlp_dw_chain_sm90.cuh's
OperandSaveW and the dW kernel's column pieces) run as their plain versions:

(i)   K1's plain version (render_ray_loss_fused_plain) against the JAX
      package's render_ray_loss_fused, its Pallas train kernel
      (_render_train_kernel) in interpret mode: total and loss sums, every
      dW and dB, d(rays), dz and d(target), 8 rays x 128 samples, both flag
      sets the card's checks use (each with the rgb loss power they use);
(ii)  K4 full's plain version (render_rays_fused_bwd_plain) against jax.vjp
      of render_rays_fused with respect to the params, the rays and z (its
      Pallas backward kernel, _render_bwd_kernel, in interpret mode), for the
      cotangents of an L2 colour and depth loss plus a term on every 7th
      weight and on one column of alpha;
(iii) one fused train step (the default config's route through
      render_ray_loss_fused) at hidden_dim 384 against the JAX package's,
      from a converted state with the draws pinned;
(iv)  the dW kernel's work table of the render kernels at every width
      (fused_mlp.render_dw_pieces, the mirror of chain_dw_pieces' column
      split without the direction block): each block's columns covered once,
      22 pieces at 384 and 21 at 512, and dw_plain over each piece's columns
      of the operands the plain backward forms giving those columns of K4
      full's plain dW;
(v)   render_operand_bytes and render_chunks at every width: the operand
      bytes a sample, one chunk for 1024 x 128 samples at 512, 3 chunks for
      1024 x 512 at 384 and 4 at 512, every chunk within the budget.

Inputs come from numpy seeds. The 512 cases of (i) and (ii) and the train
step (iii) are marked slow (`-m slow`): the interpreted Pallas kernels take
tens of seconds there. Tolerances, PERF.md section 2's bf16 class: values
within 2e-3 relative, gradients within 2e-2 of each block's largest entry
for the kernels' functions, 5e-2 for a train step's gradients (the render
and the losses around the kernel), the loss dict rtol 2e-3.
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
from nope_nerf_tpu.ops import pallas_render as jpr
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
# (occupancy, head and renderer dist_alpha, K1's rgb loss power): the card's pairs
FLAGS = [("softplus", False, 1), ("relu", True, 2)]
WIDTHS = [384, pytest.param(512, marks=pytest.mark.slow)]


def _assert_block(name, got, ref, rel=2e-2):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0 and got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale + 1e-6, f"{name}: err {err} vs largest {scale}"


def _case(D, occ, dist_alpha, n=8, S=128):
    """Seeded JAX params (the density bias lowered where occupancy would
    saturate within a few samples), rays from near the origin, sorted z on
    [0.1, 6], targets with a mixed depth mask, all from numpy."""
    rng = np.random.default_rng(D + 11)
    jc = JNerfConfig(hidden_dim=D, use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha)
    jp = init_nerf_params(jax.random.key(D + 11), jc)
    if not dist_alpha:
        jp = dict(jp, density_b=jp["density_b"] - 3.0)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(n, S)).astype(np.float32), axis=1)
    rgb_gt = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    depth_gt = rng.uniform(1.0, 5.0, size=(n,)).astype(np.float32)
    mask = (np.arange(n) % 3) != 0
    tc = NerfConfig(hidden_dim=D, use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha)
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    return jc, jp, tc, tp, o, v, z, rgb_gt, depth_gt, mask


@pytest.mark.parametrize("occ,dist_alpha,rgb_p", FLAGS)
@pytest.mark.parametrize("D", WIDTHS)
def test_train_plain_matches_pallas_train_kernel(D, occ, dist_alpha, rgb_p):
    """(i) K1's plain version against the Pallas train kernel in interpret
    mode: total and sums, every parameter's gradient, d(rays), dz, d(target)."""
    jc, jp, tc, tp, o, v, z, rgb_gt, depth_gt, mask = _case(D, occ, dist_alpha)
    n = len(o)
    w_rgb, w_depth = 0.7 / n, 0.3 / max(mask.sum(), 1)
    jrays = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    jtgt = jpr.pack_targets(jnp.asarray(rgb_gt), jnp.asarray(depth_gt), jnp.asarray(mask),
                            jnp.asarray(w_rgb), jnp.asarray(w_depth))

    def f(p, r, zz, t):
        return jpr.render_ray_loss_fused(p, r, zz, t, jc, dist_alpha, rgb_p, False)

    with pltpu.force_tpu_interpret_mode():
        (r_total, r_sums), (r_gp, r_gr, r_gz, r_gt) = jax.value_and_grad(
            f, argnums=(0, 1, 2, 3), has_aux=True)(jp, jrays, jnp.asarray(z), jtgt)

    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    tgt = F.pack_targets(torch.from_numpy(rgb_gt), torch.from_numpy(depth_gt),
                         torch.from_numpy(mask), w_rgb, w_depth)
    total, sums, grads = F.render_ray_loss_fused_plain(tp, rays, torch.from_numpy(z), tgt, tc,
                                                       dist_alpha, rgb_p, False)
    np.testing.assert_allclose(float(total), float(r_total), rtol=2e-3)
    np.testing.assert_allclose(sums.numpy(), np.asarray(r_sums), rtol=2e-3)
    assert set(grads["params"]) == set(r_gp)
    for k in sorted(r_gp):
        _assert_block(k, grads["params"][k].numpy(), r_gp[k])
    _assert_block("rays", grads["rays"].numpy(), np.asarray(r_gr)[:, :9])
    _assert_block("z", grads["z"].numpy(), r_gz)
    _assert_block("tgt", grads["tgt"].numpy(), np.asarray(r_gt)[:, :7])


@pytest.mark.parametrize("occ,dist_alpha,rgb_p", FLAGS)
@pytest.mark.parametrize("D", WIDTHS)
def test_full_render_backward_matches_pallas_vjp(D, occ, dist_alpha, rgb_p):
    """(ii) K4 full's plain version against jax.vjp of render_rays_fused with
    respect to the params, the rays and z (the Pallas backward kernel in
    interpret mode). rgb_p is K1's: unused here."""
    del rgb_p
    jc, jp, tc, tp, o, v, z, rgb_gt, depth_gt, _ = _case(D, occ, dist_alpha)
    n = len(o)
    jrays = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda p, r, zz: jpr.render_rays_fused(p, r, zz, jc, dist_alpha),
                           jp, jrays, jnp.asarray(z))
        rgb, dist, weights, _ = (np.asarray(a) for a in out)
        g_w = np.zeros_like(weights)
        g_w[:, ::7] = 2.0 / n * weights[:, ::7]
        g_a = np.zeros_like(weights)
        g_a[:, 5] = 1.0 / n
        cot = [(1.4 / n * (rgb - rgb_gt)).astype(np.float32),
               (0.6 / n * (dist - depth_gt)).astype(np.float32), g_w, g_a]
        r_gp, r_gr, r_gz = vjp(tuple(jnp.asarray(c) for c in cot))

    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v)))
    dWs, dBs, drays, dz = F.render_rays_fused_bwd_plain(
        tp, rays, torch.from_numpy(z), *(torch.from_numpy(c) for c in cot), tc, dist_alpha)
    grads = F.unpack_grads(dWs, dBs, tc)
    assert set(grads) == set(r_gp)
    for k in sorted(r_gp):
        _assert_block(k, grads[k].numpy(), r_gp[k])
    _assert_block("rays", drays.numpy(), np.asarray(r_gr)[:, :9])
    _assert_block("z", dz.numpy(), r_gz)
    # the frozen-network plain call gives the same d(rays) and dz, bit for bit
    frozen = F._bwd_plain(tp, rays, torch.from_numpy(z),
                          *(torch.from_numpy(c) for c in cot), tc, dist_alpha)
    assert torch.equal(frozen[2], drays) and torch.equal(frozen[3], dz)


@pytest.mark.slow
def test_fused_train_step_at_384_matches_jax():
    """(iii) one train step of the default config (the fused route: K1's
    plain version here, the Pallas train kernel in interpret mode in JAX) at
    hidden_dim 384 from a converted state with JAX's draws: the loss dict and
    every gradient."""
    n_rays, steps = 16, 128
    overrides = {"model": {"hidden_dim": 384},
                 "rendering": {"num_points": steps},
                 "training": {"n_training_points": n_rays},
                 "pose": {"learn_pose": True, "init_pose": True}}
    scene_np = dict(make_synthetic_scene(n_frames=4, h=12, w=16))
    jcfg = jax_load_config(overrides=overrides)
    jscene = JSceneData.from_dict(scene_np)
    jmc = JModelConfigs.from_cfg(jcfg, 4)
    assert jmc.nerf.use_pallas and jmc.render.n_importance == 0
    jstate, _ = jax_create(jax.random.key(0), jmc, init_c2w=jnp.asarray(jscene.c2ws_gt))
    cfg = load_config(overrides=overrides)
    mc = ModelConfigs.from_cfg(cfg, 4)
    assert mc.nerf.use_pallas and mc.nerf.hidden_dim == 384
    weights = Trainer(cfg, mc).weights_at(0, 10000)

    ray_idx = np.random.default_rng(7).permutation(12 * 16)[:n_rays].astype(np.int32)
    key = jax.random.key(13)
    _, knoise, _ = jax.random.split(key, 3)
    noise = np.array(jax.random.uniform(knoise, (n_rays, steps), jnp.float32))
    batch = {k: jnp.asarray(v) for k, v in jax_batch(jscene, 0, ref_idx=1).items()}
    w = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
    with pltpu.force_tpu_interpret_mode():
        g_ref, ld_ref = jax.grad(jax_step_loss, has_aux=True)(jstate.params, batch, w,
                                                              jnp.asarray(ray_idx), key, jmc,
                                                              "l1")
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    scene = SceneData.from_dict(scene_np).to_device("cpu")
    g, ld = step_gradients(params, batch_for_frame(scene, 0, ref_idx=1), weights,
                           torch.from_numpy(ray_idx).long(), None, mc, "l1",
                           noise=torch.from_numpy(noise))
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


def _magnitude(x, g):
    """Per entry of x^T g, the sum of its products' magnitudes (f64)."""
    return x.double().abs().t() @ g.double().abs()


@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_render_dw_pieces_cover_every_block(D):
    """(iv) render_dw_pieces: each block of render_dw_table in column pieces
    of 256, then 128, then 64, covering its columns once; 11 pieces at 128
    and 256, 22 at 384, 21 at 512, within the kernel's DW_MAX_PIECES; no
    direction block. dw_plain over a piece's columns of the operands the
    plain backward forms is those columns of K4 full's plain dW."""
    pieces = FM.render_dw_pieces(D)
    table = FM.render_dw_table(D)
    assert len(pieces) == {128: 11, 256: 11, 384: 22, 512: 21}[D] <= FM.DW_MAX_PIECES
    assert pieces == [p for p in FM.point_dw_pieces(D) if p[0] != 12]
    for wi, xname, gname, K, N in table:
        mine = [(c0, n) for w, x, g, k, c0, n in pieces if w == wi]
        assert all(x == xname and g == gname and k == K
                   for w, x, g, k, _, _ in pieces if w == wi)
        assert all(n in (64, 128, 256) for _, n in mine)
        assert [c for c0, n in mine for c in range(c0, c0 + n)] == list(range(N)), (wi, mine)
    n, S = 3, 128
    tc = NerfConfig(hidden_dim=D, use_pallas=True)
    tp = init_torch_params(tc, torch.Generator().manual_seed(D + 3), device="cpu")
    tp["density_b"] = tp["density_b"] - 3.0
    rng = np.random.default_rng(D + 3)
    o = torch.from_numpy((rng.normal(size=(n, 3)) * 0.5).astype(np.float32))
    v = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
                                      dim=1)
    rays = F.pack_rays(o, v, -v)
    z = torch.from_numpy(np.sort(rng.uniform(0.1, 6.0, size=(n, S)), axis=1).astype(np.float32))
    g_rgb = torch.from_numpy((rng.normal(size=(n, 3)) * 1e-2).astype(np.float32))
    g_dist = torch.from_numpy((rng.normal(size=(n,)) * 1e-2).astype(np.float32))
    dWs, _, _, _ = F.render_rays_fused_bwd_plain(tp, rays, z, g_rgb, g_dist, None, None, tc)
    X, G, _ = F.render_dw_operands(tp, rays, z, g_rgb, g_dist, None, None, tc)
    for wi, xname, gname, K, c0, width in pieces:
        x, g = X[xname], G[gname][:, c0:c0 + width]
        got = FM.dw_plain(x, g)
        ref = dWs[wi][:, c0:c0 + width]
        err = (got.double() - ref.double()).abs()
        assert bool((err <= 1e-5 * _magnitude(x, g) + 1e-12).all()), (wi, c0, float(err.max()))


@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_render_operand_bytes_and_chunks(D):
    """(v) the operands K1 and K4 full hand the dW kernel, per sample: X = pe
    plus 9 D/64 blocks, G = D/128 + 9 D/64 blocks of 64 bf16 columns (14,336
    B in all at 384, 19,072 at 512); render_chunks splits a call into the
    fewest chunks of one size (the last takes the rest) whose operands fit
    OPERAND_BUDGET_BYTES: 1024 x 128 is one chunk at every width, 1024 x 512
    is 3 chunks at 384 and 4 at 512."""
    x, g = F.render_operand_bytes(D, 1, 128)
    assert (x / 128, g / 128) == (2 * (64 + 9 * D), 2 * (D // 2 + 9 * D))
    per_sample = {128: 4864, 256: 9600, 384: 14336, 512: 19072}[D]
    assert (x + g) / 128 == per_sample
    assert sum(F.render_operand_bytes(D, 1024, 128)) == per_sample * 1024 * 128
    assert F.render_chunks(1024, 128, D) == [(0, 1024)]
    for n, S, count in ((1024, 512, {128: 2, 256: 2, 384: 3, 512: 4}[D]), (133, 2048, None),
                        (1024, 2048, None)):
        chunks = F.render_chunks(n, S, D)
        if count is not None:
            assert len(chunks) == count, (n, S, chunks)
        assert chunks[0][0] == 0 and chunks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        sizes = [b - a for a, b in chunks]
        assert len(set(sizes[:-1])) <= 1 and sizes[-1] <= sizes[0]
        assert all(sum(F.render_operand_bytes(D, k, S)) <= F.OPERAND_BUDGET_BYTES for k in sizes)
        # the fewest such chunks: one ray more per chunk would not fit, or one chunk fewer
        # would need more rays a chunk than fit
        fit = F.OPERAND_BUDGET_BYTES // sum(F.render_operand_bytes(D, 1, S))
        assert len(chunks) == -(-n // fit)
