"""hidden_dim 640 to 1024 on K1 (the render train step) and K4 full (the
render backward with every weight gradient), on the CPU, where the two
kernels (csrc/render_full_sm90.cuh's xwide kernel on the card, built by
csrc/render_train_xwide.cu and csrc/render_bwd_xwide.cu: the chain of
csrc/mlp_dx_xwide_sm90.cuh with csrc/mlp_dw_chain_sm90.cuh's
OperandSaveX<D, true>, and the dW kernel's column pieces in two launches)
run as their plain versions:

(i)   K1's plain version (render_ray_loss_fused_plain) at 640 against the
      JAX package's render_ray_loss_fused, its Pallas train kernel in
      interpret mode: total and loss sums, every dW and dB, d(rays), dz and
      d(target), 8 rays x 128 samples, both flag sets the card's checks use
      (each with the rgb loss power they use);
(ii)  K4 full's plain version (render_rays_fused_bwd_plain) at 640 against
      jax.vjp of render_rays_fused with respect to the params, the rays and
      z, on tests/test_torch_wide_render_full.py's cotangents; its d(rays)
      and dz bit-equal to the frozen-network plain call's;
(iii) the dW kernel's work table of the render kernels at 640 to 1024
      (fused_mlp.render_dw_pieces): each block's columns covered once, 32,
      32, 43 and 42 pieces in two launches (render_dw_launches), and
      dw_plain over each piece's columns of the operands the plain backward
      forms giving those columns of K4 full's plain dW;
(iv)  render_operand_bytes, render_chunks and the dW kernel's chunks at 640
      to 1024: 23,808 to 38,016 B a sample, 2 chunks of 512 rays for 1024 x
      128 and 5 to 8 for 1024 x 512, every chunk within the budget, and no
      dW chunk past DW_XWIDE_CHUNK_TILES row tiles (8 a chunk of rays at 1024
      x 128);
(v)   one fused train step at hidden_dim 640 against the JAX package's
      compute_step_loss, from a converted state with the draws pinned
      (slow: the interpreted train kernel takes tens of seconds).

Inputs come from numpy seeds. Tolerances, PERF.md section 2's bf16 class:
total and loss sums within 2e-3 relative, every dW and dB block within 2e-2
of its largest entry; d(rays), dz and d(target) by the per-sample rule (L2
within 2e-2, at most 1 entry in 1000 off by more than 2e-2 of the largest;
tests/test_torch_xwide_backward.py explains it at these widths); a train
step's gradients within 5e-2 of each block's largest entry, its loss dict
rtol 2e-3.
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
XWIDE = [640, 768, 896, 1024]
PIECES = {640: 32, 768: 32, 896: 43, 1024: 42}
PER_SAMPLE = {640: 23808, 768: 28544, 896: 33280, 1024: 38016}   # operand bytes a sample


def _assert_block(name, got, ref, rel=2e-2):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0 and got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
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


def _case(D, occ, dist_alpha, n=8, S=128):
    """Seeded JAX params (the density bias lowered where occupancy would
    saturate within a few samples), rays from near the origin, sorted z on
    [0.1, 6], targets with a mixed depth mask, all from numpy."""
    rng = np.random.default_rng(D + 17)
    jc = JNerfConfig(hidden_dim=D, use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha)
    jp = init_nerf_params(jax.random.key(D + 17), jc)
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
def test_xwide_train_plain_matches_pallas_train_kernel(occ, dist_alpha, rgb_p):
    """(i) K1's plain version at 640 against the Pallas train kernel in
    interpret mode: total and sums, every parameter's gradient, d(rays), dz,
    d(target)."""
    D = 640
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
    _assert_per_sample("rays", grads["rays"].numpy(), np.asarray(r_gr)[:, :9])
    _assert_per_sample("z", grads["z"].numpy(), r_gz)
    _assert_per_sample("tgt", grads["tgt"].numpy(), np.asarray(r_gt)[:, :7])


@pytest.mark.parametrize("occ,dist_alpha,rgb_p", FLAGS)
def test_xwide_full_render_backward_matches_pallas_vjp(occ, dist_alpha, rgb_p):
    """(ii) K4 full's plain version at 640 against jax.vjp of
    render_rays_fused with respect to the params, the rays and z (the Pallas
    backward kernel in interpret mode); d(rays) and dz bit-equal to the
    frozen-network plain call's. rgb_p is K1's: unused here."""
    del rgb_p
    D = 640
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
    _assert_per_sample("rays", drays.numpy(), np.asarray(r_gr)[:, :9])
    _assert_per_sample("z", dz.numpy(), r_gz)
    # the frozen network's route (render_rays_fused under autograd, no parameter wanting a
    # gradient) gives the same d(rays) and dz, bit for bit
    r = rays.clone().requires_grad_(True)
    zt = torch.from_numpy(z).requires_grad_(True)
    out = F.render_rays_fused(tp, r, zt, tc, dist_alpha)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cot])
    assert torch.equal(r.grad, drays) and torch.equal(zt.grad, dz)


def _magnitude(x, g):
    """Per entry of x^T g, the sum of its products' magnitudes (f64)."""
    return x.double().abs().t() @ g.double().abs()


@pytest.mark.parametrize("D", XWIDE)
def test_xwide_render_dw_pieces_cover_every_block(D):
    """(iii) render_dw_pieces past 512: each block of render_dw_table in
    column pieces of 256, then 128, then 64, covering its columns once; 32,
    32, 43 and 42 pieces, K6's table without its direction block, in two
    launches of at most DW_MAX_PIECES (render_dw_launches, chain_dw_launch's
    cut); dw_plain over a piece's columns of the operands the plain backward
    forms is those columns of K4 full's plain dW."""
    pieces = FM.render_dw_pieces(D)
    table = FM.render_dw_table(D)
    assert len(pieces) == PIECES[D]
    assert pieces == [p for p in FM.point_dw_pieces(D) if p[0] != 12]
    assert FM.render_dw_launches(D) == 2
    assert FM.DW_MAX_PIECES < len(pieces) <= 2 * FM.DW_MAX_PIECES
    assert [FM.render_dw_launches(d) for d in (128, 256, 384, 512)] == [1, 1, 1, 1]
    for wi, xname, gname, K, N in table:
        mine = [(c0, n) for w, x, g, k, c0, n in pieces if w == wi]
        assert all(x == xname and g == gname and k == K
                   for w, x, g, k, _, _ in pieces if w == wi)
        assert all(n in (64, 128, 256) for _, n in mine)
        assert [c for c0, n in mine for c in range(c0, c0 + n)] == list(range(N)), (wi, mine)
    n, S = 2, 128
    tc = NerfConfig(hidden_dim=D, use_pallas=True)
    tp = init_torch_params(tc, torch.Generator().manual_seed(D + 5), device="cpu")
    tp["density_b"] = tp["density_b"] - 3.0
    rng = np.random.default_rng(D + 5)
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


@pytest.mark.parametrize("D", XWIDE)
def test_xwide_render_operand_bytes_and_chunks(D):
    """(iv) the operands K1 and K4 full hand the dW kernel past 512 (X = pe
    plus 9 D/64 blocks, G = D/128 + 9 D/64 blocks of 64 bf16 columns a
    sample); render_chunks within OPERAND_BUDGET_BYTES: 2 chunks of 512 rays
    for 1024 x 128 at every width here, 5 to 8 for 1024 x 512; the dW
    kernel's chunks of a chunk of rays (point_dw_chunks over the render
    table's CTA tiles, which pass the card's 132 SMs, so dw_chunks gives 1):
    none sums more than DW_XWIDE_CHUNK_TILES row tiles, 8 at 1024 x 128."""
    x, g = F.render_operand_bytes(D, 1, 128)
    assert (x / 128, g / 128) == (2 * (64 + 9 * D), 2 * (D // 2 + 9 * D))
    assert (x + g) / 128 == PER_SAMPLE[D]
    assert F.render_chunks(1024, 128, D) == [(0, 512), (512, 1024)]
    chunks = F.render_chunks(1024, 512, D)
    assert len(chunks) == {640: 5, 768: 6, 896: 7, 1024: 8}[D]
    for n, S in ((1024, 128), (1024, 512), (4097, 128), (133, 2048)):
        chunks = F.render_chunks(n, S, D)
        assert chunks[0][0] == 0 and chunks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        sizes = [b - a for a, b in chunks]
        assert len(set(sizes[:-1])) <= 1 and sizes[-1] <= sizes[0]
        assert all(sum(F.render_operand_bytes(D, k, S)) <= F.OPERAND_BUDGET_BYTES for k in sizes)
        fit = F.OPERAND_BUDGET_BYTES // sum(F.render_operand_bytes(D, 1, S))
        assert len(chunks) == -(-n // fit)
        tiles = FM.dw_cta_tiles(k for _, _, _, k, _, _ in FM.render_dw_pieces(D))
        assert tiles > 132 and FM.dw_chunks(tiles, sizes[0] * S, 132) == 1
        for k in set(sizes):
            nt = k * S // FM.DW_ROWS
            dw = FM.point_dw_chunks(D, tiles, k * S, 132)
            assert 1 <= dw <= nt and -(-nt // dw) <= FM.DW_XWIDE_CHUNK_TILES
    tiles = FM.dw_cta_tiles(k for _, _, _, k, _, _ in FM.render_dw_pieces(D))
    assert tiles == {640: 136, 768: 162, 896: 253, 1024: 280}[D]
    assert FM.point_dw_chunks(D, tiles, 512 * 128, 132) == 8


@pytest.mark.slow
def test_fused_train_step_at_640_matches_jax():
    """(v) one train step of the default config (the fused route: K1's plain
    version here, the Pallas train kernel in interpret mode in JAX) at
    hidden_dim 640 from a converted state with JAX's draws: the loss dict and
    every gradient."""
    n_rays, steps = 16, 128
    overrides = {"model": {"hidden_dim": 640},
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
    assert mc.nerf.use_pallas and mc.nerf.hidden_dim == 640
    weights = Trainer(cfg, mc).weights_at(0, 10000)

    ray_idx = np.random.default_rng(9).permutation(12 * 16)[:n_rays].astype(np.int32)
    key = jax.random.key(17)
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


def _flip(params, rays, z, g_rgb, cfg, da):
    """The rgb-hidden ReLU mask an f32 evaluation could flip that moves the
    bias gradient most: the (sample, column) whose f64 pre-activation lies
    within 1e-3 of the sum of its terms' magnitudes of zero with the largest
    unmasked cotangent; returns (sample, column, pre-activation)."""
    W, B = F.pack_weights(params, cfg)
    Wf = [w.double() for w in W]
    fwd = F._plain_forward(Wf, B, rays, z, cfg, da, torch.float64)
    n, S = z.shape
    feat, de, b = fwd["acts"][8], fwd["de"], B[10].double()
    pre = ((feat @ Wf[11].t()).reshape(n, S, -1) + (de @ Wf[12].t())[:, None, :] + b)
    mag = ((feat.abs() @ Wf[11].abs().t()).reshape(n, S, -1)
           + (de.abs() @ Wf[12].abs().t())[:, None, :] + b.abs())
    g = fwd["weights"][..., None] * g_rgb.double()[:, None, :] * fwd["rgb3"] * (1 - fwd["rgb3"])
    g_h = (g.reshape(-1, 3).to(torch.bfloat16).double() @ Wf[13][:3]).reshape(n, S, -1)
    score = torch.where(pre.abs() <= 1e-3 * mag, g_h.abs(), torch.zeros_like(g_h)).reshape(n * S, -1)
    k = int(score.argmax())
    s, j = divmod(k, score.shape[1])
    return s, j, float(pre.reshape(n * S, -1)[s, j])


@pytest.mark.parametrize("stray", [None, "flip", "flip_bias_only", "rgb_hidden_w",
                                   "flip_and_rgb_hidden_w", "trunk"])
def test_render_full_hold_past_512(monkeypatch, capsys, stray):
    """chip_smoke.check_wide_render_full on the CPU at 640 on one small case,
    K1 and K4 full stood in for by the plain backward summed in f64 (K1 at
    its own cotangents): it holds against the f32 plain version. On the relu
    / dist_alpha flag set, stand-ins summed with one rgb-hidden ReLU mask
    flipped (the sample and column whose f64 pre-activation lies within
    1e-3 of its terms' magnitudes of zero, with the largest cotangent) miss
    5e-3 against the plain version and the f64 sum, and are held by
    past_512_hold's step (2), which finds the flip from the bias gradient
    alone. The same bias gradient without that flip's moves in the other
    blocks fails, as does an error of 10% of the rgb-hidden weight
    gradient's L2 norm in one of its columns, alone or beside the flip, or a
    trunk bias gradient moved by its largest entry on both flag sets."""
    import chip_smoke
    plain_bwd, plain_train, mlp_forward = (F.render_rays_fused_bwd_plain, F._train_plain,
                                           F._mlp_forward)
    flipped = {}   # the flip the stand-ins' f64 forward applies, while one is set

    def flip_forward(Wf, B, pe, de, n, S):
        rgb_raw, sig_raw, acts = mlp_forward(Wf, B, pe, de, n, S)
        if flipped and pe.dtype == torch.float64:
            s, j, pre = flipped["at"]
            h = acts[9].clone()
            h[s, j] = 0.0 if pre > 0 else abs(pre)
            acts = acts[:9] + [h.to(torch.bfloat16).double()]
        return rgb_raw, sig_raw, acts

    def f64(params, rays, z, cot, cfg, da):
        out = plain_bwd(params, rays, z, *cot, cfg, da, dtype=torch.float64)
        return [w.float() for w in out[0]], [b.float() for b in out[1]], *(t.float()
                                                                           for t in out[2:])

    def stand_in(params, rays, z, cot, cfg, da):
        dWs, dBs, drays, dz = f64(params, rays, z, cot, cfg, da)
        if stray == "trunk":
            b = dBs[0].clone()
            b[0] += float(b.abs().max())
            dBs = dBs[:0] + [b] + dBs[1:]
        elif stray is not None and cfg.occ_activation == "relu" and da:
            if stray != "rgb_hidden_w":
                flipped["at"] = _flip(params, rays, z, cot[0], cfg, da)
                moved = f64(params, rays, z, cot, cfg, da)
                flipped.clear()
                tol = 5e-3 * float(dBs[10].abs().max())
                assert float((moved[1][10] - dBs[10]).abs().max()) > tol   # beyond the rule
                if stray == "flip_bias_only":
                    dBs = dBs[:10] + [moved[1][10]] + dBs[11:]
                else:
                    dWs, dBs = moved[0], moved[1]
            if stray in ("rgb_hidden_w", "flip_and_rgb_hidden_w"):
                # 10% of the block's L2 norm, in its column of the largest norm
                w = dWs[11].clone()
                j = int(w.norm(dim=0).argmax())
                noise = torch.randn(w.shape[0], generator=torch.Generator().manual_seed(5))
                w[:, j] += noise * (0.1 * float(w.norm()) / float(noise.norm()))
                dWs = dWs[:11] + [w] + dWs[12:]
        return dWs, dBs, drays, dz

    def kernel_bwd(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg, da, want_param_grads=True):
        dWs, dBs, drays, dz = stand_in(params, rays, z, (g_rgb, g_dist, g_w, g_a), cfg, da)
        return (dWs, dBs, drays, dz) if want_param_grads else (None, None, drays, dz)

    def kernel_train(params, rays, z, tgt, cfg, da, rgb_p, white_bg):
        sums, _, _, _, _, dtgt = plain_train(params, rays, z, tgt, cfg, da, rgb_p, white_bg)
        dWs, dBs, drays, dz = stand_in(params, rays, z,
                                       (-dtgt[:, 0:3], -dtgt[:, 3], None, None), cfg, da)
        return sums, dWs, dBs, drays, dz, dtgt

    monkeypatch.setattr(F, "_mlp_forward", flip_forward)
    monkeypatch.setattr(F, "_render_bwd_cuda", kernel_bwd)
    monkeypatch.setattr(F, "_train_cuda", kernel_train)
    monkeypatch.setattr(chip_smoke, "WIDE_RENDER_CASES", ((2, 128),))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    dev = torch.device("cpu")
    if stray in (None, "flip"):
        assert set(chip_smoke.check_wide_render_full(torch, dev, (640,))) == {
            ("render_train", 640), ("render_bwd", 640)}
    else:
        with pytest.raises(RuntimeError, match="disagree with their plain versions"):
            chip_smoke.check_wide_render_full(torch, dev, (640,))
    out = capsys.readouterr().out
    assert out.count("render_train vs plain, D=640") == 2
    assert out.count("render_bwd vs plain, D=640") == 2
    assert out.count("mask(s) flipped") == {None: 0, "flip": 2, "flip_bias_only": 2,
                                            "rgb_hidden_w": 0, "flip_and_rgb_hidden_w": 2,
                                            "trunk": 0}[stray]
    assert out.count(": held)") == (2 if stray == "flip" else 0)
    assert out.count("not held") == {None: 0, "flip": 0, "flip_bias_only": 2,
                                     "rgb_hidden_w": 2, "flip_and_rgb_hidden_w": 2,
                                     "trunk": 4}[stray]
