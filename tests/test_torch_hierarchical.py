"""Port parity for hierarchical sampling (rendering.n_importance > 0): the
port's sample_pdf, render_nope_nerf and train step against nope_nerf_tpu on
the CPU, with every random draw pinned. JAX draws the stratified jitter from
split(key, 3)[1] and the fine draw from fold_in(split(key, 3)[0], 1) as
uniform(0, 1 - 1e-5); the tests repeat those draws with jax.random and hand
the arrays to the port (`noise`, `fine_u`).

Tolerances. sample_pdf: 1e-5 relative. The cdf is a cumulative f32 sum
that XLA adds as an associative scan and torch in sequence, so the two are a
few ulps apart, and the inversion divides that by the probability of the bin
a draw lands in: the weights are kept off zero (each bin's probability above
1e-4, as the renders below keep theirs) so that the quotient stays below the
tolerance. render_nope_nerf in float32 (compute_dtype
float32, the nerf_apply route on both sides): 1e-5 relative on rendered
values and merged z. In bfloat16 the port's point-query MLP (the plain
version of K5) against the JAX package's nerf_apply in bfloat16: 2e-3 x
max|ref|, as tests/test_torch_render.py holds the fused route. The train
step in float32: the train-step tolerances of tests/test_torch_trainer.py
(loss dict rtol 1e-4, gradients 1e-4 of each block's largest entry).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.config import load_config
from nope_nerf_tpu.data import SceneData as JSceneData, batch_for_frame as jax_batch
from nope_nerf_tpu.data import make_synthetic_scene
from nope_nerf_tpu.geometry.camera import camera_matrix_from_focal
from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.ops import render as jrender
from nope_nerf_tpu.training import ModelConfigs as JModelConfigs
from nope_nerf_tpu.training import compute_step_loss as jax_step_loss
from nope_nerf_tpu.training import create_train_state as jax_create

from nope_nerf_torch.convert import params_from_numpy
from nope_nerf_torch.data import SceneData, batch_for_frame
from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.ops import render as trender
from nope_nerf_torch.training import ModelConfigs, Trainer
from nope_nerf_torch.training.trainer import step_gradients

torch.set_num_threads(2)
N_RAYS, S, N_IMP, HIDDEN, KEY = 16, 128, 64, 128, 7


def jax_draws(key, n, steps, n_importance):
    """(stratified noise (n, steps), fine draw (n, n_importance)) that JAX's
    render_nope_nerf takes from `key`."""
    k0, knoise, _ = jax.random.split(key, 3)
    noise = jax.random.uniform(knoise, (n, steps), jnp.float32)
    u = jax.random.uniform(jax.random.fold_in(k0, 1), (n, n_importance), jnp.float32,
                           0.0, 1.0 - 1e-5)
    return np.array(noise), np.array(u)


@pytest.mark.parametrize("deterministic", [False, True])
def test_sample_pdf_matches_jax(deterministic):
    rng = np.random.default_rng(0)
    z = np.sort(rng.uniform(0.1, 8.0, size=(32, 128)).astype(np.float32), axis=1)
    w = rng.uniform(0.05, 1.0, size=(32, 128)).astype(np.float32)
    w[3] = 0.0                                    # an empty ray: the 1e-5 floor alone
    key = jax.random.key(3)
    ref = jrender.sample_pdf(key, jnp.asarray(z), jnp.asarray(w), N_IMP,
                             deterministic=deterministic)
    u = None
    if not deterministic:
        u = torch.from_numpy(np.array(jax.random.uniform(key, (32, N_IMP), jnp.float32,
                                                         0.0, 1.0 - 1e-5)))
    got = trender.sample_pdf(torch.from_numpy(z), torch.from_numpy(w), N_IMP,
                             deterministic=deterministic, u=u)
    assert got.shape == (32, N_IMP)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # the fine depths lie inside the midpoint span
    assert float(got.min()) >= 0.5 * (z[:, 0] + z[:, 1]).min() - 1e-6


def test_sample_pdf_draws_from_a_generator():
    z = torch.linspace(0.5, 6.0, 64).expand(8, 64)
    w = torch.rand(8, 64, generator=torch.Generator().manual_seed(0))
    a = trender.sample_pdf(z, w, 16, generator=torch.Generator().manual_seed(5))
    b = trender.sample_pdf(z, w, 16, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (8, 16)
    with pytest.raises(ValueError):
        trender.sample_pdf(z, w, 16)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    cam = np.array(camera_matrix_from_focal(jnp.asarray(1.2), jnp.asarray(1.4)))
    world = np.eye(4, dtype=np.float32)
    world[:3, 3] = [0.3, -0.2, 0.5]
    pixels = rng.uniform(-1, 1, size=(N_RAYS, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, size=(N_RAYS, 1)).astype(np.float32)
    return cam, world, pixels, depth


def _render_both(compute_dtype, port_pallas, dist_alpha, eval_=False):
    jc = JNerfConfig(hidden_dim=HIDDEN, compute_dtype=compute_dtype, use_pallas=False,
                     dist_alpha=dist_alpha)
    tc = NerfConfig(hidden_dim=HIDDEN, compute_dtype=compute_dtype, use_pallas=port_pallas,
                    dist_alpha=dist_alpha)
    jp = init_nerf_params(jax.random.key(1), jc)
    # keep transmittance alive to the last sample: no bin of the coarse pdf is
    # so improbable that the inversion amplifies f32 rounding (see sample_pdf above)
    jp["density_b"] = jp["density_b"] - 4.0
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    cam, world, pixels, depth = _scene()
    kw = dict(num_points=S, n_importance=N_IMP, dist_alpha=dist_alpha)
    key = None if eval_ else jax.random.key(KEY)
    ref = jrender.render_nope_nerf(jp, jnp.asarray(pixels), jnp.asarray(depth), jnp.asarray(cam),
                                   jnp.asarray(world), None, key, jrender.RenderConfig(**kw), jc,
                                   add_noise=not eval_, eval_=eval_)
    noise, u = jax_draws(jax.random.key(KEY), N_RAYS, S, N_IMP)
    got = trender.render_nope_nerf(
        tp, torch.from_numpy(pixels), torch.from_numpy(depth), torch.from_numpy(cam),
        torch.from_numpy(world), None, None, trender.RenderConfig(**kw), tc,
        add_noise=not eval_, eval_=eval_, noise=None if eval_ else torch.from_numpy(noise),
        fine_u=None if eval_ else torch.from_numpy(u))
    return ref, got


@pytest.mark.parametrize("eval_", [False, True], ids=["train", "eval"])
@pytest.mark.parametrize("dist_alpha", [False, True])
def test_render_hierarchical_matches_jax_f32(dist_alpha, eval_):
    ref, got = _render_both("float32", False, dist_alpha, eval_)
    assert got["z_vals"].shape == (N_RAYS, S + N_IMP)
    assert bool((got["z_vals"][:, 1:] >= got["z_vals"][:, :-1]).all())
    for k in ("rgb", "depth_pred", "weights", "alpha", "z_vals", "depth_gt"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("dist_alpha", [False, True])
def test_render_hierarchical_point_mlp_matches_jax_bf16(dist_alpha):
    """use_pallas: the port's queries go through point_mlp (K5's plain version)."""
    ref, got = _render_both("bfloat16", True, dist_alpha)
    for k in ("rgb", "depth_pred", "weights", "alpha", "z_vals"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert np.max(np.abs(r - g)) < 2e-3 * max(1e-3, float(np.abs(r).max())), k


def test_train_step_hierarchical_matches_jax_f32():
    """One train step with n_importance 64 (float32, nerf_apply on both sides)
    from a converted state: loss dict and every gradient."""
    overrides = {"model": {"hidden_dim": HIDDEN},
                 "rendering": {"n_importance": N_IMP},
                 "training": {"n_training_points": N_RAYS},
                 "pose": {"learn_pose": True, "init_pose": True},
                 "tpu": {"use_pallas_renderer": False, "compute_dtype": "float32"}}
    scene_np = dict(make_synthetic_scene(n_frames=4, h=24, w=32))
    jcfg = load_config(overrides=overrides)
    jscene = JSceneData.from_dict(scene_np)
    jmc = JModelConfigs.from_cfg(jcfg, 4)
    jstate, _ = jax_create(jax.random.key(0), jmc, init_c2w=jnp.asarray(jscene.c2ws_gt))
    from nope_nerf_torch.config import load_config as t_load_config
    cfg = t_load_config(overrides=overrides)
    mc = ModelConfigs.from_cfg(cfg, 4)
    weights = Trainer(cfg, mc).weights_at(0, 10000)

    ray_idx = np.random.default_rng(5).permutation(24 * 32)[:N_RAYS].astype(np.int32)
    key = jax.random.key(11)
    batch = {k: jnp.asarray(v) for k, v in jax_batch(jscene, 0, ref_idx=1).items()}
    w = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
    g_ref, ld_ref = jax.grad(jax_step_loss, has_aux=True)(jstate.params, batch, w,
                                                          jnp.asarray(ray_idx), key, jmc, "l1")
    noise, u = jax_draws(key, N_RAYS, S, N_IMP)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    scene = SceneData.from_dict(scene_np).to_device("cpu")
    g, ld = step_gradients(params, batch_for_frame(scene, 0, ref_idx=1), weights,
                           torch.from_numpy(ray_idx).long(), None, mc, "l1",
                           noise=torch.from_numpy(noise), fine_u=torch.from_numpy(u))
    assert set(ld) == set(ld_ref)
    for k in ld_ref:
        np.testing.assert_allclose(float(ld[k]), float(ld_ref[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for grp in g_ref:
        for k, r in g_ref[grp].items():
            r = np.asarray(r)
            err = float(np.max(np.abs(g[grp][k].numpy() - r))) if r.size else 0.0
            assert err <= 1e-4 * float(np.max(np.abs(r))) + 1e-7, f"{grp}/{k}: {err}"
    assert float(np.abs(g["pose"]["r"].numpy()).max()) > 0


def test_render_trajectory_and_pose_opt_with_n_importance():
    """The eval entry points take the hierarchical route with the
    deterministic fine draw: render_trajectory against the JAX package's
    (float32, 1e-5 as the renders above), and pose-optimisation steps run and
    move the pose."""
    from nope_nerf_tpu.evaluation.extract import render_trajectory as jax_render_trajectory
    from nope_nerf_torch.evaluation.extract import render_trajectory
    from nope_nerf_torch.evaluation.pose_opt import pose_opt_step
    from nope_nerf_torch.models.poses import PoseConfig, init_pose_params
    from nope_nerf_torch.training.state import init_adam

    jc = JNerfConfig(hidden_dim=HIDDEN, compute_dtype="float32")
    tc = NerfConfig(hidden_dim=HIDDEN, compute_dtype="float32")
    jp = init_nerf_params(jax.random.key(1), jc)
    jp["density_b"] = jp["density_b"] - 4.0
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    cam, world, _, _ = _scene()
    c2ws = np.linalg.inv(world)[None].astype(np.float32)
    rk = dict(num_points=32, n_importance=16)
    ref = jax_render_trajectory(jp, c2ws, cam, (6, 8), jc, jrender.RenderConfig(**rk))
    got = render_trajectory(tp, c2ws, cam, (6, 8), tc, trender.RenderConfig(**rk), device="cpu")
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(got[0][k], np.asarray(ref[0][k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    pcfg = PoseConfig(num_cams=1, use_init_c2w=True)
    pose = init_pose_params(pcfg, torch.from_numpy(c2ws), device="cpu")
    adam = init_adam(pose)
    img = torch.rand(6, 8, 3, generator=torch.Generator().manual_seed(0))
    before = pose["t"].clone()
    losses = [float(pose_opt_step(pose, adam, tp, None, img, 0, torch.from_numpy(cam),
                                  torch.arange(32), 1e-3, pcfg, None, tc,
                                  trender.RenderConfig(**rk))) for _ in range(2)]
    assert all(np.isfinite(losses)) and not torch.equal(pose["t"], before)
