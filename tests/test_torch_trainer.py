"""Port parity for the train step as a whole: nope_nerf_torch's
compute_step_loss / train_step against nope_nerf_tpu's compute_step_loss plus
its optimizer update, on the CPU, from an identical converted state (Adam
moments included), with the ray indices and the stratified jitter pinned.

Scene: the synthetic plane scene at 24x32, 4 frames, 16 rays x 128 samples,
hidden width 128, learned poses on top of the scene's and learned distortions;
the rgb, depth, Chamfer and photometric-warp terms of the default config.
JAX draws its z jitter from the key inside `_ray_geometry`: the test repeats
that draw with jax.random and hands the port the same array.

Tolerances. float32 mode (`use_pallas_renderer: false`, `compute_dtype:
float32`): loss dict rtol 1e-4, gradients 1e-4 of each block's largest entry,
params after Adam steps atol 1e-5 (Adam divides by sqrt(nu): an entry whose
gradient is rounding noise moves by lr whichever way the noise points, so
params are held to a few lr, not to f32 epsilon). bfloat16 fused mode
(the Pallas train kernel in interpret mode against the port's plain version):
loss dict 2e-3 relative, gradients 2e-2 of each block's largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.config import load_config
from nope_nerf_tpu.data import SceneData as JSceneData, batch_for_frame as jax_batch
from nope_nerf_tpu.data import epoch_order as jax_epoch_order, make_synthetic_scene
from nope_nerf_tpu.training import ModelConfigs as JModelConfigs
from nope_nerf_tpu.training import compute_step_loss as jax_step_loss
from nope_nerf_tpu.training import create_train_state as jax_create
from nope_nerf_tpu.training.state import apply_updates_with_lr

from nope_nerf_torch.convert import state_from_numpy
from nope_nerf_torch.data import SceneData, batch_for_frame, epoch_order
from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state, train_step
from nope_nerf_torch.training.trainer import _sample_rays, step_gradients

torch.set_num_threads(2)
N_FRAMES, H, W, N_RAYS, S = 4, 24, 32, 16, 128
SCHED_START = 10000


def _cfg(fused: bool):
    return load_config(overrides={
        "model": {"hidden_dim": 128},
        "training": {"n_training_points": N_RAYS},
        "pose": {"learn_pose": True, "init_pose": True},
        "tpu": {"use_pallas_renderer": fused,
                "compute_dtype": "bfloat16" if fused else "float32"}})


def _scene():
    return dict(make_synthetic_scene(n_frames=N_FRAMES, h=H, w=W))


def _numpy_state(state):
    """(params, {group: {mu, nu, count}}) of a JAX TrainState, as numpy."""
    params = jax.tree.map(np.asarray, state.params)
    opt = {}
    for g, chain in state.opt_state.items():
        adam = next(s for s in chain if hasattr(s, "mu"))
        opt[g] = {"mu": jax.tree.map(np.asarray, adam.mu), "nu": jax.tree.map(np.asarray, adam.nu),
                  "count": int(adam.count)}
    return params, opt


def _pins(step: int):
    """Pinned draws of one step: ray indices from numpy, and the jitter JAX draws
    from the step's render key."""
    rng = np.random.default_rng(100 + step)
    ray_idx = rng.permutation(H * W)[:N_RAYS].astype(np.int32)
    key = jax.random.key(200 + step)
    _, knoise, _ = jax.random.split(key, 3)
    return ray_idx, key, np.array(jax.random.uniform(knoise, (N_RAYS, S), jnp.float32))


class _Jax:
    """The JAX side: compute_step_loss and its optimizer update, as
    training/trainer.py::train_step does them, with ray_idx passed in."""

    def __init__(self, fused: bool):
        self.cfg = _cfg(fused)
        self.scene = JSceneData.from_dict(_scene())
        self.mc = JModelConfigs.from_cfg(self.cfg, N_FRAMES)
        self.state, self.optimizers = jax_create(jax.random.key(0), self.mc,
                                                 init_c2w=jnp.asarray(self.scene.c2ws_gt))
        # one compiled program serves every frame: the frame order is a traced select
        self._grad = jax.jit(jax.grad(jax_step_loss, has_aux=True), static_argnums=(5, 6))

    def grads(self, params, idx, ref, weights, ray_idx, key, rgb_loss_type="l1"):
        batch = {k: jnp.asarray(v) for k, v in jax_batch(self.scene, idx, ref_idx=ref).items()}
        w = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
        return self._grad(params, batch, w, jnp.asarray(ray_idx), key, self.mc, rgb_loss_type)

    def step(self, state, idx, ref, weights, lrs, ray_idx, key):
        grads, loss_dict = self.grads(state.params, idx, ref, weights, ray_idx, key)
        new_params, new_opt = dict(state.params), dict(state.opt_state)
        for g in state.params:
            updates, new_opt[g] = self.optimizers[g].update(grads[g], state.opt_state[g],
                                                            state.params[g])
            new_params[g] = apply_updates_with_lr(state.params[g], updates,
                                                  jnp.asarray(lrs[g], jnp.float32))
        return state.replace(params=new_params, opt_state=new_opt, it=state.it + 1), loss_dict


def _port(fused: bool):
    cfg = _cfg(fused)
    scene = SceneData.from_dict(_scene()).to_device("cpu")
    mc = ModelConfigs.from_cfg(cfg, N_FRAMES)
    return cfg, scene, mc, Trainer(cfg, mc)


def _assert_blocks(got, ref, rel, what):
    assert set(got) == set(ref), what
    for g in ref:
        assert set(got[g]) == set(ref[g]), (what, g)
        for k in ref[g]:
            r = np.asarray(ref[g][k])
            err = float(np.max(np.abs(got[g][k].numpy() - r))) if r.size else 0.0
            assert err <= rel * float(np.max(np.abs(r))) + 1e-7, f"{what} {g}/{k}: {err}"


def _assert_loss_dict(got, ref, rtol):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def f32_run():
    """Three JAX steps in float32 mode over frames (0, 3, 1): the last frame
    takes the backward branch of the frame-order select."""
    jx = _Jax(fused=False)
    cfg, scene, mc, trainer = _port(fused=False)
    weights = trainer.weights_at(0, SCHED_START)
    lrs = trainer.lrs_at(0, SCHED_START)
    states, dicts, state = [jx.state], [], jx.state
    frames = [(0, 1), (3, 2), (1, 2)]
    for step, (idx, ref) in enumerate(frames):
        ray_idx, key, _ = _pins(step)
        state, ld = jx.step(state, idx, ref, weights, lrs, ray_idx, key)
        states.append(state)
        dicts.append(ld)
    return jx, scene, mc, weights, lrs, frames, states, dicts


def test_step_gradients_match_jax_f32(f32_run):
    jx, scene, mc, weights, lrs, frames, states, dicts = f32_run
    for step, (idx, ref) in enumerate(frames[:2]):
        ray_idx, key, noise = _pins(step)
        g_ref, ld_ref = jx.grads(states[0].params, idx, ref, weights, ray_idx, key)
        state = state_from_numpy(*_numpy_state(states[0]), device="cpu")
        g, ld = step_gradients(state.params, batch_for_frame(scene, idx, ref_idx=ref), weights,
                               torch.from_numpy(ray_idx).long(), None, mc, "l1",
                               noise=torch.from_numpy(noise))
        _assert_loss_dict(ld, ld_ref, 1e-4)
        _assert_blocks(g, jax.tree.map(np.asarray, g_ref), 1e-4, f"frame {idx}")


def test_three_adam_steps_match_jax_f32(f32_run):
    jx, scene, mc, weights, lrs, frames, states, dicts = f32_run
    state = state_from_numpy(*_numpy_state(states[0]), it=int(states[0].it), device="cpu")
    for step, (idx, ref) in enumerate(frames):
        ray_idx, _, noise = _pins(step)
        state, ld = train_step(state, batch_for_frame(scene, idx, ref_idx=ref), weights, lrs, mc,
                               "l1", ray_idx=torch.from_numpy(ray_idx).long(),
                               noise=torch.from_numpy(noise))
        _assert_loss_dict(ld, dicts[step], 1e-4)
        ref_params, ref_opt = _numpy_state(states[step + 1])
        for g in ref_params:
            for k, r in ref_params[g].items():
                np.testing.assert_allclose(state.params[g][k].numpy(), r, rtol=0, atol=1e-5,
                                           err_msg=f"step {step} {g}/{k}")
            assert state.opt_state[g].count == ref_opt[g]["count"] == step + 1
    assert state.it == int(states[3].it) == 2


def test_step_from_converted_adam_moments(f32_run):
    """A state taken mid-run (non-zero moments, count 1) converts and continues
    as the JAX state does."""
    jx, scene, mc, weights, lrs, frames, states, dicts = f32_run
    params, opt = _numpy_state(states[1])
    assert opt["nerf"]["count"] == 1 and np.abs(opt["nerf"]["mu"]["rgb_b"]).max() > 0
    state = state_from_numpy(params, opt, it=int(states[1].it), device="cpu")
    idx, ref = frames[1]
    ray_idx, _, noise = _pins(1)
    state, ld = train_step(state, batch_for_frame(scene, idx, ref_idx=ref), weights, lrs, mc, "l1",
                           ray_idx=torch.from_numpy(ray_idx).long(), noise=torch.from_numpy(noise))
    _assert_loss_dict(ld, dicts[1], 1e-4)
    ref_params, ref_opt = _numpy_state(states[2])
    for g in ref_params:
        for k, r in ref_params[g].items():
            np.testing.assert_allclose(state.params[g][k].numpy(), r, rtol=0, atol=1e-5)
        for k, r in ref_opt[g]["nu"].items():
            np.testing.assert_allclose(state.opt_state[g].nu[k].numpy(), r, rtol=1e-3, atol=1e-12)


def test_fused_step_matches_jax_fused_bf16():
    """The fused branch (the plain version of the train kernel) against the JAX
    fused path, the Pallas train kernel in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    jx = _Jax(fused=True)
    cfg, scene, mc, trainer = _port(fused=True)
    weights = trainer.weights_at(0, SCHED_START)
    ray_idx, key, noise = _pins(0)
    with pltpu.force_tpu_interpret_mode():
        g_ref, ld_ref = jx.grads(jx.state.params, 0, 1, weights, ray_idx, key)
    state = state_from_numpy(*_numpy_state(jx.state), device="cpu")
    g, ld = step_gradients(state.params, batch_for_frame(scene, 0, ref_idx=1), weights,
                           torch.from_numpy(ray_idx).long(), None, mc, "l1",
                           noise=torch.from_numpy(noise))
    _assert_loss_dict(ld, ld_ref, 2e-3)
    _assert_blocks(g, jax.tree.map(np.asarray, g_ref), 2e-2, "fused")


def test_fused_and_unfused_routes_agree_on_cpu():
    """The port's two CPU routes on the same state and draws: the fused branch
    (bf16 operands, explicit backward) and the unfused one (autograd) in
    bfloat16 mode agree in the bf16 class; run_steps drives the fused one for
    an epoch with finite, changing state."""
    cfg, scene, mc, trainer = _port(fused=True)
    cfg_u = _cfg(True)
    cfg_u["tpu"]["use_pallas_renderer"] = False
    mc_u = ModelConfigs.from_cfg(cfg_u, N_FRAMES)
    weights = trainer.weights_at(0, SCHED_START)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    ray_idx, _, noise = _pins(0)
    batch = batch_for_frame(scene, 0, ref_idx=1)
    args = (state.params, batch, weights, torch.from_numpy(ray_idx).long(), None)
    g_f, ld_f = step_gradients(*args, mc, "l1", noise=torch.from_numpy(noise))
    g_u, ld_u = step_gradients(*args, mc_u, "l1", noise=torch.from_numpy(noise))
    _assert_loss_dict(ld_f, ld_u, 2e-3)
    _assert_blocks(g_f, {g: {k: v.numpy() for k, v in d.items()} for g, d in g_u.items()}, 5e-2,
                   "routes")

    before = {g: {k: v.clone() for k, v in d.items()} for g, d in state.params.items()}
    order, refs = epoch_order(N_FRAMES, seed=0)
    state, lds = trainer.run_steps(state, scene, order, refs, epoch=0, scheduling_start=SCHED_START)
    assert state.it == N_FRAMES - 1 and lds["loss"].shape == (N_FRAMES,)
    assert all(torch.isfinite(v).all() for v in lds.values())
    for g in ("nerf", "pose", "distortion"):
        assert any(not torch.equal(state.params[g][k], before[g][k]) for k in before[g]), g
    assert torch.equal(state.params["pose"]["init_c2w"], before["pose"]["init_c2w"])
    assert all(torch.isfinite(v).all() for d in state.params.values() for v in d.values())


def test_warp_cache_gives_the_same_loss_as_the_inline_warp():
    """run_steps hands the step per-scene constants (downsampled images and the
    source-side samples); a step without them computes the same values inline.
    Both frame orders: frame 3 is the last and looks backward."""
    cfg, scene, mc, trainer = _port(fused=False)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    weights = trainer.weights_at(0, SCHED_START)
    small, rgb_pc = trainer._warp_frames(scene)
    assert small.shape == (N_FRAMES, H // 4, W // 4, 3) and trainer._warp_frames(scene)[0] is small
    for idx, ref in ((0, 1), (3, 2)):
        ray_idx, _, noise = _pins(idx)
        batch = batch_for_frame(scene, idx, ref_idx=ref)
        cached = dict(batch, img_small=small[idx], ref_img_small=small[ref], rgb_pc=rgb_pc[idx],
                      ref_rgb_pc=rgb_pc[ref])
        args = (weights, torch.from_numpy(ray_idx).long(), None, mc, "l1")
        g_a, ld_a = step_gradients(state.params, batch, *args, noise=torch.from_numpy(noise))
        g_b, ld_b = step_gradients(state.params, cached, *args, noise=torch.from_numpy(noise))
        for k in ld_a:
            assert torch.equal(ld_a[k], ld_b[k]), k
        for g in g_a:
            for k in g_a[g]:
                assert torch.equal(g_a[g][k], g_b[g][k]), (g, k)


def test_epoch_order_and_batches_match_jax():
    for seed in (0, 3):
        for random_ref in (1, 2):
            a = epoch_order(7, shuffle=True, random_ref=random_ref, seed=seed)
            b = jax_epoch_order(7, shuffle=True, random_ref=random_ref, seed=seed)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    scene_np = _scene()
    got = batch_for_frame(SceneData.from_dict(scene_np).to_device("cpu"), 2, ref_idx=3)
    ref = jax_batch(JSceneData.from_dict(scene_np), 2, ref_idx=3)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_sample_rays_distinct_and_forced_valid():
    gen = torch.Generator().manual_seed(0)
    idx = _sample_rays(gen, H * W, 64, None, False)
    assert idx.shape == (64,) and len(set(idx.tolist())) == 64 and int(idx.max()) < H * W
    mask = torch.zeros(H * W, dtype=torch.bool)
    mask[[500, 700]] = True           # two valid pixels: a 64-ray draw will miss both
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        plain = _sample_rays(torch.Generator().manual_seed(seed), H * W, 64, None, False)
        idx = _sample_rays(gen, H * W, 64, mask, True)
        assert bool(mask[idx].any())
        if not bool(mask[plain].any()):
            assert int(idx[0]) == 500 and torch.equal(idx[1:], plain[1:])


def _draws(key, steps: int, n_importance: int):
    """The stratified jitter (N, steps) and the hierarchical fine draw
    (N, n_importance) that JAX's render_nope_nerf takes from `key`."""
    k0, knoise, _ = jax.random.split(key, 3)
    u = jax.random.uniform(jax.random.fold_in(k0, 1), (N_RAYS, n_importance), jnp.float32,
                           0.0, 1.0 - 1e-5)
    return (torch.from_numpy(np.array(jax.random.uniform(knoise, (N_RAYS, steps), jnp.float32))),
            torch.from_numpy(np.array(u)))


@pytest.mark.parametrize("section,key,value", [
    ("tpu", "use_pallas_renderer", False),
    ("rendering", "num_points", 100),
    ("rendering", "n_importance", 64),
    ("rendering", "normal_loss", True),
])
def test_configs_off_the_fused_render_step_matches_jax(section, key, value):
    """The configs the fused render cannot serve, and normal_loss (off the
    fused-loss gate: the fused render plus the normal output), take one CPU
    train step from a converted state: loss dict and every gradient against
    the JAX package's step. The port runs its own route for the config:
    point_mlp's plain version (num_points 100, n_importance 64),
    render_rays_fused's forward and backward plain versions (normal_loss),
    nerf_apply (use_pallas_renderer false); JAX runs nerf_apply in bfloat16
    (its route without the Pallas kernels, which interpret mode would make
    slow). bf16 class, as the route comparisons below: loss dict 2e-3
    relative, gradients 5e-2 of each block's largest entry."""
    cfg_t, cfg_j = _cfg(fused=True), _cfg(fused=True)
    cfg_j["tpu"]["use_pallas_renderer"] = False
    for cfg in (cfg_t, cfg_j):
        cfg[section][key] = value
    jx = _Jax(fused=False)
    jx.mc = JModelConfigs.from_cfg(cfg_j, N_FRAMES)
    mc = ModelConfigs.from_cfg(cfg_t, N_FRAMES)
    _, scene, _, trainer = _port(fused=True)
    weights = trainer.weights_at(0, SCHED_START)
    ray_idx, key, _ = _pins(0)
    g_ref, ld_ref = jx.grads(jx.state.params, 0, 1, weights, ray_idx, key)
    noise, fine_u = _draws(key, mc.render.num_points, mc.render.n_importance)
    state = state_from_numpy(*_numpy_state(jx.state), device="cpu")
    g, ld = step_gradients(state.params, batch_for_frame(scene, 0, ref_idx=1), weights,
                           torch.from_numpy(ray_idx).long(), torch.Generator().manual_seed(0), mc,
                           "l1", noise=noise, fine_u=fine_u)
    _assert_loss_dict(ld, ld_ref, 2e-3)
    _assert_blocks(g, jax.tree.map(np.asarray, g_ref), 5e-2, f"{section}.{key}")


@pytest.mark.parametrize("section,key,value", [("rendering", "outside_steps", 8)])
def test_cuda_only_configs_raise_not_implemented(section, key, value):
    """The one config no route serves, outside_steps > 0 (the JAX package's
    renderer cannot run it either), raises NotImplementedError; the check
    fires before any device work (meta tensors stand in for CUDA ones)."""
    cfg = _cfg(fused=True)
    cfg[section][key] = value
    mc = ModelConfigs.from_cfg(cfg, N_FRAMES)
    scene = SceneData.from_dict(_scene())
    batch = {k: (torch.as_tensor(v).to("meta") if isinstance(v, np.ndarray) else v)
             for k, v in batch_for_frame(scene, 0, ref_idx=1).items()}
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    params = {g: {k: v.to("meta") for k, v in d.items()} for g, d in state.params.items()}
    weights = Trainer(cfg, mc).weights_at(0, SCHED_START)
    from nope_nerf_torch.training import compute_step_loss
    with pytest.raises(NotImplementedError, match="outside_steps"):
        compute_step_loss(params, batch, weights, torch.zeros(N_RAYS, dtype=torch.long,
                                                              device="meta"), None, mc, "l1")


def test_invariant_depth_step_matches_jax_f32():
    """A config outside the fused-loss gate (depth_loss_type invariant): one
    step's loss dict and gradients against the JAX package from a converted
    state, in float32 mode."""
    def invariant(fused):
        cfg = _cfg(fused)
        cfg["training"]["depth_loss_type"] = "invariant"
        return cfg

    jx = _Jax(fused=False)
    jx.mc = JModelConfigs.from_cfg(invariant(False), N_FRAMES)
    cfg, scene, _, trainer = _port(fused=False)
    mc = ModelConfigs.from_cfg(invariant(False), N_FRAMES)
    weights = trainer.weights_at(0, SCHED_START)
    ray_idx, key, noise = _pins(0)
    g_ref, ld_ref = jx.grads(jx.state.params, 0, 1, weights, ray_idx, key)
    state = state_from_numpy(*_numpy_state(jx.state), device="cpu")
    g, ld = step_gradients(state.params, batch_for_frame(scene, 0, ref_idx=1), weights,
                           torch.from_numpy(ray_idx).long(), None, mc, "l1",
                           noise=torch.from_numpy(noise))
    _assert_loss_dict(ld, ld_ref, 1e-4)
    _assert_blocks(g, jax.tree.map(np.asarray, g_ref), 1e-4, "invariant")
    assert float(ld["loss_depth"]) > 0

    # the same config in bfloat16 fused mode renders through render_rays_fused
    # and its hand-written backward (the plain versions on the CPU): the two
    # routes agree in the bf16 class
    mc_f = ModelConfigs.from_cfg(invariant(True), N_FRAMES)
    cfg_u = invariant(True)
    cfg_u["tpu"]["use_pallas_renderer"] = False
    mc_u = ModelConfigs.from_cfg(cfg_u, N_FRAMES)
    args = (state.params, batch_for_frame(scene, 0, ref_idx=1), weights,
            torch.from_numpy(ray_idx).long(), None)
    g_f, ld_f = step_gradients(*args, mc_f, "l1", noise=torch.from_numpy(noise))
    g_u, ld_u = step_gradients(*args, mc_u, "l1", noise=torch.from_numpy(noise))
    _assert_loss_dict(ld_f, ld_u, 2e-3)
    _assert_blocks(g_f, {g_: {k: v.numpy() for k, v in d.items()} for g_, d in g_u.items()}, 5e-2,
                   "invariant routes")


def test_adam_step_with_a_device_count_matches_optax():
    """adam_step (the count a 0-d int64 tensor advanced in place, the rate a
    0-d float64 tensor, the bias corrections formed on the device) against
    optax.scale_by_adam over 5 steps, then p - lr * update; the weight-decay
    path against the gradient plus decay * p fed to the same transform. atol
    1e-6: the packages round the bias corrections and the update in another
    order, an ulp or two of lr-sized steps."""
    import optax
    from nope_nerf_torch.training.state import adam_step, init_adam
    rng = np.random.default_rng(4)
    for decay in (0.0, 0.01):
        p = {"a": rng.normal(size=(6, 5)).astype(np.float32),
             "b": rng.normal(size=(7,)).astype(np.float32)}
        group = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        opt = init_adam(group)
        tx = optax.scale_by_adam()
        ref = {k: jnp.asarray(v) for k, v in p.items()}
        state = tx.init(ref)
        for step in range(5):
            g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
            lr = 1e-3 * (0.5 ** step)
            adam_step(group, {k: torch.from_numpy(v) for k, v in g.items()}, opt,
                      torch.tensor(lr, dtype=torch.float64), weight_decay=decay)
            gj = {k: jnp.asarray(v) + decay * ref[k] for k, v in g.items()}
            upd, state = tx.update(gj, state, ref)
            ref = {k: ref[k] - jnp.float32(lr) * upd[k] for k in ref}
            for k in p:
                np.testing.assert_allclose(group[k].numpy(), np.asarray(ref[k]), rtol=0,
                                           atol=1e-6, err_msg=f"step {step} {k}")
        assert opt.count.dtype == torch.int64 and int(opt.count) == int(state.count) == 5
