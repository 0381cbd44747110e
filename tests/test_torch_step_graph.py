"""The step body that the card captures in a CUDA graph, on the CPU.

The port's train step reads nothing back to the host: its frame indices,
schedule scalars and Adam count are device tensors (training/trainer.py::
scene_step), so the card replays it as a CUDA graph (training/graphs.py).
The same body runs eagerly here. The tests hold it
- to itself: Trainer.run_steps (the epoch's pairs in a device table) and a
  loop of per-step Trainer.step give torch.equal states and loss terms;
- to the JAX package's scanned train_steps (Trainer.run_steps there, one
  lax.scan dispatch) with every draw pinned to the ones JAX takes from its
  key chain, for the fused-gate config (depth l1), depth_loss_type invariant
  and n_importance 64, in float32 mode (use_pallas_renderer false: the
  nerf_apply route on both sides), on tests/test_torch_trainer.py's 24x32
  frames. At 120x160 the Chamfer term's clouds hold 1,200 points and a
  nearest neighbour that is a near tie can resolve one way in one package's
  float32 distances and the other way in the other's: at step 3 of these
  draws one pose-gradient entry then moves by 1% of its block (it agrees to
  3e-8 with pc_weight 0, with integer frame indices as well), and Adam turns
  that into a sign flip of lr;
- the pose-optimisation loop (device frame index, rate and loss sum) to the
  JAX package's optimize_test_poses, its ray draws pinned the same way;
- and runs the body with every Python-level readback (item, bool, int,
  float, cpu, numpy, tolist) patched to raise.

Tolerances: PERF.md section 2's float32 ones, as tests/test_torch_trainer.py
states them: loss terms rtol 1e-4 (atol 1e-6), parameters after the 3 Adam
steps atol 1e-5 (Adam divides by sqrt(nu), so an entry whose gradient is
round-off moves by a few lr whichever way the round-off points); the
pose-optimisation run at tests/test_torch_eval.py's pose-opt tolerance (loss
rtol 1e-4, pose parameters atol 1e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.config import load_config as jax_load_config
from nope_nerf_tpu.data import SceneData as JSceneData, make_synthetic_scene
from nope_nerf_tpu.evaluation import pose_opt as jax_pose_opt
from nope_nerf_tpu.training import ModelConfigs as JModelConfigs
from nope_nerf_tpu.training import create_train_state as jax_create
from nope_nerf_tpu.training.trainer import Trainer as JTrainer, _draw_rays

from nope_nerf_torch.config import load_config
from nope_nerf_torch.convert import state_from_numpy
from nope_nerf_torch.data import SceneData, batch_for_frame
from nope_nerf_torch.evaluation import pose_opt
from nope_nerf_torch.models.nerf import init_nerf_params
from nope_nerf_torch.models.poses import PoseConfig, init_pose_params
from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
from nope_nerf_torch.training.state import init_adam
from nope_nerf_torch.training.trainer import LOSS_TERMS, scene_step

torch.set_num_threads(2)
N_FRAMES, H, W, N_RAYS, S, N_IMP = 4, 120, 160, 16, 128, 64
JAX_HW = (24, 32)          # the JAX parity runs' frames (see the module docstring)
SCHED_START = 10000
ORDER, REFS = [0, 3, 1], [1, 2, 2]      # frame 3 takes the backward branch of the pair
CONFIGS = {"fused_gate": {},
           "invariant": {"training": {"depth_loss_type": "invariant"}},
           "hierarchical": {"rendering": {"n_importance": N_IMP}}}


def _overrides(name, f32=True):
    over = {"model": {"hidden_dim": 128}, "training": {"n_training_points": N_RAYS},
            "pose": {"learn_pose": True, "init_pose": True}}
    if f32:
        over["tpu"] = {"use_pallas_renderer": False, "compute_dtype": "float32"}
    for k, v in CONFIGS[name].items():
        over[k] = {**over.get(k, {}), **v}
    return over


def _scene(hw=(H, W)):
    return dict(make_synthetic_scene(n_frames=N_FRAMES, h=hw[0], w=hw[1]))


def _port(name, f32=True, hw=(H, W)):
    cfg = load_config(overrides=_overrides(name, f32))
    scene = SceneData.from_dict(_scene(hw)).to_device("cpu")
    mc = ModelConfigs.from_cfg(cfg, N_FRAMES)
    return cfg, scene, mc


def _assert_states_equal(a, b):
    assert a.it == b.it
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for g in a.params:
        assert torch.equal(a.opt_state[g].count, b.opt_state[g].count)
        for k in a.params[g]:
            assert torch.equal(a.params[g][k], b.params[g][k]), (g, k)
            assert torch.equal(a.opt_state[g].mu[k], b.opt_state[g].mu[k]), (g, k)
            assert torch.equal(a.opt_state[g].nu[k], b.opt_state[g].nu[k]), (g, k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_steps_equals_per_step_trainer_step(name):
    """One body, two ways of feeding it: the epoch's pair table and a batch at
    a time. The default (bfloat16, fused-route) widths, the kernels' plain
    versions on the CPU; the generator draws the rays and the jitter."""
    cfg, scene, mc = _port(name, f32=False)
    a = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    b = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    a, lds = Trainer(cfg, mc).run_steps(a, scene, ORDER, REFS, 0, SCHED_START)
    trainer = Trainer(cfg, mc)
    for j, (idx, ref) in enumerate(zip(ORDER, REFS)):
        b, ld = trainer.step(b, batch_for_frame(scene, idx, ref_idx=ref), 0, SCHED_START)
        assert list(ld) == list(LOSS_TERMS)
        for k in LOSS_TERMS:
            assert torch.equal(lds[k][j], ld[k]), (j, k)
    _assert_states_equal(a, b)
    assert a.it == len(ORDER) - 1


def _jax_side(name):
    cfg = jax_load_config(overrides=_overrides(name))
    scene = JSceneData.from_dict(_scene(JAX_HW))
    mc = JModelConfigs.from_cfg(cfg, N_FRAMES)
    state, optimizers = jax_create(jax.random.key(0), mc, init_c2w=jnp.asarray(scene.c2ws_gt))
    return cfg, scene, mc, state, optimizers


def _jax_pins(rng, steps, n_importance):
    """The draws JAX's train_step takes from its key chain, step by step:
    rays from split(split(rng, 3)[1])[1] (_sample_rays), the stratified
    jitter and the fine draw from the render key split(rng, 3)[2]; the
    chain goes on with split(split(rng, 3)[1])[0]."""
    rays, noise, fine = [], [], []
    for _ in range(steps):
        _, kray, krender = jax.random.split(rng, 3)
        rng, k0 = jax.random.split(kray)
        rays.append(np.asarray(_draw_rays(k0, JAX_HW[0] * JAX_HW[1], N_RAYS)).astype(np.int64))
        kc, knoise, _ = jax.random.split(krender, 3)
        noise.append(np.asarray(jax.random.uniform(knoise, (N_RAYS, S), jnp.float32)))
        fine.append(np.asarray(jax.random.uniform(jax.random.fold_in(kc, 1),
                                                  (N_RAYS, max(n_importance, 1)),
                                                  jnp.float32, 0.0, 1.0 - 1e-5)))
    pins = {"ray_idx": torch.from_numpy(np.stack(rays)),
            "noise": torch.from_numpy(np.stack(noise))}
    if n_importance:
        pins["fine_u"] = torch.from_numpy(np.stack(fine))
    return pins


def _numpy_state(state):
    params = jax.tree.map(np.asarray, state.params)
    opt = {}
    for g, chain in state.opt_state.items():
        adam = next(s for s in chain if hasattr(s, "mu"))
        opt[g] = {"mu": jax.tree.map(np.asarray, adam.mu),
                  "nu": jax.tree.map(np.asarray, adam.nu), "count": int(adam.count)}
    return params, opt


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_steps_matches_jax_scanned_train_steps(name):
    jcfg, jscene, jmc, jstate, optimizers = _jax_side(name)
    jstate_end, jlds = JTrainer(jcfg, jmc, optimizers).run_steps(
        jstate, jscene, ORDER, REFS, 0, SCHED_START)
    pins = _jax_pins(jstate.rng, len(ORDER), jmc.render.n_importance)

    cfg, scene, mc = _port(name, hw=JAX_HW)
    state = state_from_numpy(*_numpy_state(jstate), it=int(jstate.it), device="cpu")
    state, lds = Trainer(cfg, mc).run_steps(state, scene, ORDER, REFS, 0, SCHED_START,
                                            pins=pins)
    for k in LOSS_TERMS:
        np.testing.assert_allclose(lds[k].numpy(), np.asarray(jlds[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    ref_params, ref_opt = _numpy_state(jstate_end)
    for g in ref_params:
        for k, r in ref_params[g].items():
            np.testing.assert_allclose(state.params[g][k].numpy(), r, rtol=0, atol=1e-5,
                                       err_msg=f"{g}/{k}")
        assert int(state.opt_state[g].count) == ref_opt[g]["count"] == len(ORDER)
    assert state.it == int(jstate_end.it)


def test_pose_opt_loop_matches_jax_optimize_test_poses():
    """3 epochs x 2 frames of the port's loop (device frame index, rate and
    loss sum) against the JAX package's scanned one, the rays JAX draws from
    key(seed) handed to the port."""
    n_frames, n_points, epochs, seed = 2, 16, 3, 5
    over = {"model": {"hidden_dim": 64}, "rendering": {"num_points": 16},
            "tpu": {"use_pallas_renderer": False, "compute_dtype": "float32"}}
    jmc = JModelConfigs.from_cfg(jax_load_config(overrides=over), n_frames)
    mc = ModelConfigs.from_cfg(load_config(overrides=over), n_frames)
    scene = _scene()
    eval_scene = JSceneData.from_dict({k: v[:n_frames] if k != "K" else v
                                       for k, v in scene.items()})
    init = np.asarray(eval_scene.c2ws_gt) @ np.array(
        [[1, 0, 0, 0.05], [0, 1, 0, -0.03], [0, 0, 1, 0.02], [0, 0, 0, 1]], np.float32)
    jstate, _ = jax_create(jax.random.key(0), jmc)
    jparams, jc2ws = jax_pose_opt.optimize_test_poses(
        jstate.params["nerf"], None, eval_scene, jmc.nerf, jmc.render, init_c2ws=init,
        n_points=n_points, n_epochs=epochs, seed=seed, log_every=0)
    key = jax.random.key(seed)
    rays = np.zeros((epochs, n_frames, n_points), np.int64)
    for e in range(epochs):
        for i in range(n_frames):
            key, kray = jax.random.split(key)
            rays[e, i] = np.asarray(_draw_rays(kray, H * W, n_points))
    nerf = {k: torch.from_numpy(np.array(v)) for k, v in jstate.params["nerf"].items()}
    params, c2ws = pose_opt.optimize_test_poses(
        nerf, None, SceneData.from_dict({k: np.asarray(getattr(eval_scene, k)) for k in
                                         ("imgs", "depths", "depth_masks", "c2ws_gt", "K")}),
        mc.nerf, mc.render, init_c2ws=init, n_points=n_points, n_epochs=epochs, seed=seed,
        log_every=0, device="cpu", ray_idx=torch.from_numpy(rays))
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(c2ws, np.asarray(jc2ws), rtol=0, atol=1e-5)
    assert float(np.abs(params["t"].numpy()).max()) > 1e-4      # the poses moved


def _raise(*_args, **_kwargs):
    raise AssertionError("the step body read a tensor back to the host")


READBACKS = ("item", "__bool__", "__int__", "__float__", "cpu", "numpy", "tolist")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_body_reads_nothing_back(name, monkeypatch):
    """scene_step, the body run_steps captures, with every Python-level
    readback patched to raise (the card's set_sync_debug_mode check catches
    the rest). It runs once first: the constants the ops cache are built
    there, as in the warm-up before a capture."""
    cfg, scene, mc = _port(name, f32=False)
    trainer = Trainer(cfg, mc)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    weights, lrs, rgb_loss_type = trainer._schedule(0, SCHED_START, torch.device("cpu"))
    stack = trainer.scene_stack(scene)
    pairs = torch.tensor([[3, 2], [0, 1]])
    counter = torch.zeros((1,), dtype=torch.int64)
    scene_step(state, stack, pairs, counter, weights, lrs, mc, rgb_loss_type)
    counter.add_(1)
    for attr in READBACKS:
        monkeypatch.setattr(torch.Tensor, attr, _raise)
    ld = scene_step(state, stack, pairs, counter, weights, lrs, mc, rgb_loss_type)
    monkeypatch.undo()
    assert set(ld) == set(LOSS_TERMS)
    assert all(bool(torch.isfinite(v)) for v in ld.values())


def test_pose_opt_step_reads_nothing_back(monkeypatch):
    cfg, scene, mc = _port("fused_gate", f32=False)
    nerf = init_nerf_params(mc.nerf, torch.Generator().manual_seed(0), device="cpu")
    pcfg = PoseConfig(num_cams=N_FRAMES, use_init_c2w=True)
    pose = init_pose_params(pcfg, scene.c2ws_gt, device="cpu")
    adam = init_adam(pose)
    frame = torch.tensor([1])
    rate = torch.tensor(1e-3, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)

    def step():
        rays = torch.randperm(H * W, generator=gen)[:N_RAYS]
        return pose_opt.pose_opt_step(pose, adam, nerf, None,
                                      scene.imgs.index_select(0, frame)[0], frame, scene.K,
                                      rays, rate, pcfg, None, mc.nerf, mc.render)
    step()
    for attr in READBACKS:
        monkeypatch.setattr(torch.Tensor, attr, _raise)
    loss = step()
    monkeypatch.undo()
    assert bool(torch.isfinite(loss)) and int(adam.count) == 2


def test_trainer_graphs_off_and_cpu_state_run_eagerly():
    """No graph is captured for a CPU state, nor with graphs=False."""
    cfg, scene, mc = _port("fused_gate", f32=False)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    for trainer in (Trainer(cfg, mc), Trainer(cfg, mc, graphs=False)):
        state, _ = trainer.run_steps(state, scene, ORDER[:1], REFS[:1], 0, SCHED_START)
        assert not trainer._graphed(state) and trainer.captured_steps() == []


def test_schedule_tensors_filled_once_per_epoch():
    cfg, scene, mc = _port("fused_gate", f32=False)
    trainer = Trainer(cfg, mc)
    cpu = torch.device("cpu")
    w0, l0, _ = trainer._schedule(0, 0, cpu)
    ref_w, ref_l = trainer.weights_at(0, 0), trainer.lrs_at(0, 0)
    assert all(w0[k].dtype == torch.float32 and float(w0[k]) == np.float32(v)
               for k, v in ref_w.items())
    assert all(l0[g].dtype == torch.float64 and float(l0[g]) == v for g, v in ref_l.items())
    w1, l1, _ = trainer._schedule(150, 0, cpu)
    assert w1["rgb_weight"] is w0["rgb_weight"] and l1["nerf"] is l0["nerf"]    # the same buffers
    assert float(l1["nerf"]) == trainer.lrs_at(150, 0)["nerf"] != ref_l["nerf"]


def test_adam_count_is_a_device_tensor_advanced_in_place():
    cfg, scene, mc = _port("fused_gate", f32=False)
    state = create_train_state(0, mc, init_c2w=scene.c2ws_gt, device="cpu")
    counts = {g: o.count for g, o in state.opt_state.items()}
    state, _ = Trainer(cfg, mc).run_steps(state, scene, ORDER[:2], REFS[:2], 0, SCHED_START)
    for g, o in state.opt_state.items():
        assert o.count is counts[g] and o.count.dtype == torch.int64 and int(o.count) == 2


def test_pose_c2w_and_distortion_take_index_tensors():
    """The device-index lookups equal the integer ones, the pinned last scale
    included."""
    from nope_nerf_torch.models.distortions import DistortionConfig, distortion_scale_shift
    from nope_nerf_torch.models.poses import pose_c2w
    rng = np.random.default_rng(0)
    pcfg = PoseConfig(num_cams=3, use_init_c2w=True)
    pose = {"r": torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32)),
            "t": torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32)),
            "init_c2w": torch.eye(4).repeat(3, 1, 1)}
    dcfg = DistortionConfig(num_cams=3)
    dist = {"scale": torch.tensor([[0.5], [0.001], [2.0]]), "shift": torch.tensor([[1.], [2.], [3.]])}
    for i in range(3):
        t = torch.tensor([i])
        assert torch.equal(pose_c2w(pose, t, pcfg), pose_c2w(pose, i, pcfg))
        for a, b in zip(distortion_scale_shift(dist, t, dcfg), distortion_scale_shift(dist, i, dcfg)):
            assert torch.equal(a, b)
    assert float(distortion_scale_shift(dist, torch.tensor([2]), dcfg)[0]) == 1.0
    assert float(distortion_scale_shift(dist, torch.tensor([1]), dcfg)[0]) == np.float32(0.01)


def test_dataclass_replace_keeps_the_count_tensor():
    """AdamState turns a number into a 0-d int64 count beside its moments."""
    from nope_nerf_torch.training.state import AdamState
    mu = {"a": torch.zeros(3)}
    st = AdamState(mu=mu, nu={"a": torch.zeros(3)}, count=4)
    assert st.count.dtype == torch.int64 and int(st.count) == 4
    st2 = dataclasses.replace(st)
    assert st2.count is st.count


def test_failing_operation_names_the_frame_that_raised():
    """GraphCaptureError's message names the innermost frame outside torch:
    here the test's own body, under torch's autograd."""
    from nope_nerf_torch.training.graphs import failing_operation

    def body():
        x = torch.ones(3, requires_grad=True)
        return torch.autograd.grad(x.sum(), [x, torch.ones(2)])   # the second is no input
    with pytest.raises(RuntimeError) as info:
        body()
    assert "test_torch_step_graph.py" in failing_operation(info.value)
    assert "in body: return torch.autograd.grad" in failing_operation(info.value)
