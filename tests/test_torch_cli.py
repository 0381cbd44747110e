"""The port's train / eval / eval_poses entry points and its checkpoints, on the
CPU: the cases of tests/test_cli_checkpoint.py that apply to the port, and
checkpoints carried between the packages in both directions.

The CLI cases run the built-in synthetic scene at a tiny width (hidden 32,
8 samples, 64 rays: the unfused float path), as the JAX package's own CLI
tests do. Checkpoints are compared bit for bit: a round trip only changes the
array type.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.config import load_config as jax_load_config
from nope_nerf_tpu.training import ModelConfigs as JModelConfigs
from nope_nerf_tpu.training import create_train_state as jax_create
from nope_nerf_tpu.training.checkpoints import load_checkpoint as jax_load
from nope_nerf_tpu.training.checkpoints import save_checkpoint as jax_save

from nope_nerf_torch.cli.eval import evaluate
from nope_nerf_torch.cli.eval_poses import evaluate_poses
from nope_nerf_torch.cli.train import backup, train
from nope_nerf_torch.config import load_config
from nope_nerf_torch.convert import state_from_numpy, state_to_numpy
from nope_nerf_torch.data import SceneData, batch_for_frame, frame_iterator, make_synthetic_scene
from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params, reset_linear_params
from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
from nope_nerf_torch.training.checkpoints import (load_checkpoint, load_params, save_checkpoint,
                                                  save_params)
from nope_nerf_torch.training.scheduler import AutoScheduler

torch.set_num_threads(2)


def _overrides(out_dir, **extra):
    over = {
        "model": {"hidden_dim": 32},
        "rendering": {"num_points": 8},
        "training": {"n_training_points": 64, "out_dir": str(out_dir), "print_every": 0,
                     "checkpoint_every": 0, "backup_every": 0, "visualize_every": 0,
                     "vis_reprojection_every": 0, "eval_pose_every": 1, "eval_img_every": 1,
                     "vis_geo": False},
        "pose": {"learn_pose": True, "init_pose": True},
        "extract_images": {"N_novel_imgs": 4, "resolution": [12, 16]},
        "eval_pose": {"opt_pose_epoch": 2, "n_points": 64},
    }
    for k, v in extra.items():
        over.setdefault(k, {}).update(v)
    return over


def _tiny_cfg(out_dir, **extra):
    return load_config(overrides=_overrides(out_dir, **extra))


def _flat(state):
    """Every tensor of a state by name: params, Adam moments, generator state."""
    out = {}
    for g, d in state.params.items():
        for k, v in d.items():
            out[f"params/{g}/{k}"] = v
            out[f"mu/{g}/{k}"] = state.opt_state[g].mu[k]
            out[f"nu/{g}/{k}"] = state.opt_state[g].nu[k]
    out["generator"] = state.generator.get_state()
    return out


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.it == b.it
    assert {g: o.count for g, o in a.opt_state.items()} == {g: o.count
                                                            for g, o in b.opt_state.items()}


def _stepped_state(cfg, seed=0, steps=2):
    """A state a few train steps in: non-zero Adam moments, an advanced generator."""
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=3, h=24, w=32)).to_device("cpu")
    mc = ModelConfigs.from_cfg(cfg, 3)
    state = create_train_state(seed, mc, init_c2w=scene.c2ws_gt, device="cpu")
    trainer = Trainer(cfg, mc)
    for i in range(steps):
        state, _ = trainer.step(state, batch_for_frame(scene, i, ref_idx=i + 1), 0, 10000)
    return mc, state


# ---- checkpoints ----------------------------------------------------------------

def test_checkpoint_roundtrip_with_adam_state(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    mc, state = _stepped_state(cfg)
    scalars = {"epoch_it": 7, "scheduling_start": 123, "psnr_window": np.arange(3.0)}
    save_checkpoint(str(tmp_path), "model.ckpt", state, scalars)
    template = create_train_state(99, mc, init_c2w=torch.eye(4).expand(3, 4, 4), device="cpu")
    restored, s = load_checkpoint(str(tmp_path), "model.ckpt", template)
    assert s["epoch_it"] == 7 and s["scheduling_start"] == 123
    np.testing.assert_array_equal(s["psnr_window"], np.arange(3.0))
    _assert_states_equal(restored, state)
    assert restored.opt_state["nerf"].count == 2 and restored.it == 1
    assert float(restored.opt_state["nerf"].nu["rgb_b"].abs().max()) > 0
    # the restored generator continues the saved one's stream
    assert torch.equal(torch.rand(4, generator=restored.generator),
                       torch.rand(4, generator=state.generator))

    only, s2 = load_checkpoint(str(tmp_path), "model.ckpt", template, load_model_only=True)
    assert s2 == {} and only.it == template.it and only.opt_state is template.opt_state
    for g, d in state.params.items():
        for k, v in d.items():
            assert torch.equal(only.params[g][k], v)
    assert load_checkpoint(str(tmp_path), "nope.ckpt", template) is None


def test_checkpoint_refuses_what_does_not_fit(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    mc, state = _stepped_state(cfg, steps=1)
    save_params(str(tmp_path), "params.ckpt", state.params)
    with pytest.raises(ValueError, match="load_model_only"):
        load_checkpoint(str(tmp_path), "params.ckpt", state)
    loaded, _ = load_checkpoint(str(tmp_path), "params.ckpt", state, load_model_only=True)
    assert torch.equal(loaded.params["nerf"]["rgb_w"], state.params["nerf"]["rgb_w"])
    save_checkpoint(str(tmp_path), "model.ckpt", state)
    wide = ModelConfigs.from_cfg(_tiny_cfg(tmp_path, model={"hidden_dim": 64}), 3)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), "model.ckpt",
                        create_train_state(0, wide, init_c2w=torch.eye(4).expand(3, 4, 4),
                                           device="cpu"))
    no_dist = ModelConfigs.from_cfg(
        _tiny_cfg(tmp_path, distortion={"learn_distortion": False}), 3)
    with pytest.raises(ValueError, match="groups"):
        load_checkpoint(str(tmp_path), "model.ckpt",
                        create_train_state(0, no_dist, init_c2w=torch.eye(4).expand(3, 4, 4),
                                           device="cpu"))
    # a per-camera table may hold more cameras than the template (the eval CLI's split)
    two_cams = create_train_state(0, ModelConfigs.from_cfg(cfg, 2),
                                  init_c2w=torch.eye(4).expand(2, 4, 4), device="cpu")
    more, _ = load_checkpoint(str(tmp_path), "model.ckpt", two_cams, load_model_only=True)
    assert more.params["pose"]["r"].shape == (3, 3)


def _jax_state_with_moments(cfg, seed):
    mc = JModelConfigs.from_cfg(cfg, num_cams=3)
    state, optimizers = jax_create(jax.random.key(seed), mc,
                                   init_c2w=jnp.broadcast_to(jnp.eye(4), (3, 4, 4)))
    opt_state = dict(state.opt_state)
    for g in state.params:     # one update from a seeded gradient: non-zero moments, count 1
        grads = jax.tree.map(lambda p: 0.01 * jnp.cos(jnp.arange(p.size, dtype=jnp.float32)
                                                      ).reshape(p.shape), state.params[g])
        _, opt_state[g] = optimizers[g].update(grads, state.opt_state[g], state.params[g])
    return state.replace(opt_state=opt_state, it=state.it + 1)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_port_reads_jax_checkpoint_with_adam_moments(tmp_path, weight_decay):
    """A JAX checkpoint pickles optax's state classes; the port stubs them and
    still finds Adam's moments (behind add_decayed_weights' state too)."""
    over = _overrides(tmp_path, training={"weight_decay": weight_decay})
    jstate = _jax_state_with_moments(jax_load_config(overrides=over), seed=5)
    jax_save(str(tmp_path), "model.ckpt", jstate, {"epoch_it": 3})
    mc = ModelConfigs.from_cfg(load_config(overrides=over), 3)
    template = create_train_state(1, mc, init_c2w=torch.eye(4).expand(3, 4, 4), device="cpu")
    state, scalars = load_checkpoint(str(tmp_path), "model.ckpt", template)
    assert scalars == {"epoch_it": 3} and state.it == int(jstate.it) == 0
    assert state.generator is template.generator            # a JAX key does not convert
    for g, chain in jstate.opt_state.items():
        adam = next(s for s in chain if hasattr(s, "mu"))
        assert state.opt_state[g].count == int(adam.count) == 1
        for k in adam.mu:
            np.testing.assert_array_equal(state.params[g][k].numpy(), np.asarray(jstate.params[g][k]))
            np.testing.assert_array_equal(state.opt_state[g].mu[k].numpy(), np.asarray(adam.mu[k]))
            np.testing.assert_array_equal(state.opt_state[g].nu[k].numpy(), np.asarray(adam.nu[k]))
    params, _ = load_params(str(tmp_path), "model.ckpt", device="cpu")
    assert torch.equal(params["pose"]["t"], state.params["pose"]["t"])


def test_jax_reads_port_checkpoint_and_state_to_numpy_roundtrip(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    mc, state = _stepped_state(cfg)
    save_checkpoint(str(tmp_path), "model.ckpt", state, {"epoch_it": 1})
    jcfg = jax_load_config(overrides=_overrides(tmp_path))
    template, _ = jax_create(jax.random.key(6), JModelConfigs.from_cfg(jcfg, num_cams=3),
                             init_c2w=jnp.broadcast_to(jnp.eye(4), (3, 4, 4)))
    loaded, scalars = jax_load(str(tmp_path), "model.ckpt", template, load_model_only=True)
    assert scalars == {}
    for g, d in state.params.items():
        for k, v in d.items():
            np.testing.assert_array_equal(np.asarray(loaded.params[g][k]), v.numpy(), err_msg=k)

    params, opt, it = state_to_numpy(state)
    assert it == 1 and opt["nerf"]["count"] == 2 and isinstance(params["nerf"]["rgb_w"], np.ndarray)
    # the numpy form restores into a JAX state's structure, moments included
    jparams = jax.tree.map(lambda t, s: jnp.asarray(s, t.dtype), template.params, params)
    assert jax.tree.structure(jparams) == jax.tree.structure(template.params)
    adam = next(s for s in template.opt_state["nerf"] if hasattr(s, "mu"))
    jmu = jax.tree.map(lambda t, s: jnp.asarray(s, t.dtype), adam.mu, opt["nerf"]["mu"])
    np.testing.assert_array_equal(np.asarray(jmu["rgb_w"]), state.opt_state["nerf"].mu["rgb_w"].numpy())
    back = state_from_numpy(params, opt, it=it, seed=0, device="cpu")
    back.generator.set_state(state.generator.get_state())
    _assert_states_equal(back, state)


# ---- the CLIs ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three epochs on the synthetic scene with the checkpoint and validate
    hooks firing."""
    tmp_path = tmp_path_factory.mktemp("cli")
    cfg = _tiny_cfg(tmp_path / "out", training={"checkpoint_every": 5, "validate_every": 16,
                                                "print_every": 10})
    state, trainer, scene = train(cfg, synthetic=True, max_epochs=3, device="cpu")
    return tmp_path, cfg, state, scene


def test_train_cli_writes_checkpoint(trained):
    tmp_path, cfg, state, scene = trained
    out_dir = cfg["training"]["out_dir"]
    assert os.path.exists(os.path.join(out_dir, "model.ckpt"))
    assert state.it == 3 * 8 - 1 and scene.n_frames == 8
    assert state.params["nerf"]["rgb_w"].device.type == "cpu"
    params, scalars = load_params(out_dir, "model.ckpt", device="cpu")
    assert scalars["epoch_it"] == 2 and len(scalars["psnr_window"]) == 3
    assert torch.equal(params["pose"]["r"], state.params["pose"]["r"])


def test_best_checkpoint_saved(trained):
    tmp_path, cfg, state, scene = trained
    params, scalars = load_params(cfg["training"]["out_dir"], "model_best.ckpt", device="cpu")
    assert np.isfinite(scalars["psnr_best"]) and set(params) == {"nerf", "pose", "distortion"}


def test_eval_poses_cli(trained):
    tmp_path, cfg, state, scene = trained
    metrics = evaluate_poses(cfg, synthetic=True, device="cpu")
    assert set(metrics) == {"ate_trans", "ate_t_v2", "ate_r_v2_deg", "rpe_trans", "rpe_rot_deg"}
    # poses were initialized from the scene's and barely trained
    assert np.isfinite(metrics["ate_trans"]) and metrics["ate_trans"] < 1.0
    text = open(os.path.join(cfg["training"]["out_dir"], "extraction", "evaluation.txt")).read()
    assert "ATE_t:" in text and "RPE_r:" in text
    # vis: the metric trajectories as frustums (cli/vis_poses.py) and the figure
    evaluate_poses(cfg, vis=True, synthetic=True, device="cpu")
    extraction = os.path.join(cfg["training"]["out_dir"], "extraction")
    ply = open(os.path.join(extraction, "trajectory.ply")).read()
    n = scene.n_frames
    # per trajectory: 8 frustum segments of 2 vertices per camera, plus the polyline
    assert f"element vertex {2 * (16 * n + n)}" in ply
    assert f"element edge {2 * (8 * n + n - 1)}" in ply
    assert os.path.exists(os.path.join(extraction, "trajectory.png"))


def test_eval_poses_cli_is_zero_without_learned_poses(tmp_path):
    cfg = _tiny_cfg(tmp_path, pose={"learn_pose": False, "init_pose": False},
                    training={"pc_weight": [0.0, 0.0], "rgb_s_weight": [0.0, 0.0]})
    train(cfg, synthetic=True, max_epochs=1, device="cpu")
    metrics = evaluate_poses(cfg, synthetic=True, device="cpu")
    assert all(abs(v) < 1e-6 for v in metrics.values())


@pytest.mark.parametrize("type_to_eval", ["eval", "train"])
def test_eval_images_cli(trained, type_to_eval):
    tmp_path, cfg, state, scene = trained
    cfg = dict(cfg, eval_pose=dict(cfg["eval_pose"], type_to_eval=type_to_eval))
    summary = evaluate(cfg, synthetic=True, device="cpu", save=(type_to_eval == "eval"))
    assert np.isfinite(summary["mean_psnr"]) and 0 <= summary["mean_ssim"] <= 1
    assert "mean_lpips" not in summary
    extraction = os.path.join(cfg["training"]["out_dir"], "extraction")
    assert "LPIPS n/a" in open(os.path.join(extraction, "evaluation.txt")).read()
    if type_to_eval == "eval":
        assert os.path.exists(os.path.join(extraction, "img_out", "0000.png"))
        assert glob.glob(os.path.join(extraction, "video_out", "img.*"))


def test_train_cli_resume_continues(trained):
    tmp_path, cfg, state, scene = trained
    it_before = state.it
    state2, _, _ = train(cfg, synthetic=True, max_epochs=5, device="cpu")
    assert state2.it == 5 * 8 - 1 > it_before
    state3, _, _ = train(cfg, synthetic=True, max_epochs=5, device="cpu")   # nothing left to train
    assert state3.it == state2.it


def test_resume_is_bit_identical(tmp_path):
    """Train 4 epochs straight against 2 + checkpoint + resume + 2: parameters,
    Adam's moments and counts, the iteration counter and the generator's state
    are bit-identical (the epoch shuffles are seeded per epoch; everything
    else round-trips through the checkpoint)."""
    cfg_a = _tiny_cfg(tmp_path / "a", training={"checkpoint_every": 1})
    state_a, _, _ = train(cfg_a, synthetic=True, max_epochs=4, device="cpu")
    cfg_b = _tiny_cfg(tmp_path / "b", training={"checkpoint_every": 1})
    train(cfg_b, synthetic=True, max_epochs=2, device="cpu")
    state_b, _, _ = train(cfg_b, synthetic=True, max_epochs=4, device="cpu")
    _assert_states_equal(state_a, state_b)
    assert state_a.it == 31


def test_nan_loss_aborts_training(tmp_path):
    cfg = _tiny_cfg(tmp_path, training={"rgb_weight": [float("nan"), float("nan")]})
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train(cfg, synthetic=True, max_epochs=2, device="cpu")


def test_autoscheduler_window_persists():
    psnrs = list(20 + np.sin(np.arange(40) * 0.7) * 5)

    def run(break_at=None):
        auto = AutoScheduler(length_smooth=8, patient=3)
        sched, armed_at = 10_000, None
        for ep, p in enumerate(psnrs):
            if break_at is not None and ep == break_at:
                sd = dict(auto.state_dict())
                auto = AutoScheduler(length_smooth=8, patient=3)
                auto.load_state_dict(sd)
            new = auto.update(p, ep, sched)
            if new != sched and armed_at is None:
                armed_at = ep
            sched = new
        return sched, armed_at

    unbroken = run()
    assert unbroken == run(break_at=13) and unbroken[1] is not None


def test_hooks_write_visualization_reprojection_and_backups(tmp_path):
    cfg = _tiny_cfg(tmp_path / "out", training={"visualize_every": 10, "vis_resolution": [10, 12],
                                                "vis_reprojection_every": 6, "backup_every": 8})
    train(cfg, synthetic=True, max_epochs=2, device="cpu")
    out = tmp_path / "out"
    vis_dirs = glob.glob(str(out / "rendering" / "*_vis"))
    assert vis_dirs and all(os.path.exists(os.path.join(vis_dirs[0], n))
                            for n in ("rgb.png", "depth.png"))
    assert glob.glob(str(out / "rendering" / "*_img1.png"))
    assert glob.glob(str(out / "rendering" / "*_img2.png"))
    assert (out / "model_8.ckpt").exists() and (out / "model_0.ckpt").exists()


def test_scheduling_mode_reset_reinitializes_the_nerf(tmp_path):
    cfg = _tiny_cfg(tmp_path, training={"scheduling_mode": "reset", "scheduling_start": 1,
                                        "auto_scheduler": False})
    state, _, _ = train(cfg, synthetic=True, max_epochs=2, device="cpu")
    # fresh weights after epoch 1, Adam's moments kept
    bound = 1.0 / np.sqrt(32)
    assert float(state.params["nerf"]["density_b"].abs().max()) <= bound
    assert float(state.opt_state["nerf"].nu["rgb_w"].abs().max()) > 0
    ncfg = NerfConfig(hidden_dim=128)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(0), device="cpu")
    fresh = reset_linear_params(torch.Generator().manual_seed(1), params, ncfg)
    assert set(fresh) == set(params)
    assert all(fresh[k].shape == v.shape and not torch.equal(fresh[k], v) for k, v in params.items())
    assert float(fresh["rgb_b"].abs().max()) <= 1.0 / np.sqrt(64)
    assert float(fresh["density_b"].abs().max()) <= 1.0 / np.sqrt(128)


@pytest.mark.parametrize("section,key,value,match", [
    ("dataloading", "show_pose_only", True, "vis_poses"),
    ("tpu", "mesh_shape", [4], "multi-device"),
])
def test_train_refuses_unported_options_early(tmp_path, section, key, value, match):
    """tpu.mesh_shape of 4 in a run of one process raises before anything
    runs, and names the launch command (the multi-device layer itself is
    tests/test_torch_parallel.py's). dataloading.show_pose_only is ported
    (cli/vis_poses.py): train stops as early, once the pose figure is drawn,
    and trains nothing."""
    extra = {section: {key: value}}
    cfg = _tiny_cfg(tmp_path / "out", **extra)
    if key == "show_pose_only":
        out = train(cfg, synthetic=True, max_epochs=1, device="cpu")
        assert out == str(tmp_path / "out" / "pose_check.png") and os.path.exists(out)
        assert not (tmp_path / "out" / "model.ckpt").exists()        # nothing trained
        return
    with pytest.raises(ValueError, match=match) as err:
        train(cfg, synthetic=True, max_epochs=1, device="cpu")
    assert "torch.distributed.run --nproc_per_node 4" in str(err.value)
    assert not (tmp_path / "out").exists()          # nothing ran


def _occupancy_cfg(out_dir):
    return _tiny_cfg(out_dir, rendering={"occupancy_grid": True, "occupancy_res": 8})


@pytest.mark.parametrize("option", ["vis_geo", "occupancy_grid"])
def test_train_runs_vis_geo_and_occupancy(tmp_path, option):
    """training.vis_geo: the visualize hook writes the phong geometry view
    beside the rgb and depth images. rendering.occupancy_grid: the grid is
    created and updated every epoch, checkpointed with the scalars, and a
    resumed run (1 epoch, checkpoint, 1 epoch) ends bit-equal to 2 epochs
    straight, grid included; the checkpoint's grid loads into the JAX
    package's trainer, and a JAX checkpoint's into the port's."""
    if option == "vis_geo":
        cfg = _tiny_cfg(tmp_path / "out", training={"vis_geo": True, "visualize_every": 8,
                                                    "vis_resolution": [6, 8]})
        train(cfg, synthetic=True, max_epochs=1, device="cpu")
        vis_dirs = glob.glob(str(tmp_path / "out" / "rendering" / "*_vis"))
        assert vis_dirs and all(os.path.exists(os.path.join(d, "geo.png")) for d in vis_dirs)
        return

    import pickle
    from nope_nerf_tpu.training import Trainer as JTrainer

    state_a, trainer_a, _ = train(_occupancy_cfg(tmp_path / "a"), synthetic=True, max_epochs=2,
                                  device="cpu")
    grid = trainer_a.occ_grid
    assert grid.shape == (8, 8, 8) and not torch.equal(grid, torch.ones(8, 8, 8))
    _, scalars = load_params(str(tmp_path / "a"), "model.ckpt", device="cpu")
    np.testing.assert_array_equal(scalars["occ_grid"], grid.numpy())

    cfg_b = _occupancy_cfg(tmp_path / "b")
    train(cfg_b, synthetic=True, max_epochs=1, device="cpu")
    state_b, trainer_b, _ = train(cfg_b, synthetic=True, max_epochs=2, device="cpu")
    _assert_states_equal(state_a, state_b)
    assert torch.equal(trainer_a.occ_grid, trainer_b.occ_grid)

    # port -> JAX: the JAX package reads the scalars of the checkpoint's pickle
    jcfg = jax_load_config(overrides=_overrides(tmp_path / "j", rendering={
        "occupancy_grid": True, "occupancy_res": 8}))
    jmc = JModelConfigs.from_cfg(jcfg, num_cams=8)
    jstate, optimizers = jax_create(jax.random.key(0), jmc,
                                    init_c2w=jnp.broadcast_to(jnp.eye(4), (8, 4, 4)))
    with open(tmp_path / "a" / "model.ckpt", "rb") as f:
        payload = pickle.load(f)
    jtrainer = JTrainer(jcfg, jmc, optimizers)
    jtrainer.set_occupancy_grid(payload["scalars"]["occ_grid"])
    np.testing.assert_array_equal(np.asarray(jtrainer.occ_grid), grid.numpy())
    # JAX -> port
    jgrid = np.random.default_rng(0).uniform(size=(8, 8, 8)).astype(np.float32)
    jax_save(str(tmp_path / "j"), "model.ckpt", jstate, {"epoch_it": 0, "occ_grid": jgrid})
    _, jscalars = load_params(str(tmp_path / "j"), "model.ckpt", device="cpu")
    trainer_c = Trainer(cfg_b, ModelConfigs.from_cfg(cfg_b, 8))
    trainer_c.set_occupancy_grid(jscalars["occ_grid"])
    np.testing.assert_array_equal(trainer_c.occ_grid.numpy(), jgrid)


def test_entry_points_refuse_disk_scenes_and_lpips_weights(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    # scenes on disk are ported: a config that names none is refused by name
    for call in (lambda: train(cfg, device="cpu"), lambda: evaluate(cfg, device="cpu"),
                 lambda: evaluate_poses(cfg, device="cpu")):
        with pytest.raises(ValueError, match="dataloading.path"):
            call()
    with pytest.raises(FileNotFoundError):
        evaluate(cfg, synthetic=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        evaluate_poses(cfg, synthetic=True, device="cpu")
    # LPIPS is ported: a config that names a weight file reports mean_lpips
    from test_torch_lpips import random_params
    np.savez(tmp_path / "lpips.npz", **random_params(0))
    with_lpips = _tiny_cfg(tmp_path / "lpips_run",
                           extract_images={"lpips_weights": str(tmp_path / "lpips.npz")})
    train(with_lpips, synthetic=True, max_epochs=1, device="cpu")
    summary = evaluate(with_lpips, synthetic=True, device="cpu", save=False)
    assert np.isfinite(summary["mean_lpips"]) and summary["mean_lpips"] > 0


def test_backup_snapshots_config_and_source(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    backup(str(tmp_path), os.path.join(repo, "configs", "demo_drive.yaml"))
    bk = tmp_path / "backup"
    assert (bk / "config.yaml").exists()
    assert (bk / "nope_nerf_torch" / "cli" / "train.py").exists()
    assert (bk / "nope_nerf_torch" / "csrc" / "render_bwd.cu").exists()
    assert not list((bk / "nope_nerf_torch").rglob("__pycache__"))


def test_frame_iterator_follows_epoch_order():
    from nope_nerf_tpu.data import SceneData as JSceneData, frame_iterator as jax_frame_iterator
    scene_np = dict(make_synthetic_scene(n_frames=5, h=8, w=8))
    got = list(frame_iterator(SceneData.from_dict(scene_np), random_ref=2, seed=3))
    ref = list(jax_frame_iterator(JSceneData.from_dict(scene_np), random_ref=2, seed=3))
    assert [(b["idx"], b["ref_idx"]) for b in got] == [(int(b["idx"]), int(b["ref_idx"]))
                                                       for b in ref]
    np.testing.assert_array_equal(got[0]["ref_img"], ref[0]["ref_img"])
