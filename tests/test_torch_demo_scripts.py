"""The port's demo scripts (nope_nerf_torch/scripts/) against the repository's
root scripts and the JAX package, on the CPU at a tiny size (3 frames at
24x32), and cli.train from a yaml that save_config wrote, with PyYAML blocked.

- make_demo_scene writes the files the JAX package's write_vkitti_scene
  writes with the same arguments: PNGs decoded equal (the port's read_png
  against imageio), npy / npz arrays equal;
- make_nonmetric_priors writes the npz `pred` arrays the root script writes
  (run in a subprocess here, where imageio exists);
- demo_joint_pose_training --device cpu runs two epochs of a narrow config and
  prints finite ATE; its initial ATE equals the JAX script's at identity init;
- the script's training from identity poses, step by step against the JAX
  package's from one converted state: pose parameters and ATE.
"""

import os
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.config import load_config as jax_load_config
from nope_nerf_tpu.data import SceneData as JaxSceneData
from nope_nerf_tpu.data import batch_for_frame as jax_batch_for_frame
from nope_nerf_tpu.data import make_driving_scene as jax_make_driving_scene
from nope_nerf_tpu.data import make_synthetic_scene as jax_make_synthetic_scene
from nope_nerf_tpu.data import write_vkitti_scene as jax_write_vkitti_scene
from nope_nerf_tpu.evaluation.pose_eval import full_pose_evaluation as jax_pose_evaluation
from nope_nerf_tpu.models.poses import pose_c2w_all as jax_pose_c2w_all
from nope_nerf_tpu.training import ModelConfigs as JaxModelConfigs
from nope_nerf_tpu.training import Trainer as JaxTrainer
from nope_nerf_tpu.training import compute_step_loss as jax_step_loss
from nope_nerf_tpu.training import create_train_state as jax_create_train_state
from nope_nerf_tpu.training.state import apply_updates_with_lr

from nope_nerf_torch.convert import state_from_numpy
from nope_nerf_torch.data import SceneData, batch_for_frame, epoch_order
from nope_nerf_torch.evaluation.pose_eval import full_pose_evaluation
from nope_nerf_torch.models.poses import pose_c2w_all
from nope_nerf_torch.training import ModelConfigs, Trainer, train_step

from nope_nerf_torch.cli import train as cli_train
from nope_nerf_torch.config import load_config, save_config
from nope_nerf_torch.data.image_io import read_png
from nope_nerf_torch.scripts import (demo_joint_pose_training, make_demo_scene,
                                     make_nonmetric_priors)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--frames", "3", "--height", "24", "--width", "32"]
NARROW = {"model": {"hidden_dim": 32}, "rendering": {"num_points": 8},
          "training": {"n_training_points": 64}}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_make_demo_scene_writes_the_jax_writers_files(tmp_path):
    port, ref = tmp_path / "port" / "drive", tmp_path / "jax" / "drive"
    make_demo_scene.main(["--dest", str(port)] + TINY + ["--pose-noise-deg", "2.0"])
    jax_write_vkitti_scene(str(ref), jax_make_driving_scene(n_frames=3, h=24, w=32),
                           pose_noise_deg=2.0, pose_noise_trans=0.05)
    names = _files(ref)
    assert names == _files(port) and len(names) == 3 + 2 * 3
    for name in names:
        a, b = str(port / name), str(ref / name)
        if name.endswith(".png"):
            got, want = read_png(a), imageio.imread(b)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        elif name.endswith(".npz"):
            with np.load(a) as fa, np.load(b) as fb:
                assert sorted(fa.files) == sorted(fb.files)
                assert all(np.array_equal(fa[k], fb[k]) for k in fa.files), name
        else:
            assert np.array_equal(np.load(a), np.load(b)), name


def test_make_nonmetric_priors_matches_the_root_script(tmp_path):
    scene = tmp_path / "drive"
    make_demo_scene.main(["--dest", str(scene)] + TINY)
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_nonmetric_priors.py"),
                    "--scene", str(scene), "--out-name", "root", "--seed", "5"],
                   check=True, capture_output=True)
    make_nonmetric_priors.main(["--scene", str(scene), "--out-name", "port", "--seed", "5"])
    names = sorted(os.listdir(scene / "root"))
    assert names == sorted(os.listdir(scene / "port")) == [
        f"depth_{i:05d}.npz" for i in range(3)]
    for n in names:
        with np.load(scene / "port" / n) as a, np.load(scene / "root" / n) as b:
            assert a.files == b.files == ["pred"]
            assert a["pred"].dtype == np.float32 and np.array_equal(a["pred"], b["pred"])


def _jax_initial_metrics(frames, h, w):
    """The root script's first ATE: its config, its state from key 0, identity poses."""
    cfg = jax_load_config(overrides={
        "training": {"n_training_points": 1024},
        "pose": {"learn_pose": True, "init_pose": False},
        "tpu": {"use_pallas_renderer": True}})
    mc = JaxModelConfigs.from_cfg(cfg, num_cams=frames)
    state, _ = jax_create_train_state(jax.random.key(0), mc)
    gt = np.asarray(jax_make_synthetic_scene(n_frames=frames, h=h, w=w)["c2ws_gt"])
    learned = np.asarray(jax_pose_c2w_all(state.params["pose"], mc.pose))
    return jax_pose_evaluation(learned, gt)


def test_demo_joint_pose_training_runs_two_epochs(capsys):
    out = demo_joint_pose_training.main(["--device", "cpu", "--epochs", "2"] + TINY,
                                        overrides=NARROW)
    text = capsys.readouterr().out
    assert "ep    0: PSNR" in text and "ep    1: PSNR" in text and "final: ATE_t" in text
    for stage in ("initial", "final"):
        assert all(np.isfinite(v) for v in out[stage].values())
    want = _jax_initial_metrics(3, 24, 32)
    assert out["initial"].keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(out["initial"][k], v, rtol=0, atol=1e-6, err_msg=k)


def _numpy_state(state):
    """(params, {group: {mu, nu, count}}) of a JAX TrainState, as numpy."""
    params = jax.tree.map(np.asarray, state.params)
    opt = {}
    for g, chain in state.opt_state.items():
        adam = next(c for c in chain if hasattr(c, "mu"))
        opt[g] = {"mu": jax.tree.map(np.asarray, adam.mu), "nu": jax.tree.map(np.asarray, adam.nu),
                  "count": int(adam.count)}
    return params, opt


def test_joint_pose_trajectory_matches_jax_f32():
    """The joint script's training from identity poses (learn_pose, no
    init_pose, scheduling_start 10000), held step by step against the JAX
    package's train step: 3 frames at 24x32, 16 rays x 16 samples, width 32,
    float32 (use_pallas_renderer off), two epochs in epoch_order's order
    seeded by the epoch, each epoch's weights and learning rates (each side's
    own Trainer), the ray
    indices and the z jitter pinned as tests/test_torch_trainer.py pins them,
    from one converted state. After every step the pose group's parameters
    agree to 1e-5 (a few of its lr: Adam moves an entry whose gradient is
    rounding noise by lr), after every epoch ATE_r to 1e-3 deg (1e-5 rad is
    5.7e-4 deg); by the end the poses have moved 50 times 1e-5 from identity,
    and each step moves them by about the pose lr (5e-4), so a pose step of
    another size, sign or schedule shows."""
    frames, h, w, n_rays, points = 3, 24, 32, 16, 16
    overrides = {"model": {"hidden_dim": 32}, "rendering": {"num_points": points},
                 "training": {"n_training_points": n_rays},
                 "pose": {"learn_pose": True, "init_pose": False},
                 "tpu": {"use_pallas_renderer": False, "compute_dtype": "float32"}}
    scene_dict = dict(jax_make_synthetic_scene(n_frames=frames, h=h, w=w))
    jcfg = jax_load_config(overrides=overrides)
    jscene = JaxSceneData.from_dict(scene_dict)
    jmc = JaxModelConfigs.from_cfg(jcfg, frames)
    jstate, optimizers = jax_create_train_state(jax.random.key(0), jmc)
    jtrainer = JaxTrainer(jcfg, jmc, optimizers)
    grad = jax.jit(jax.grad(jax_step_loss, has_aux=True), static_argnums=(5, 6))

    cfg = load_config(overrides=overrides)
    scene = SceneData.from_dict(scene_dict).to_device("cpu")
    mc = ModelConfigs.from_cfg(cfg, frames)
    trainer = Trainer(cfg, mc)
    state = state_from_numpy(*_numpy_state(jstate), it=0, device="cpu")
    gt = np.asarray(scene_dict["c2ws_gt"])

    def ate_r(port_params, jax_params):
        with torch.no_grad():
            got = full_pose_evaluation(pose_c2w_all(port_params, mc.pose).numpy(), gt)
        want = jax_pose_evaluation(np.asarray(jax_pose_c2w_all(jax_params, jmc.pose)), gt)
        return got["ate_r_v2_deg"], want["ate_r_v2_deg"]

    step = 0
    for ep in range(2):
        weights, lrs = trainer.weights_at(ep, 10000), trainer.lrs_at(ep, 10000)
        rgb_loss_type = trainer.rgb_loss_type(ep, 10000)
        jweights, jlrs = jtrainer.weights_at(ep, 10000), jtrainer.lrs_at(ep, 10000)
        assert rgb_loss_type == jtrainer.rgb_loss_type(ep, 10000)
        for idx, ref in zip(*epoch_order(frames, seed=ep)):
            rng = np.random.default_rng(100 + step)
            ray_idx = rng.permutation(h * w)[:n_rays].astype(np.int32)
            key = jax.random.key(200 + step)
            noise = np.array(jax.random.uniform(jax.random.split(key, 3)[1], (n_rays, points)))

            batch = {k: jnp.asarray(v) for k, v in
                     jax_batch_for_frame(jscene, int(idx), ref_idx=int(ref)).items()}
            g, _ = grad(jstate.params, batch, jweights, jnp.asarray(ray_idx), key, jmc,
                        rgb_loss_type)
            params, opt = dict(jstate.params), dict(jstate.opt_state)
            for name in params:
                updates, opt[name] = optimizers[name].update(g[name], opt[name], params[name])
                params[name] = apply_updates_with_lr(params[name], updates, jlrs[name])
            jstate = jstate.replace(params=params, opt_state=opt, it=jstate.it + 1)

            state, _ = train_step(state, batch_for_frame(scene, int(idx), ref_idx=int(ref)),
                                  weights, lrs, mc, rgb_loss_type,
                                  ray_idx=torch.from_numpy(ray_idx).long(),
                                  noise=torch.from_numpy(noise))
            for k, r in jstate.params["pose"].items():
                np.testing.assert_allclose(state.params["pose"][k].numpy(), np.asarray(r),
                                           rtol=0, atol=1e-5, err_msg=f"step {step} pose/{k}")
            step += 1
        got, want = ate_r(state.params["pose"], jstate.params["pose"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=f"epoch {ep}")
    moved = max(float(np.abs(np.asarray(r)).max()) for r in jstate.params["pose"].values())
    assert moved > 50 * 1e-5, moved


def test_demo_joint_pose_training_refuses_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo_joint_pose_training.main(["--epochs", "1"])


def test_cli_train_from_a_saved_yaml_without_pyyaml(tmp_path, monkeypatch):
    """cli.train.main reads a config save_config wrote (configs/demo_drive.yaml
    at tiny widths) for the demo scene on disk, with `import yaml` failing."""
    monkeypatch.chdir(tmp_path)
    make_demo_scene.main(TINY)
    cfg = load_config(os.path.join(REPO, "configs", "demo_drive.yaml"), overrides={
        **NARROW, "training": {**NARROW["training"], "vis_geo": False,
                               "out_dir": "out/demo/tiny"}})
    save_config(cfg, "tiny.yaml")
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setattr(sys, "argv", ["train", "tiny.yaml", "--device", "cpu",
                                      "--max-epochs", "1"])
    cli_train.main()
    assert os.path.exists("out/demo/tiny/model.ckpt")
    assert os.path.exists("out/demo/tiny/backup/config.yaml")
    assert load_config("out/demo/tiny/backup/config.yaml") == cfg
