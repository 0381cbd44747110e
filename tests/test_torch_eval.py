"""Port parity for the evaluation path: the metrics, the trajectory alignment,
the image evaluation, test-time pose optimisation and Trainer.render_frame of
nope_nerf_torch against their nope_nerf_tpu counterparts on the same numpy
arrays, on the CPU (the cases of tests/test_evaluation.py, run on both sides).

Tolerances: the numpy-only modules rtol 1e-5 (the port's are copies: the
results are equal); SSIM rtol 1e-5 (another convolution's order of sums);
pose optimisation in float32 mode, pose parameters after 3 Adam steps atol
1e-5 (Adam divides by sqrt(nu): see tests/test_torch_trainer.py); rendered
frames atol 1e-5 in float32 mode.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import jax
import jax.numpy as jnp
import optax

from nope_nerf_tpu import evaluation as JE
from nope_nerf_tpu.config import load_config
from nope_nerf_tpu.data import SceneData as JSceneData, batch_for_frame as jax_batch
from nope_nerf_tpu.data import make_synthetic_scene
from nope_nerf_tpu.evaluation import image_eval as jax_image_eval
from nope_nerf_tpu.evaluation import pose_opt as jax_pose_opt
from nope_nerf_tpu.evaluation.pose_eval import full_pose_evaluation as jax_full_pose_evaluation
from nope_nerf_tpu.models.poses import PoseConfig as JPoseConfig
from nope_nerf_tpu.models.poses import init_pose_params as jax_init_pose_params
from nope_nerf_tpu.ops.ssim import ssim as jax_ssim
from nope_nerf_tpu.training import ModelConfigs as JModelConfigs, Trainer as JTrainer
from nope_nerf_tpu.training import create_train_state as jax_create
from nope_nerf_tpu.training.trainer import _draw_rays
from nope_nerf_tpu.utils import metrics as jax_metrics

from nope_nerf_torch.convert import params_from_numpy, tree_from_numpy, tree_to_numpy
from nope_nerf_torch.data import SceneData, batch_for_frame
from nope_nerf_torch.evaluation import align, image_eval, pose_eval, pose_opt
from nope_nerf_torch.models.poses import PoseConfig
from nope_nerf_torch.ops.ssim import ssim
from nope_nerf_torch.training import ModelConfigs, Trainer
from nope_nerf_torch.training.state import TrainState, init_adam
from nope_nerf_torch.utils import metrics
from nope_nerf_torch.utils.profiling import StepTimer

torch.set_num_threads(2)
H, W = 24, 32


def _random_traj(n=20, seed=0):
    rng = np.random.RandomState(seed)
    c2ws = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        c2ws[i, :3, :3] = R.from_rotvec(rng.randn(3) * 0.2).as_matrix()
        c2ws[i, :3, 3] = rng.randn(3) * 3 + [0, 0, i * 0.5]
    return c2ws


def _sim3(traj, rotvec, s, t):
    Rg = R.from_rotvec(rotvec).as_matrix()
    out = traj.copy()
    out[:, :3, :3] = np.einsum("ij,njk->nik", Rg.T, traj[:, :3, :3])
    out[:, :3, 3] = (traj[:, :3, 3] - t) @ Rg / s
    return out


# ---- metrics, alignment, pose errors ------------------------------------------

def test_metrics_match_jax_and_golden():
    gt, pred = np.array([1.0, 2.0, 4.0]), np.array([1.1, 1.8, 4.0])
    got, ref = metrics.compute_errors(gt, pred), jax_metrics.compute_errors(gt, pred)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got[0], np.mean([0.1, 0.1, 0.0]), rtol=1e-6)
    for mse in (0.5, 1e-3, 1e-12):
        assert metrics.mse2psnr(mse) == jax_metrics.mse2psnr(mse)
    assert metrics.mse2psnr(1e-12) == metrics.mse2psnr(1e-10)      # clamped


def test_umeyama_and_trajectory_alignment_match_jax():
    rng = np.random.RandomState(1)
    data = rng.randn(30, 3)
    R_true = R.from_rotvec([0.2, -0.1, 0.4]).as_matrix()
    model = 2.5 * (data @ R_true.T) + np.array([1.0, -2.0, 0.5])
    s, Rot, t = align.align_umeyama(model, data)
    np.testing.assert_allclose(s, 2.5, rtol=1e-6)
    np.testing.assert_allclose(Rot, R_true, atol=1e-6)
    for kw in ({}, {"known_scale": True}, {"known_scale": True, "yaw_only": True}):
        for a, b in zip(align.align_umeyama(model, data, **kw),
                        JE.align_umeyama(model, data, **kw)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)
    p_es, p_gt = data, model
    R0, R1 = R.from_rotvec([0.1, 0, 0]).as_matrix(), R.from_rotvec([0, 0.2, 0]).as_matrix()
    for method, n_al in (("sim3", -1), ("se3", -1), ("se3", 1), ("posyaw", -1), ("posyaw", 1),
                         ("none", -1)):
        got = align.align_trajectory(p_es, p_gt, method, n_al, R0, R1)
        ref = JE.align_trajectory(p_es, p_gt, method, n_al, R0, R1)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12, err_msg=f"{method} {n_al}")
    with pytest.raises(ValueError):
        align.align_trajectory(p_es, p_gt, "affine")


def test_trajectory_alignments_match_jax():
    traj_b = _random_traj(15, seed=2)
    traj_a = _sim3(traj_b, [0.1, 0.3, -0.2], 0.7, np.array([2.0, 1.0, -1.0]))
    aligned = align.align_ate_c2b_use_a2b(traj_a, traj_b)
    assert pose_eval.compute_ATE(traj_b, aligned) < 1e-6
    np.testing.assert_allclose(aligned, JE.align_ate_c2b_use_a2b(traj_a, traj_b), rtol=1e-5,
                               atol=1e-9)
    traj_c = _random_traj(15, seed=3)
    np.testing.assert_allclose(align.align_ate_c2b_use_a2b(traj_a, traj_b, traj_c),
                               JE.align_ate_c2b_use_a2b(traj_a, traj_b, traj_c), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(align.align_ate_init_pose(traj_a, traj_b),
                               JE.align_ate_init_pose(traj_a, traj_b), rtol=1e-5, atol=1e-9)
    small = traj_b.copy()
    small[:, :3, 3] *= 0.25
    got, scale = align.align_scale_c2b_use_a2b(small, traj_b)
    ref, scale_ref = JE.align_scale_c2b_use_a2b(small, traj_b)
    np.testing.assert_allclose(scale, 4.0, rtol=1e-6)
    assert scale == scale_ref
    np.testing.assert_array_equal(got, ref)
    assert align.pts_dist_max(traj_b[:, :3, 3]) == JE.pts_dist_max(traj_b[:, :3, 3])


def test_pose_errors_match_jax_and_golden():
    gt = _random_traj(12, seed=4)
    pred = gt.copy()
    pred[:, :3, 3] += 0.1
    np.testing.assert_allclose(pose_eval.compute_ATE(gt, pred), np.sqrt(3) * 0.1, rtol=1e-6)
    noisy = _sim3(gt, [0.02, -0.01, 0.03], 1.0, np.array([0.1, 0.0, -0.2]))
    noisy[:, :3, 3] += np.random.RandomState(5).randn(12, 3) * 0.05
    np.testing.assert_allclose(pose_eval.compute_ATE(gt, noisy), JE.compute_ATE(gt, noisy),
                               rtol=1e-5)
    np.testing.assert_allclose(pose_eval.compute_ATE_v2(gt, noisy), JE.compute_ATE_v2(gt, noisy),
                               rtol=1e-5)
    np.testing.assert_allclose(pose_eval.compute_rpe(gt, noisy), JE.compute_rpe(gt, noisy),
                               rtol=1e-5)
    got, ref = pose_eval.full_pose_evaluation(noisy, gt), jax_full_pose_evaluation(noisy, gt)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    same = pose_eval.full_pose_evaluation(gt.copy(), gt.copy())
    assert same["ate_trans"] < 1e-6 and same["rpe_rot_deg"] < 1e-4


def test_revert_to_metric_matches_jax():
    rng = np.random.RandomState(6)
    poses = _random_traj(6, seed=7)
    recenter = np.eye(4)
    recenter[:3, :3] = R.from_rotvec([0.3, 0.1, -0.2]).as_matrix()
    recenter[:3, 3] = rng.randn(3)
    spher = np.eye(4)
    spher[:3, 3] = rng.randn(3)
    for reverse in ({"recenter": recenter, "sc": 0.4},
                    {"recenter": recenter, "sc": 0.4, "sc_spherify": 1.7,
                     "c2w_spherify": spher[None]}):
        np.testing.assert_allclose(pose_eval.revert_to_metric(poses, reverse),
                                   JE.revert_to_metric(poses, reverse), rtol=1e-5, atol=1e-12)
        got = pose_eval.full_pose_evaluation(poses, _random_traj(6, seed=8), reverse, reverse)
        ref = jax_full_pose_evaluation(poses, _random_traj(6, seed=8), reverse, reverse)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


# ---- image evaluation ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(24, 32, 3), (9, 40, 3), (30, 11, 1)])
def test_ssim_eval_variant_matches_jax(shape):
    rng = np.random.RandomState(shape[0])
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    got = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, float(jax_ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    assert abs(float(ssim(torch.from_numpy(a), torch.from_numpy(a))) - 1.0) < 1e-5


def test_depth_confusion_matches_jax_and_golden():
    pred = np.array([[0.05, 5.0], [25.0, 10.0]])
    gt = np.array([[5.0, 5.0], [0.05, 25.0]])
    mask, mask_r, conf = image_eval.depth_confusion(pred, gt, 0.1, 20.0)
    assert mask.tolist() == [[False, True], [False, False]]
    np.testing.assert_allclose(conf * 3, [[1, 1], [1, 1]])
    for a, b in zip((mask, mask_r, conf), JE.depth_confusion(pred, gt, 0.1, 20.0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pred_hw", [(24, 32), (12, 16), (7, 50)])
def test_eval_image_matches_jax(pred_hw):
    """Same resolution, and a rendered depth at another resolution than the
    ground truth's (resized by the nearest-exact rule)."""
    rng = np.random.RandomState(7)
    gt = rng.rand(24, 32, 3).astype(np.float32)
    pred = np.clip(gt + 0.05 * rng.randn(24, 32, 3), 0, 1).astype(np.float32)
    d_gt = (5 + rng.rand(24, 32) * 20).astype(np.float32)
    d_pred = (5 + rng.rand(*pred_hw) * 20).astype(np.float32)
    if pred_hw == (24, 32):
        d_pred = d_gt * 1.1
    got = image_eval.eval_image(pred, gt, d_pred, d_gt, sc=0.9, min_depth=0.1, max_depth=20)
    ref = JE.eval_image(pred, gt, d_pred, d_gt, sc=0.9, min_depth=0.1, max_depth=20,
                        with_lpips=False)
    assert set(got) == set(ref) and got["lpips"] is None and ref["lpips"] is None
    assert 20 < got["psnr"] < 40 and 0.5 < got["ssim"] <= 1.0
    for k in ("mse", "psnr", "ssim", "conf_mat", "depth_out_full", "depth_pred_masked",
              "depth_gt_masked", "depth_errors"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    no_depth = image_eval.eval_image(pred, gt)
    assert set(no_depth) == {"mse", "psnr", "ssim", "lpips"}


@pytest.mark.parametrize("src,dst", [((24, 32), (12, 16)), ((12, 16), (24, 32)),
                                     ((7, 50), (24, 32)), ((188, 621), (375, 1242)),
                                     ((10, 10), (3, 7))])
def test_resize_nearest_exact_matches_cv2(src, dst):
    import cv2
    rng = np.random.RandomState(src[0])
    img = rng.rand(*src).astype(np.float32)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST_EXACT)
    np.testing.assert_array_equal(image_eval.resize_nearest_exact(img, dst), ref)


def test_aggregate_depth_errors_is_per_view_mean():
    a = {"depth_errors": metrics.compute_errors(np.array([2.0, 2.0]), np.array([1.0, 1.0]))}
    b = {"depth_errors": metrics.compute_errors(np.full(100, 4.0), np.full(100, 4.0))}
    got = image_eval.aggregate_depth_errors([a, b, {}])
    np.testing.assert_allclose(got["abs_rel"], 0.25)      # (0.5 + 0.0) / 2
    ref = jax_image_eval.aggregate_depth_errors([a, b, {}])
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)
    assert all(np.isnan(v) for v in image_eval.aggregate_depth_errors([{}]).values())


def test_view_artifacts_and_video(tmp_path):
    from nope_nerf_torch.evaluation.artifacts import write_eval_video, write_view_artifacts
    rng = np.random.RandomState(3)
    img = rng.rand(12, 16, 3).astype(np.float32)
    depth = (0.5 + 4 * rng.rand(12, 16)).astype(np.float32)
    depth[0, 0] = 0.01
    frame = write_view_artifacts(str(tmp_path), 0, img, img, depth_out=depth, depth_gt=depth * 1.05,
                                 min_depth=0.1, max_depth=20.0, show_errors=True)
    assert frame.dtype == np.uint8 and frame.shape == (12, 16, 3)
    for sub in ("img_out", "img_gt_out", "depth_out", "depth_gt_out", "disp_out", "disp_gt_out"):
        assert (tmp_path / sub / "0000.png").exists(), sub
    for suffix in ("_mask_rendered", "_mask_gt", "_mask_combined", "_gt", ""):
        assert (tmp_path / "depth_mask" / f"0000{suffix}.png").exists(), suffix
    assert (tmp_path / "0000_conf.png").exists()
    assert write_eval_video(str(tmp_path), [frame, frame]).startswith(str(tmp_path / "video_out"))


def test_step_timer_counts_chunks():
    timer = StepTimer(rays_per_step=10)
    assert timer.steps_per_s == 0.0 and timer.rays_per_s == 0.0
    timer.tick()
    timer.tick_many(4)
    timer.tick()
    assert len(timer.times) == 5 and timer.times[0] == timer.times[3]
    assert timer.rays_per_s == pytest.approx(10 * timer.steps_per_s)
    assert "steps/s" in timer.summary()


# ---- test-time pose optimisation ----------------------------------------------

@pytest.mark.parametrize("method", ["scale", "ate", "pre", "none"])
def test_init_test_poses_matches_jax(method):
    learned = _random_traj(14, seed=9)
    colmap = _sim3(learned, [0.2, 0.1, -0.1], 1.6, np.array([0.5, -1.0, 2.0]))
    eval_init = _sim3(_random_traj(2, seed=10), [0.2, 0.1, -0.1], 1.6, np.array([0.5, -1.0, 2.0]))
    got = pose_opt.init_test_poses(method, eval_init, learned, colmap, 8, 2)
    ref = jax_pose_opt.init_test_poses(method, eval_init, learned, colmap, 8, 2)
    if method == "none":
        assert got is None and ref is None
    else:
        assert got.shape == (2, 4, 4)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)
    with pytest.raises(ValueError):
        pose_opt.init_test_poses("nearest", eval_init, learned, colmap, 8, 2)


def _f32_setup(n_frames=3, **over):
    overrides = {"model": {"hidden_dim": 64}, "rendering": {"num_points": 16},
                 "pose": {"learn_pose": True, "init_pose": True},
                 "tpu": {"use_pallas_renderer": False, "compute_dtype": "float32"}}
    for k, v in over.items():
        overrides.setdefault(k, {}).update(v)
    cfg = load_config(overrides=overrides)
    scene = dict(make_synthetic_scene(n_frames=n_frames, h=H, w=W))
    jmc = JModelConfigs.from_cfg(cfg, n_frames)
    jstate, jopt = jax_create(jax.random.key(0), jmc, init_c2w=jnp.asarray(scene["c2ws_gt"]))
    mc = ModelConfigs.from_cfg(cfg, n_frames)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
    state = TrainState(params=params, opt_state={g: init_adam(params[g]) for g in params}, it=-1,
                       generator=torch.Generator().manual_seed(0))
    return cfg, scene, jmc, jstate, jopt, mc, state


@pytest.mark.parametrize("learn_focal", [False, True])
def test_three_pose_opt_steps_match_jax(learn_focal):
    """Three steps of _pose_opt_step_impl over frames (0, 1, 0), the ray draws
    of the JAX side handed to the port; the focal is learned-and-frozen in the
    second case."""
    cfg, scene, jmc, jstate, _, mc, state = _f32_setup(
        n_frames=2, pose={"learn_focal": learn_focal})
    n_points, lr = 16, 1e-3      # eval_pose.opt_eval_lr's default
    init = scene["c2ws_gt"] @ np.array(
        [[1, 0, 0, 0.05], [0, 1, 0, -0.03], [0, 0, 1, 0.02], [0, 0, 0, 1]], np.float32)
    jpcfg = JPoseConfig(num_cams=2, use_init_c2w=True)
    jpose = jax_init_pose_params(jpcfg, jnp.asarray(init))
    opt = optax.scale_by_adam()
    jopt_state = opt.init(jpose)
    key = jax.random.key(3)
    jfocal = jstate.params.get("focal")

    pcfg = PoseConfig(num_cams=2, use_init_c2w=True)
    pose = tree_from_numpy(jax.tree.map(np.asarray, jpose), "cpu")
    adam = init_adam(pose)
    imgs = torch.from_numpy(scene["imgs"])
    cam = torch.from_numpy(scene["K"])
    for step, idx in enumerate((0, 1, 0)):
        _, kray = jax.random.split(key)
        ray_idx = np.asarray(_draw_rays(kray, H * W, n_points))
        jpose, jopt_state, jloss, key = jax_pose_opt._pose_opt_step_impl(
            jpose, jopt_state, jstate.params["nerf"], jfocal, jnp.asarray(scene["imgs"][idx]), idx,
            jnp.asarray(scene["K"]), key, lr, jpcfg, jmc.focal, jmc.nerf, jmc.render, n_points, opt)
        loss = pose_opt.pose_opt_step(pose, adam, state.params["nerf"], state.params.get("focal"),
                                      imgs[idx], idx, cam, torch.from_numpy(ray_idx.copy()).long(), lr,
                                      pcfg, mc.focal, mc.nerf, mc.render)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, err_msg=f"step {step}")
        for k, r in tree_to_numpy(pose).items():
            np.testing.assert_allclose(r, np.asarray(jpose[k]), rtol=0, atol=1e-5,
                                       err_msg=f"step {step} {k}")
    assert adam.count == 3
    assert float(np.abs(np.asarray(jpose["t"])).max()) > 5e-4     # the poses did move


def test_optimize_test_poses_schedule_and_pinned_draws():
    """The epoch loop: five-milestone halving, pinned draws reproduce a run,
    the generator's draws are distinct indices, identity start without init."""
    assert pose_opt.pose_opt_lrs(1.0, 10) == [0.5, 0.5, 0.25, 0.25, 0.125, 0.125, 0.0625, 0.0625,
                                               0.03125, 0.03125]
    assert pose_opt.pose_opt_lrs(1.0, 3) == [0.5, 0.25, 0.125]
    cfg, scene, jmc, jstate, _, mc, state = _f32_setup(n_frames=2)
    eval_scene = SceneData.from_dict(scene)
    rng = np.random.default_rng(0)
    ray_idx = torch.from_numpy(np.stack([[rng.permutation(H * W)[:16] for _ in range(2)]
                                         for _ in range(3)]))
    runs = [pose_opt.optimize_test_poses(state.params["nerf"], None, eval_scene, mc.nerf, mc.render,
                                         init_c2ws=scene["c2ws_gt"], n_points=16, n_epochs=3,
                                         lr=1e-2, log_every=0, device="cpu", ray_idx=ray_idx)
            for _ in range(2)]
    assert runs[0][1].shape == (2, 4, 4) and np.isfinite(runs[0][1]).all()
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert not np.array_equal(runs[0][1], scene["c2ws_gt"])
    assert torch.equal(runs[0][0]["init_c2w"], torch.from_numpy(scene["c2ws_gt"]))
    params, c2ws = pose_opt.optimize_test_poses(state.params["nerf"], None, eval_scene, mc.nerf,
                                                mc.render, n_points=16, n_epochs=1, lr=1e-3,
                                                device="cpu")
    assert set(params) == {"r", "t"} and np.abs(c2ws - np.eye(4)).max() < 0.01
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pose_opt.optimize_test_poses(state.params["nerf"], None, eval_scene, mc.nerf, mc.render)


# ---- Trainer.render_frame -------------------------------------------------------

@pytest.mark.parametrize("learn_focal", [False, True])
def test_render_frame_matches_jax(learn_focal):
    """Learned pose, learned distortion and (second case) learned focal; a
    given pose; a row slab; a pending frame; chunks that do not divide the
    frame."""
    cfg, scene, jmc, jstate, jopt, mc, state = _f32_setup(pose={"learn_focal": learn_focal})
    jtrainer = JTrainer(cfg, jmc, jopt)
    jscene = JSceneData.from_dict(scene)
    pscene = SceneData.from_dict(scene).to_device("cpu")
    trainer = Trainer(cfg, mc)
    res = (12, 20)
    for idx, learned in ((1, True), (2, False)):
        ref = jtrainer.render_frame(jstate, jax_batch(jscene, idx, ref_idx=0), res,
                                    use_learned_pose=learned)
        got = trainer.render_frame(state, batch_for_frame(pscene, idx, ref_idx=0), res,
                                   use_learned_pose=learned, chunk=97)
        assert got["rgb"].shape == (12, 20, 3) and got["depth"].shape == (12, 20)
        np.testing.assert_allclose(got["rgb"], ref["rgb"], atol=1e-5)
        np.testing.assert_allclose(got["depth"], ref["depth"], atol=1e-5, rtol=1e-5)
    batch = batch_for_frame(pscene, 1, ref_idx=0)
    full = trainer.render_frame(state, batch, res)
    slab = trainer.render_frame(state, batch, res, rows=(3, 7))
    ref_slab = jtrainer.render_frame(jstate, jax_batch(jscene, 1, ref_idx=0), res, rows=(3, 7))
    assert slab["rgb"].shape == (4, 20, 3)
    np.testing.assert_array_equal(slab["rgb"], full["rgb"][3:7])
    np.testing.assert_array_equal(slab["depth"], full["depth"][3:7])
    np.testing.assert_allclose(slab["rgb"], ref_slab["rgb"], atol=1e-5)
    pending = trainer.render_frame(state, batch, res, sync=False)
    assert all(torch.is_tensor(t) for t in pending["rgb_chunks"])
    done = Trainer.finalize_frame(pending)
    np.testing.assert_array_equal(done["rgb"], full["rgb"])
    # numpy batches (the eval CLI builds them on the host) render the same frame
    np_batch = {"img": scene["imgs"][1], "depth": scene["depths"][1], "camera_mat": scene["K"],
                "pose_gt": scene["c2ws_gt"][1], "idx": np.int32(1)}
    np.testing.assert_array_equal(trainer.render_frame(state, np_batch, res)["rgb"], full["rgb"])


def test_reprojection_pair_matches_jax():
    cfg, scene, jmc, jstate, jopt, mc, state = _f32_setup()
    jtrainer = JTrainer(cfg, jmc, jopt)
    trainer = Trainer(cfg, mc)
    jscene = JSceneData.from_dict(scene)
    pscene = SceneData.from_dict(scene).to_device("cpu")
    for idx, ref_idx in ((0, 1), (2, 1)):           # frame 2 is the last: it looks backward
        ref = jtrainer.reprojection_pair(jstate, jax_batch(jscene, idx, ref_idx=ref_idx))
        got = trainer.reprojection_pair(state, batch_for_frame(pscene, idx, ref_idx=ref_idx))
        assert got[0].shape == (H // 4, W // 4, 3) and got[2].shape == (H // 4, W // 4)
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
        np.testing.assert_array_equal(got[2], ref[2])
