"""Port parity for the loss family, image sampling/resizing, SSIM and the small
scene-parameter modules: the same numpy inputs through nope_nerf_tpu and
nope_nerf_torch on the CPU, float32, rtol 1e-5 (atol 1e-6 where values cross
zero): both sides do the same f32 arithmetic, in places in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu import losses as jl
from nope_nerf_tpu.geometry import camera as jcam
from nope_nerf_tpu.models import distortions as jdist
from nope_nerf_tpu.models import intrinsics as jfoc
from nope_nerf_tpu.ops import interp as jinterp
from nope_nerf_tpu.ops import ssim as jssim
from nope_nerf_tpu.training import scheduler as jsched

from nope_nerf_torch import losses as tl
from nope_nerf_torch.config import load_config
from nope_nerf_torch.geometry import camera as tcam
from nope_nerf_torch.models import distortions as tdist
from nope_nerf_torch.models import intrinsics as tfoc
from nope_nerf_torch.ops import interp as tinterp
from nope_nerf_torch.ops import ssim as tssim
from nope_nerf_torch.training import scheduler as tsched

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(ref), rtol=rtol, atol=atol)


def _t(*arrays):
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return out[0] if len(out) == 1 else out


def _j(*arrays):
    out = tuple(jnp.asarray(a) for a in arrays)
    return out[0] if len(out) == 1 else out


# ---- interp ------------------------------------------------------------------

@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample(mode, align):
    rng = _rng(1)
    img = rng.uniform(size=(7, 9, 3)).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, size=(200, 2)).astype(np.float32)   # some out of bounds
    ref = jinterp.grid_sample(_j(img), _j(pts), mode=mode, align_corners=align)
    _close(tinterp.grid_sample(_t(img), _t(pts), mode=mode, align_corners=align), ref)
    pix = rng.uniform(0, 9, size=(50, 2)).astype(np.float32)
    ref = jinterp.get_tensor_values(_j(img), _j(pix), mode=mode, scale=True, align_corners=align)
    _close(tinterp.get_tensor_values(_t(img), _t(pix), mode=mode, scale=True,
                                     align_corners=align), ref)


def test_grid_sample_gradient():
    rng = _rng(2)
    img = rng.uniform(size=(6, 8, 3)).astype(np.float32)
    pts = rng.uniform(-0.9, 0.9, size=(40, 2)).astype(np.float32)
    g_img, g_pts = jax.grad(lambda i, p: jnp.sum(jinterp.grid_sample(
        i, p, align_corners=True) ** 2), argnums=(0, 1))(_j(img), _j(pts))
    ti, tp = _t(img).requires_grad_(True), _t(pts).requires_grad_(True)
    (tinterp.grid_sample(ti, tp, align_corners=True) ** 2).sum().backward()
    _close(ti.grad, g_img)
    _close(tp.grad, g_pts, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["nearest", "bilinear", "area"])
@pytest.mark.parametrize("size", [(5, 7), (47, 155), (20, 31)])
def test_resize(kind, size):
    img = _rng(3).uniform(size=(20, 31, 3)).astype(np.float32)
    ref = getattr(jinterp, f"resize_{kind}")(_j(img), size)
    _close(getattr(tinterp, f"resize_{kind}")(_t(img), size), ref)


def test_ssim_loss_map():
    rng = _rng(4)
    a, b = (rng.uniform(size=(12, 15, 3)).astype(np.float32) for _ in range(2))
    # sigma = E[x^2] - mu^2 cancels: absolute agreement at the maps' [0, 1] scale
    _close(tssim.ssim_loss_map(*_t(a, b)), jssim.ssim_loss_map(*_j(a, b)), rtol=1e-4, atol=1e-5)


# ---- loss terms -------------------------------------------------------------------

def _rays(n=64, seed=5):
    rng = _rng(seed)
    return (rng.uniform(size=(n, 3)).astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32),
            rng.uniform(1, 5, size=n).astype(np.float32), rng.uniform(1, 5, size=n).astype(np.float32),
            rng.uniform(size=n) > 0.3)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_rgb_loss(loss_type):
    pred, gt, *_ = _rays()
    _close(tl.rgb_loss(*_t(pred, gt), loss_type), jl.rgb_loss(*_j(pred, gt), loss_type))


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("kind", ["l1", "invariant"])
def test_depth_losses(kind, empty):
    _, _, dp, dg, mask = _rays()
    if empty:
        mask = np.zeros_like(mask)
    name = "depth_loss_l1" if kind == "l1" else "depth_loss_invariant"
    _close(getattr(tl, name)(*_t(dp, dg, mask)), getattr(jl, name)(*_j(dp, dg, mask)))


def test_masked_mean_and_median():
    _, _, dp, _, mask = _rays()
    _close(tl.masked_mean(*_t(dp, mask)), jl.masked_mean(*_j(dp, mask)))
    _close(tl.masked_median(*_t(dp, mask)), jl.masked_median(*_j(dp, mask)), rtol=0, atol=0)
    nan = dp.copy()
    nan[~mask] = np.nan          # a NaN under an invalid entry must not reach the mean
    assert np.isfinite(float(tl.masked_mean(*_t(nan, mask))))


def test_weight_dist_and_t_cycle():
    rng = _rng(6)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    t[2] = t[1]                   # identical consecutive translations: norm at 0
    ref = jl.weight_dist_loss(_j(t))
    got = tl.weight_dist_loss(_t(t))
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    g_ref = jax.grad(lambda x: sum(jl.weight_dist_loss(x)))(_j(t))
    tt = _t(t).requires_grad_(True)
    sum(tl.weight_dist_loss(tt)).backward()
    _close(tt.grad, g_ref)
    a, b = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    a[:3, 3], b[:3, 3] = [0.1, 0.2, -0.3], [0.0, 0.25, -0.2]
    _close(tl.t_cycle_loss(*_t(a, b)), jl.t_cycle_loss(*_j(a, b)))
    _close(tl.t_cycle_loss(*_t(a, a)), 0.0)


@pytest.mark.parametrize("with_ssim", [False, True])
def test_rgb_s_loss(with_ssim):
    rng = _rng(7)
    a, b = (rng.uniform(size=(10, 12, 3)).astype(np.float32) for _ in range(2))
    valid = (rng.uniform(size=(10, 12, 1)) > 0.4).astype(np.float32)
    _close(tl.rgb_s_loss(*_t(a, b, valid), with_ssim), jl.rgb_s_loss(*_j(a, b, valid), with_ssim),
           rtol=1e-4)


@pytest.mark.parametrize("auto_mask", [False, True])
def test_reprojection_losses(auto_mask):
    rng = _rng(8)
    rgb = rng.uniform(size=(50, 3)).astype(np.float32)
    refs = [rng.uniform(size=(50, 3)).astype(np.float32) for _ in range(2)]
    oris = [rng.uniform(size=(50, 3)).astype(np.float32) for _ in range(2)]
    valid = (rng.uniform(size=(50, 1)) > 0.3).astype(np.float32)
    _close(tl.reprojection_loss(_t(rgb), [_t(r) for r in refs], _t(valid), [_t(o) for o in oris],
                                auto_mask),
           jl.reprojection_loss(_j(rgb), [_j(r) for r in refs], _j(valid), [_j(o) for o in oris],
                                auto_mask))
    _close(tl.dpt_reprojection_loss(_t(rgb), [_t(r) for r in refs], _t(valid),
                                    [_t(o) for o in oris], auto_mask),
           jl.dpt_reprojection_loss(_j(rgb), [_j(r) for r in refs], _j(valid),
                                    [_j(o) for o in oris], auto_mask))


def test_depth_consistency_loss():
    rng = _rng(9)
    a, b, c, d = (rng.uniform(1, 4, size=30).astype(np.float32) for _ in range(4))
    _close(tl.depth_consistency_loss(*_t(a, b)), jl.depth_consistency_loss(*_j(a, b)))
    _close(tl.depth_consistency_loss(*_t(a, b, c, d)), jl.depth_consistency_loss(*_j(a, b, c, d)))


WEIGHTS = {"rgb_weight": 0.9, "depth_weight": 0.04, "weight_dist_1st_loss": 0.3,
           "weight_dist_2nd_loss": 0.2, "pc_weight": 0.7, "rgb_s_weight": 0.6,
           "depth_consistency_weight": 0.1, "t_cycle_weight": 0.05}


@pytest.mark.parametrize("mode", ["all_terms", "invariant_ssim", "precomputed", "ray_total"])
def test_compute_losses(mode):
    rng = _rng(10)
    pred, gt, dp, dg, mask = _rays()
    # clouds a lattice apart, jittered: every nearest neighbour is clear-cut
    lattice = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pc_x = (lattice + rng.uniform(-0.1, 0.1, size=lattice.shape)).astype(np.float32)
    pc_y = (lattice[::-1] + rng.uniform(-0.1, 0.1, size=lattice.shape)).astype(np.float32)
    a, b = (rng.uniform(size=(6, 8, 3)).astype(np.float32) for _ in range(2))
    valid = (rng.uniform(size=(6, 8, 1)) > 0.3).astype(np.float32)
    rt, rt_gt = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    rt[:3, 3] = [0.1, 0.0, 0.2]
    kw = dict(t_list=rng.normal(size=(5, 3)).astype(np.float32), pc_x=pc_x, pc_y=pc_y, rgb_pc1=a,
              rgb_pc1_proj=b, valid_points=valid, d1_proj=dp, d2=dg, rt_12=rt, rt_12_gt=rt_gt)
    cfg_kw = dict(use_dist=True, use_depth_consistency=True, use_t_cycle=True)
    if mode == "invariant_ssim":
        cfg_kw.update(depth_loss_type="invariant", with_ssim=True)
    if mode in ("precomputed", "ray_total"):
        pre = {"loss_rgb": np.float32(0.3), "loss_depth": np.float32(1.2),
               "l2_mean": np.float32(0.05)}
        if mode == "ray_total":
            pre["ray_total"] = np.float32(0.77)
        ray_kw = {}
    else:
        pre = None
        ray_kw = dict(rgb_pred=pred, rgb_gt=gt, depth_pred=dp, depth_gt=dg, depth_mask=mask)
    ref = jl.compute_losses(jl.LossConfig(**cfg_kw), {k: jnp.asarray(v) for k, v in WEIGHTS.items()},
                            rgb_loss_type="l1", precomputed=None if pre is None else _jdict(pre),
                            **{k: _j(v) for k, v in {**kw, **ray_kw}.items()})
    got = tl.compute_losses(tl.LossConfig(**cfg_kw), WEIGHTS, rgb_loss_type="l1",
                            precomputed=None if pre is None else {k: torch.tensor(v)
                                                                  for k, v in pre.items()},
                            **{k: _t(v) for k, v in {**kw, **ray_kw}.items()})
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], rtol=1e-4 if mode == "invariant_ssim" else RTOL)


def _jdict(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_loss_config_from_cfg_matches():
    cfg = load_config(overrides={"training": {"t_cycle_weight": [0.0, 0.1], "with_ssim": True}})
    ref, got = jl.LossConfig.from_cfg(cfg), tl.LossConfig.from_cfg(cfg)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(ref, f) for f in ref.__dataclass_fields__}


# ---- geometry added with the train step -----------------------------------

def test_camera_train_functions():
    rng = _rng(11)
    cam = np.array(jcam.camera_matrix_from_focal(jnp.asarray(1.2), jnp.asarray(1.4)))
    world = np.eye(4, dtype=np.float32)
    ang = 0.2
    world[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    world[:3, 3] = [0.3, -0.2, 0.5]
    ref_rt = np.eye(4, dtype=np.float32)
    ref_rt[:3, 3] = [0.05, 0.0, -0.1]
    pts = rng.normal(size=(40, 3)).astype(np.float32) - np.array([0, 0, 4], np.float32)
    pix = rng.uniform(-1, 1, size=(40, 2)).astype(np.float32)
    depth = rng.uniform(1, 4, size=(40,)).astype(np.float32)
    _close(tcam.origin_to_world(*_t(cam, world)), jcam.origin_to_world(*_j(cam, world)))
    _close(tcam.transform_to_camera_space(*_t(pts, cam, world)),
           jcam.transform_to_camera_space(*_j(pts, cam, world)))
    for got, ref in zip(tcam.project_to_cam(*_t(pts, cam)), jcam.project_to_cam(*_j(pts, cam))):
        _close(got, ref)
    for got, ref in zip(tcam.reprojection(*_t(pix, depth, ref_rt, world, cam)),
                        jcam.reprojection(*_j(pix, depth, ref_rt, world, cam))):
        _close(got, ref)


# ---- scene parameters and schedules ---------------------------------------------

def test_distortion_params():
    jc = jdist.DistortionConfig(num_cams=4)
    tc = tdist.DistortionConfig(num_cams=4)
    scale = np.array([[1.3], [0.005], [0.8], [2.0]], np.float32)   # one below the 0.01 clamp
    shift = np.array([[0.1], [-0.2], [0.0], [0.3]], np.float32)
    init = tdist.init_distortion_params(tc, device="cpu")
    ref_init = jdist.init_distortion_params(jc)
    for k in ref_init:
        _close(init[k], ref_init[k], rtol=0, atol=0)
    for cam_id in range(4):
        ref = jdist.distortion_scale_shift({"scale": _j(scale), "shift": _j(shift)}, cam_id, jc)
        ts = _t(scale).requires_grad_(True)
        got = tdist.distortion_scale_shift({"scale": ts, "shift": _t(shift)}, cam_id, tc)
        _close(got[0], ref[0], rtol=0, atol=0)
        _close(got[1], ref[1], rtol=0, atol=0)
        g_ref = jax.grad(lambda s: jdist.distortion_scale_shift(
            {"scale": s, "shift": _j(shift)}, cam_id, jc)[0][0])(_j(scale))
        if got[0].requires_grad:
            got[0][0].backward()
            _close(ts.grad, g_ref, rtol=0, atol=0)
        else:                          # the pinned last scale is a constant
            assert not np.asarray(g_ref).any()


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("fx_only", [False, True])
def test_focal_params(order, fx_only):
    jc = jfoc.FocalConfig(fx_only=fx_only, order=order)
    tc = tfoc.FocalConfig(fx_only=fx_only, order=order)
    for init in (None, 1.3, [1.1, 0.9]):
        ref = jfoc.init_focal_params(jc, init_focal=init)
        got = tfoc.init_focal_params(tc, init_focal=init, device="cpu")
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k], ref[k])
        _close(tfoc.focal_fxfy(got, tc), jfoc.focal_fxfy(ref, jc))


def test_scheduler_copy_matches():
    t = load_config()["training"]
    for epoch in (0, 5, 10000, 10500, 12001):
        assert tsched.annealed_weights(t, 10000, epoch) == jsched.annealed_weights(t, 10000, epoch)
        assert tsched.rgb_loss_type_at(t, 10000, epoch) == jsched.rgb_loss_type_at(t, 10000, epoch)
        assert tsched.lr_at_epoch(1e-3, 0.99, 10000, epoch, 10) == \
            jsched.lr_at_epoch(1e-3, 0.99, 10000, epoch, 10)
    a, b = tsched.AutoScheduler(length_smooth=3, patient=2), jsched.AutoScheduler(length_smooth=3,
                                                                                   patient=2)
    for ep, psnr in enumerate([20, 21, 22, 21, 20, 19, 18]):
        assert a.update(psnr, ep, 10000) == b.update(psnr, ep, 10000)
