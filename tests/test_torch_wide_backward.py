"""hidden_dim 384 and 512 on the frozen-network backward, on the CPU, where K4's
and K6's frozen-network variants (csrc/mlp_dx_wide_sm90.cuh's 64-point chain
on the card) run as their plain versions:

(i)   the render's backward through render_rays_fused's autograd with a frozen
      network (the route cli.eval's pose optimisation takes) against the JAX
      package's VJP of render_rays_fused, its Pallas kernels in interpret mode,
      8 rays x 128 samples, both flag sets the card's checks use;
(ii)  point_mlp_bwd_plain(want_param_grads=False) against the VJP of
      nerf_apply_fused in interpret mode on 200 points (a ragged last pass at
      64 and at 128 points);
(iii) pack_tiles_dx's buffer at every width, undone by an independent
      un-swizzle: every (in, out) weight exactly, 32-column slices in the
      64-byte swizzle at 384 and 512, and at 128 and 256 the 64-column,
      128-byte-swizzle layout the narrow chain has always read;
(iv)  three test-time pose-optimisation steps at hidden_dim 384 on the fused
      route against JAX's _pose_opt_step_impl, the ray draws pinned;
(v)   the hierarchical pose-optimisation step at 384: its point_mlp backward
      runs frozen, and the pose and its Adam state after two steps are those
      of the same steps through the full backward, bit for bit.

The 512 cases of (i) and (ii) are marked slow (`-m slow`), on top of the
fast cases at 384. Tolerances, PERF.md section 2's bf16 class: gradients within 2e-2 of each
block's largest entry. Both sides round the same cotangents to bf16 before
every product and take the ReLU masks from bf16 activations, but sum the f32
products in another order. The pose steps: the loss rtol 2e-3 (the forward's
2e-3 class); the pose parameters within 1e-4 of a step's rate of 1e-3 after 3
Adam steps, since Adam's first steps move each entry by the rate times
nearly the sign of its gradient, and the bf16-class gradients differ by
far less than their size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from nope_nerf_tpu.config import load_config as jax_load_config
from nope_nerf_tpu.data import make_synthetic_scene
from nope_nerf_tpu.evaluation import pose_opt as jax_pose_opt
from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.models.poses import PoseConfig as JPoseConfig
from nope_nerf_tpu.models.poses import init_pose_params as jax_init_pose_params
from nope_nerf_tpu.ops import pallas_render as jpr
from nope_nerf_tpu.training import ModelConfigs as JModelConfigs
from nope_nerf_tpu.training import create_train_state as jax_create
from nope_nerf_tpu.training.trainer import _draw_rays

from nope_nerf_torch.config import load_config
from nope_nerf_torch.convert import params_from_numpy, tree_from_numpy, tree_to_numpy
from nope_nerf_torch.evaluation import pose_opt
from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.models.nerf import init_nerf_params as init_torch_params
from nope_nerf_torch.models.poses import PoseConfig
from nope_nerf_torch.ops import fused_mlp as FM
from nope_nerf_torch.ops import fused_render as F
from nope_nerf_torch.training import ModelConfigs
from nope_nerf_torch.training.state import init_adam

torch.set_num_threads(2)
FLAGS = [("softplus", False), ("relu", True)]   # (occupancy, head and renderer dist_alpha)
# The interpreted Pallas kernels take 10 to 20 s a case at 512: those cases run
# with -m slow, on top of the fast ones at 384 (the plain versions' code is
# one for every width; the card holds the kernels at both against them).
WIDTHS = [384, pytest.param(512, marks=pytest.mark.slow)]


def _assert_block(name, got, ref):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0 and got.shape == ref.shape, name
    err = float(np.abs(got - ref).max())
    assert err <= 2e-2 * scale + 1e-6, f"{name}: err {err} vs largest {scale}"


def _render_case(D, occ, dist_alpha, n=8, S=128):
    rng = np.random.default_rng(D + 7)
    jc = JNerfConfig(hidden_dim=D, use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha)
    jp = init_nerf_params(jax.random.key(D + 7), jc)
    if not dist_alpha:       # transmittance alive along the ray (tests/test_torch_render_bwd.py)
        jp = dict(jp, density_b=jp["density_b"] - 3.0)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(n, S)).astype(np.float32), axis=1)
    rgb_gt = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    depth_gt = rng.uniform(1.0, 5.0, size=(n,)).astype(np.float32)
    return jc, jp, o, v, z, rgb_gt, depth_gt


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
@pytest.mark.parametrize("D", WIDTHS)
def test_frozen_render_backward_matches_pallas_vjp(D, occ, dist_alpha):
    """(i) d(rays) and dz of render_rays_fused under autograd with no nerf
    parameter requiring a gradient, against jax.vjp of render_rays_fused with
    respect to the rays and z, for the cotangents of an L2 colour and depth
    loss plus a term on every 7th weight and on one column of alpha."""
    jc, jp, o, v, z, rgb_gt, depth_gt = _render_case(D, occ, dist_alpha)
    n = z.shape[0]
    rays_j = jpr.pack_rays(jnp.asarray(o), jnp.asarray(v), jnp.asarray(-v))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda r, zz: jpr.render_rays_fused(jp, r, zz, jc, dist_alpha),
                           rays_j, jnp.asarray(z))
        rgb, dist, weights, _ = (np.asarray(a) for a in out)
        g_w = np.zeros_like(weights)
        g_w[:, ::7] = 2.0 / n * weights[:, ::7]
        g_a = np.zeros_like(weights)
        g_a[:, 5] = 1.0 / n
        cot = [(1.4 / n * (rgb - rgb_gt)).astype(np.float32),
               (0.6 / n * (dist - depth_gt)).astype(np.float32), g_w, g_a]
        ref_rays, ref_z = vjp(tuple(jnp.asarray(c) for c in cot))

    tc = NerfConfig(hidden_dim=D, use_pallas=True, occ_activation=occ, dist_alpha=dist_alpha)
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    rays = F.pack_rays(*(torch.from_numpy(a) for a in (o, v, -v))).requires_grad_(True)
    zt = torch.from_numpy(z).requires_grad_(True)
    got = F.render_rays_fused(tp, rays, zt, tc, dist_alpha, want_aux=True)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cot])
    assert all(t.grad is None for t in tp.values())
    _assert_block("rays", rays.grad.numpy(), np.asarray(ref_rays)[:, :9])
    _assert_block("z", zt.grad.numpy(), ref_z)


@pytest.mark.parametrize("occ,dist_alpha", FLAGS)
@pytest.mark.parametrize("D", WIDTHS)
def test_frozen_point_backward_matches_pallas_vjp(D, occ, dist_alpha):
    """(ii) K6's frozen-network plain version against the VJP of
    nerf_apply_fused with respect to the points and directions, and equal to
    the full plain call's d(points), d(directions)."""
    from nope_nerf_tpu.ops.pallas_mlp import nerf_apply_fused

    m = 200
    jc = JNerfConfig(hidden_dim=D, compute_dtype="bfloat16", occ_activation=occ,
                     dist_alpha=dist_alpha, use_pallas=True)
    tc = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=dist_alpha, use_pallas=True)
    jp = init_nerf_params(jax.random.key(D + 9), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(D + 9)
    pts = (rng.normal(size=(m, 3)) * 2.0).astype(np.float32)
    dirs = rng.normal(size=(m, 3)).astype(np.float32)
    g_rgb = rng.normal(size=(m, 3)).astype(np.float32)
    g_den = rng.normal(size=(m, 1)).astype(np.float32)

    def f(x, d):
        rgb, den = nerf_apply_fused(jp, x, d, jc)
        return jnp.sum(rgb * g_rgb) + jnp.sum(den * g_den)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(dirs))
    args = (tp, torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(g_rgb),
            torch.from_numpy(g_den), tc)
    frozen = FM.point_mlp_bwd_plain(*args, want_param_grads=False)
    assert frozen[0] is None and frozen[1] is None
    _assert_block("points", frozen[2].numpy(), ref[0])
    _assert_block("directions", frozen[3].numpy(), ref[1])


def _unswizzle(buf: np.ndarray, shapes, C: int):
    """The (N, K) blocks of a buffer of C-column slices (N rows of C bf16 a
    slice, rows 2C bytes) whose 16-byte chunk c of row r is stored at chunk
    c ^ (r % 8) (C = 64: the 128-byte swizzle) or c ^ ((r // 2) % 4) (C = 32:
    the 64-byte one), written out from the swizzle's definition."""
    out, at = [], 0
    for N, K in shapes:
        slices = -(-K // C)
        block = np.zeros((N, slices * C), dtype=buf.dtype)
        for s in range(slices):
            part = buf[at:at + N * C].reshape(N, C // 8, 8)
            at += N * C
            for r in range(N):
                turn = r % 8 if C == 64 else (r // 2) % 4
                for c in range(C // 8):
                    block[r, s * C + 8 * c:s * C + 8 * c + 8] = part[r, c ^ turn]
        assert not block[:, K:].any()            # columns past K are zero
        out.append(block[:, :K])
    assert at == buf.size
    return out


@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_pack_tiles_dx_slices_undo_to_every_weight(D):
    """(iii) the backward buffer in TilesDx's (128, 256) and TilesDxW's (384,
    512) order: w12, w11, w10, w8, w7, w6, w4, w3, w2, w1, w0, w5's encoding
    part, each weight's (in, out) block exactly."""
    cfg = NerfConfig(hidden_dim=D)
    params = init_torch_params(cfg, torch.Generator().manual_seed(D), device="cpu")
    _, tiles_dx, _ = F.pack_tiles_dx(params, cfg)
    _, W_in_out, _ = F.pack_weights_both(params, cfg)
    order = (12, 11, 10, 8, 7, 6, 4, 3, 2, 1, 0, 5)
    assert [i for i, _, _ in F._tile_dx_layout(D)] == list(order)
    C = 64 if D <= 256 else 32
    buf = tiles_dx.view(torch.int16).numpy()
    shapes = [tuple(W_in_out[i].shape) for i in order]
    for i, got in zip(order, _unswizzle(buf, shapes, C)):
        assert np.array_equal(got, W_in_out[i].view(torch.int16).numpy()), i


def _pose_setup(D):
    overrides = {"model": {"hidden_dim": D}, "rendering": {"num_points": 128},
                 "pose": {"learn_pose": True, "init_pose": True}}
    cfg = load_config(overrides=overrides)
    jcfg = jax_load_config(overrides=overrides)
    scene = dict(make_synthetic_scene(n_frames=2, h=12, w=16))
    jmc = JModelConfigs.from_cfg(jcfg, 2)
    jstate, _ = jax_create(jax.random.key(0), jmc, init_c2w=jnp.asarray(scene["c2ws_gt"]))
    mc = ModelConfigs.from_cfg(cfg, 2)
    assert mc.nerf.use_pallas and jmc.nerf.use_pallas and mc.nerf.hidden_dim == D
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
    return scene, jmc, jstate, mc, params


def test_three_pose_opt_steps_at_384_match_jax():
    """(iv) three steps of _pose_opt_step_impl over frames (0, 1, 0) at
    hidden_dim 384 on the fused route (K3, then K4's frozen variant),
    against the port's pose_opt_step with the JAX side's ray draws."""
    scene, jmc, jstate, mc, params = _pose_setup(384)
    n_points, lr = 16, 1e-3
    init = scene["c2ws_gt"] @ np.array(
        [[1, 0, 0, 0.05], [0, 1, 0, -0.03], [0, 0, 1, 0.02], [0, 0, 0, 1]], np.float32)
    jpcfg = JPoseConfig(num_cams=2, use_init_c2w=True)
    jpose = jax_init_pose_params(jpcfg, jnp.asarray(init))
    opt = optax.scale_by_adam()
    jopt_state = opt.init(jpose)
    key = jax.random.key(3)
    pcfg = PoseConfig(num_cams=2, use_init_c2w=True)
    pose = tree_from_numpy(jax.tree.map(np.asarray, jpose), "cpu")
    adam = init_adam(pose)
    imgs, cam = torch.from_numpy(scene["imgs"]), torch.from_numpy(scene["K"])
    h, w = scene["imgs"].shape[1:3]
    # one compiled step (the kernels' interpret mode traced once, not op by op)
    jstep = jax.jit(jax_pose_opt._pose_opt_step_impl, static_argnums=(5, 9, 10, 11, 12, 13, 14))
    for step, idx in enumerate((0, 1, 0)):
        _, kray = jax.random.split(key)
        ray_idx = np.asarray(_draw_rays(kray, h * w, n_points))
        with pltpu.force_tpu_interpret_mode():
            jpose, jopt_state, jloss, key = jstep(
                jpose, jopt_state, jstate.params["nerf"], None, jnp.asarray(scene["imgs"][idx]),
                idx, jnp.asarray(scene["K"]), key, lr, jpcfg, None, jmc.nerf, jmc.render,
                n_points, opt)
        loss = pose_opt.pose_opt_step(pose, adam, params["nerf"], None, imgs[idx], idx, cam,
                                      torch.from_numpy(ray_idx.copy()).long(), lr, pcfg, None,
                                      mc.nerf, mc.render)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3, err_msg=f"step {step}")
        for k, r in tree_to_numpy(pose).items():
            np.testing.assert_allclose(r, np.asarray(jpose[k]), rtol=0, atol=1e-4,
                                       err_msg=f"step {step} {k}")
    assert adam.count == 3
    assert float(np.abs(np.asarray(jpose["t"])).max()) > 5e-4     # the poses did move


def test_hierarchical_pose_opt_step_at_384_takes_the_frozen_route(monkeypatch):
    """(v) pose_opt_step with n_importance 16 at hidden_dim 384 on the CPU: its
    point_mlp backward runs frozen (no dW/dB), and the pose and its Adam state
    after two steps equal those of the same steps through the full backward."""
    from nope_nerf_torch.models.poses import init_pose_params
    from nope_nerf_torch.ops.render import RenderConfig

    tc = NerfConfig(hidden_dim=384, use_pallas=True)
    tp = init_torch_params(tc, torch.Generator().manual_seed(11), device="cpu")
    tp["density_b"] = tp["density_b"] - 4.0
    c2w = np.eye(4, dtype=np.float32)[None]
    c2w[0, 2, 3] = 2.5
    cam = np.array([[4.0, 0, 0, 0], [0, 4.0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    rcfg = RenderConfig(num_points=32, n_importance=16, depth_range=(0.5, 4.5))
    pcfg = PoseConfig(num_cams=1, use_init_c2w=True)
    img = torch.rand(6, 8, 3, generator=torch.Generator().manual_seed(1))
    flags = []
    plain = FM.point_mlp_bwd_plain

    def run(force_full):
        def bwd(params, pts, dirs, g_rgb, g_density, cfg, want_param_grads=True):
            flags.append(want_param_grads)
            return plain(params, pts, dirs, g_rgb, g_density, cfg, want_param_grads or force_full)
        monkeypatch.setattr(FM, "point_mlp_bwd_plain", bwd)
        pose = init_pose_params(pcfg, torch.from_numpy(c2w), device="cpu")
        adam = init_adam(pose)
        for _ in range(2):
            pose_opt.pose_opt_step(pose, adam, tp, None, img, 0, torch.from_numpy(cam),
                                   torch.arange(40), 1e-3, pcfg, None, tc, rcfg)
        return pose, adam

    pose_f, adam_f = run(False)
    assert flags == [False, False]
    pose_full, adam_full = run(True)
    assert not torch.equal(pose_f["t"], init_pose_params(pcfg, torch.from_numpy(c2w),
                                                         device="cpu")["t"])
    for k in pose_f:
        assert torch.equal(pose_f[k], pose_full[k]), k
        assert torch.equal(adam_f.mu[k], adam_full.mu[k]), k
        assert torch.equal(adam_f.nu[k], adam_full.nu[k]), k
