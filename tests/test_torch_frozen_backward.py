"""The frozen-network backward of the point-query MLP (K6's frozen-network
variant, ops/fused_mlp.py), on the CPU, where it runs as its plain version.

- point_mlp_bwd_plain(want_param_grads=False) returns no dW/dB and the full
  plain call's d(points), d(directions) bit for bit; both are held against
  the JAX package's VJP of nerf_apply_fused with respect to the points and
  directions, run in interpret mode as tests/test_pallas_mlp.py runs it, at
  hidden width 128 and a ragged M of 300. Two classes of tolerance: the f32
  stage (the encoding VJP from the same f32 cotangent, the forward's own
  f32 sin/cos on both sides) at rtol 1e-5; the whole VJP, whose cotangents
  pass bf16-rounded through every product and whose ReLU masks come from bf16
  activations summed in another order, within 2e-2 of each block's largest
  entry (the bf16 class).
- point_mlp's backward takes the frozen route exactly when no nerf parameter
  requires a gradient (a stub of the CUDA route records the flag), and a
  hierarchical pose_opt_step moves the pose as it did through the full
  backward, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.ops.pallas_mlp import DE_DIM, PE_DIM, encode_lanes as jax_encode_lanes

from nope_nerf_torch.models.nerf import NerfConfig
from nope_nerf_torch.ops import fused_mlp as FM
from nope_nerf_torch.ops.fused_render import _enc_deriv_to_coords

torch.set_num_threads(2)
HIDDEN = 128
M = 300


def _setup(occ="softplus", dist_alpha=False, seed=0):
    jc = JNerfConfig(hidden_dim=HIDDEN, compute_dtype="bfloat16", occ_activation=occ,
                     dist_alpha=dist_alpha, use_pallas=True)
    tc = NerfConfig(hidden_dim=HIDDEN, occ_activation=occ, dist_alpha=dist_alpha, use_pallas=True)
    jp = init_nerf_params(jax.random.key(seed), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(M, 3)) * 2.0).astype(np.float32)
    dirs = rng.normal(size=(M, 3)).astype(np.float32)
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    g_den = rng.normal(size=(M, 1)).astype(np.float32)
    return jc, tc, jp, tp, pts, dirs, g_rgb, g_den


@pytest.mark.parametrize("levels,width,which", [(10, PE_DIM, "points"), (4, DE_DIM, "directions")])
def test_encoding_vjp_matches_jax_in_f32(levels, width, which):
    """The f32 stage of the frozen backward: a cotangent of the dense-lane
    encoding pulled to the coordinates, port against jax.vjp of the JAX
    package's encode_lanes. Each entry sums 1 + 2L terms of up to 2^(L-1)
    |g| that cancel, with sin and cos from two libraries: rtol 1e-5 of the
    sum of the terms' magnitudes."""
    rng = np.random.default_rng(levels)
    x = (rng.normal(size=(M, 3)) * 2.0).astype(np.float32)
    g = rng.normal(size=(M, width)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jax_encode_lanes(p, levels, width), jnp.asarray(x))
    ref, = vjp(jnp.asarray(g))
    got = _enc_deriv_to_coords(torch.from_numpy(g), torch.from_numpy(x), levels)
    scale = 2.0 ** np.arange(levels)[None, :, None]
    terms = (np.abs(g[:, :3]) + (scale * (np.abs(g[:, 3:3 + 3 * levels]).reshape(M, levels, 3)
                                          + np.abs(g[:, 3 + 3 * levels:3 + 6 * levels])
                                          .reshape(M, levels, 3))).sum(axis=1))
    err = np.abs(got.numpy() - np.asarray(ref))
    assert (err <= 1e-5 * terms).all(), (which, float((err / terms).max()))


@pytest.mark.parametrize("occ,dist_alpha", [("softplus", False), ("relu", True)])
def test_frozen_plain_backward_matches_full_and_pallas_vjp(occ, dist_alpha):
    from jax.experimental.pallas import tpu as pltpu
    from nope_nerf_tpu.ops.pallas_mlp import nerf_apply_fused

    jc, tc, jp, _, pts, dirs, g_rgb, g_den = _setup(occ, dist_alpha, seed=5)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    args = (tp, torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(g_rgb),
            torch.from_numpy(g_den), tc)
    full = FM.point_mlp_bwd_plain(*args)
    frozen = FM.point_mlp_bwd_plain(*args, want_param_grads=False)
    assert frozen[0] is None and frozen[1] is None
    assert torch.equal(frozen[2], full[2]) and torch.equal(frozen[3], full[3])

    def f(x, d):
        rgb, den = nerf_apply_fused(jp, x, d, jc)
        return jnp.sum(rgb * g_rgb) + jnp.sum(den * g_den)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(dirs))
    for name, got, r in (("points", frozen[2], ref[0]), ("directions", frozen[3], ref[1])):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert scale > 0
        err = float(np.abs(got.numpy() - r).max())
        assert err <= 2e-2 * scale, f"{name}: {err} vs largest {scale}"


def _route_stub(monkeypatch, calls):
    """point_mlp's CUDA route on the CPU: the route flag read as for a card
    tensor, the kernels' wrappers replaced by their plain versions, recording
    the backward's want_param_grads."""
    monkeypatch.setattr(FM, "runs_plain", lambda t: False)
    monkeypatch.setattr(FM, "_mlp_fwd_cuda", FM.point_mlp_fwd_plain)

    def bwd(params, pts, dirs, g_rgb, g_density, cfg, want_param_grads=True):
        calls.append(want_param_grads)
        return FM.point_mlp_bwd_plain(params, pts, dirs, g_rgb, g_density, cfg, want_param_grads)

    monkeypatch.setattr(FM, "_mlp_bwd_cuda", bwd)


@pytest.mark.parametrize("frozen", [True, False])
def test_point_mlp_backward_takes_the_frozen_route_without_param_grads(monkeypatch, frozen):
    _, tc, _, tp, pts, dirs, g_rgb, g_den = _setup(seed=6)
    calls = []
    _route_stub(monkeypatch, calls)
    leaves = {k: v.clone().requires_grad_(not frozen) for k, v in tp.items()}
    x = torch.from_numpy(pts).requires_grad_(True)
    rgb, den = FM.point_mlp(leaves, x, torch.from_numpy(dirs), tc)
    ((rgb * torch.from_numpy(g_rgb)).sum() + (den * torch.from_numpy(g_den)).sum()).backward()
    assert calls == [not frozen]
    assert all((v.grad is None) == frozen for v in leaves.values())
    ref = FM.point_mlp_bwd_plain(tp, torch.from_numpy(pts), torch.from_numpy(dirs),
                                 torch.from_numpy(g_rgb), torch.from_numpy(g_den), tc)
    assert torch.equal(x.grad, ref[2])


def test_hierarchical_pose_opt_step_is_unchanged_by_the_frozen_route(monkeypatch):
    """pose_opt_step with n_importance > 0 on the CPU: its point_mlp backward
    runs frozen (no dW/dB), and the pose and its Adam state after two steps
    are those of the same steps through the full backward, bit for bit."""
    from nope_nerf_torch.evaluation.pose_opt import pose_opt_step
    from nope_nerf_torch.models.poses import PoseConfig, init_pose_params
    from nope_nerf_torch.ops.render import RenderConfig
    from nope_nerf_torch.training.state import init_adam

    _, tc, _, tp, *_ = _setup(seed=7)
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
            pose_opt_step(pose, adam, tp, None, img, 0, torch.from_numpy(cam), torch.arange(40),
                          1e-3, pcfg, None, tc, rcfg)
        return pose, adam

    pose_f, adam_f = run(False)
    assert flags == [False, False]
    pose_full, adam_full = run(True)
    assert not torch.equal(pose_f["t"], init_pose_params(pcfg, torch.from_numpy(c2w),
                                                         device="cpu")["t"])
    for k in pose_f:
        assert torch.equal(pose_f[k], pose_full[k]), k
        assert torch.equal(adam_f.mu[k], adam_full.mu[k]) and torch.equal(adam_f.nu[k],
                                                                          adam_full.nu[k]), k
