"""Port parity: geometry (lie, camera) and safe_norm against nope_nerf_tpu.

Inputs come from numpy and go to both packages. Tolerance: f32 atol 1e-5, for
the reassociation of f32 sums in the 4x4 products (XLA and PyTorch order them
differently); pixel_grid is the same numpy formula, so it must match exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.geometry import camera as jcam
from nope_nerf_tpu.geometry import lie as jlie
from nope_nerf_tpu.models import poses as jposes
from nope_nerf_tpu.utils.safemath import safe_norm as jsafe_norm

from nope_nerf_torch.geometry import camera as tcam
from nope_nerf_torch.geometry import lie as tlie
from nope_nerf_torch.models import poses as tposes
from nope_nerf_torch.utils.safemath import safe_norm as tsafe_norm

torch.set_num_threads(2)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(ref), rtol=0, atol=atol)


def _rotvecs(seed, n=16):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    r[0] = 0.0                      # the exp-map's clamped branch
    r[1] = 1e-8
    return r


def _c2w(seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=3).astype(np.float32) * 0.3
    t = rng.normal(size=3).astype(np.float32) * 2.0
    return np.asarray(jlie.make_c2w(jnp.asarray(r), jnp.asarray(t)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vec2skew_exp_log_make_c2w(seed):
    r = _rotvecs(seed)
    t = np.random.default_rng(seed + 10).normal(size=r.shape).astype(np.float32)
    _close(tlie.vec2skew(_t(r)), jlie.vec2skew(jnp.asarray(r)))
    R_t = tlie.exp_so3(_t(r))
    _close(R_t, jlie.exp_so3(jnp.asarray(r)))
    _close(tlie.log_so3(R_t), jlie.log_so3(jnp.asarray(R_t.numpy())), atol=1e-4)
    _close(tlie.make_c2w(_t(r), _t(t)), jlie.make_c2w(jnp.asarray(r), jnp.asarray(t)))


def test_exp_so3_gradient_finite_at_zero():
    r = torch.zeros(3, requires_grad=True)
    tlie.exp_so3(r).sum().backward()
    assert torch.isfinite(r.grad).all()


@pytest.mark.parametrize("learn_R,learn_t,use_init", [(True, True, False),
                                                     (False, True, True)])
def test_pose_c2w(learn_R, learn_t, use_init):
    n = 5
    rng = np.random.default_rng(3)
    r = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    t = rng.normal(size=(n, 3)).astype(np.float32)
    init = np.stack([_c2w(s) for s in range(n)]) if use_init else None
    jcfg = jposes.PoseConfig(num_cams=n, learn_R=learn_R, learn_t=learn_t, use_init_c2w=use_init)
    tcfg = tposes.PoseConfig(num_cams=n, learn_R=learn_R, learn_t=learn_t, use_init_c2w=use_init)
    jp = {"r": jnp.asarray(r), "t": jnp.asarray(t)}
    tp = {"r": _t(r), "t": _t(t)}
    if use_init:
        jp["init_c2w"], tp["init_c2w"] = jnp.asarray(init), _t(init)
    _close(tposes.pose_c2w_all(tp, tcfg), jposes.pose_c2w_all(jp, jcfg))
    _close(tposes.pose_c2w(tp, 2, tcfg), jposes.pose_c2w(jp, 2, jcfg))
    init_t = tposes.init_pose_params(tcfg, init_c2w=init, device="cpu")
    init_j = jposes.init_pose_params(jcfg, init_c2w=init)
    assert set(init_t) == set(init_j)
    for k in init_t:
        _close(init_t[k], init_j[k], atol=0)


@pytest.mark.parametrize("res", [(4, 6), (24, 32), (188, 621)])
def test_pixel_grid_bitwise(res):
    loc_t, pix_t = tcam.pixel_grid(res)
    loc_j, pix_j = jcam.pixel_grid(res)
    np.testing.assert_array_equal(loc_t, np.asarray(loc_j))
    np.testing.assert_array_equal(pix_t, np.asarray(pix_j))


@pytest.mark.parametrize("seed", [0, 1])
def test_rigid_inverse_and_camera_matrices(seed):
    c2w = _c2w(seed)
    _close(tcam.rigid_inverse(_t(c2w)), jcam.rigid_inverse(jnp.asarray(c2w)))
    fx, fy = np.float32(1.3 + seed), np.float32(0.7)
    _close(tcam.camera_matrix_from_focal(torch.tensor(fx), torch.tensor(fy)),
           jcam.camera_matrix_from_focal(jnp.asarray(fx), jnp.asarray(fy)), atol=0)
    np.testing.assert_array_equal(tcam.intrinsics_ndc_np(500.0, 480.0, 621, 188),
                                  jcam.intrinsics_ndc_np(500.0, 480.0, 621, 188))


def _frame(seed, n=64):
    rng = np.random.default_rng(seed)
    K = jcam.intrinsics_ndc_np(50.0, 48.0, 64, 48)
    world = np.linalg.inv(_c2w(seed)).astype(np.float32)
    pix = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 8.0, size=(n, 1)).astype(np.float32)
    return K, world, pix, depth


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("normalize", [True, False])
def test_rays_and_transform_to_world(seed, normalize):
    K, world, pix, depth = _frame(seed)
    o_t, v_t, n_t = tcam.rays_from_pixels(_t(pix), _t(K), _t(world), normalize=normalize)
    o_j, v_j, n_j = jcam.rays_from_pixels(jnp.asarray(pix), jnp.asarray(K), jnp.asarray(world),
                                          normalize=normalize)
    _close(o_t, o_j)
    _close(v_t, v_j)
    _close(n_t, n_j)
    _close(tcam.transform_to_world(_t(pix), _t(depth), _t(K), _t(world)),
           jcam.transform_to_world(jnp.asarray(pix), jnp.asarray(depth), jnp.asarray(K),
                                   jnp.asarray(world)), atol=1e-4)  # |p| up to ~10


@pytest.mark.parametrize("seed", [0, 1])
def test_ndc_rays(seed):
    K, world, pix, _ = _frame(seed)
    o_j, v_j, _ = jcam.rays_from_pixels(jnp.asarray(pix), jnp.asarray(K), jnp.asarray(world))
    fxfy = np.array([K[0, 0], K[1, 1]], np.float32)
    no_t, nd_t = tcam.get_ndc_rays_fxfy(_t(fxfy), 1.0, _t(o_j)[None, :], _t(v_j))
    no_j, nd_j = jcam.get_ndc_rays_fxfy(jnp.asarray(fxfy), 1.0, o_j[None, :], v_j)
    _close(no_t, no_j, atol=1e-4)
    _close(nd_t, nd_j, atol=1e-4)


def test_safe_norm_values_and_zero_gradient():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    x[3] = 0.0
    xt = _t(x).requires_grad_(True)
    n_t = tsafe_norm(xt, dim=-1)
    _close(n_t, jsafe_norm(jnp.asarray(x), axis=-1))
    n_t.sum().backward()
    g_j = jax.grad(lambda a: jnp.sum(jsafe_norm(a, axis=-1)))(jnp.asarray(x))
    _close(xt.grad, g_j)
    assert torch.all(xt.grad[3] == 0)
    assert tsafe_norm(_t(x), dim=-1, keepdim=True).shape == (8, 1)


@pytest.mark.parametrize("fx,fy,w,h", [(500.0, 480.0, 621, 188), (1.3e3, 1.1e3, 960, 540),
                                       (407.56, 407.56, 1008, 756)])
def test_intrinsics_ndc(fx, fy, w, h):
    _close(tcam.intrinsics_ndc(fx, fy, w, h), jcam.intrinsics_ndc(fx, fy, w, h))
    assert tcam.intrinsics_ndc(fx, fy, w, h).dtype == torch.float32
    np.testing.assert_array_equal(tcam.intrinsics_ndc(fx, fy, w, h).numpy(),
                                  tcam.intrinsics_ndc_np(fx, fy, w, h))


@pytest.mark.parametrize("shape", [(3, 4), (5, 3, 4), (2, 7, 3, 4)])
def test_convert3x4_4x4(shape):
    m = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    got = tlie.convert3x4_4x4(_t(m))
    assert got.shape == shape[:-2] + (4, 4)
    _close(got, jlie.convert3x4_4x4(jnp.asarray(m)), atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("invert", [True, False])
def test_image_points_to_world(seed, invert):
    K, world, pix, _ = _frame(seed)
    _close(tcam.image_points_to_world(_t(pix), _t(K), _t(world), invert=invert),
           jcam.image_points_to_world(jnp.asarray(pix), jnp.asarray(K), jnp.asarray(world),
                                      invert=invert))


def test_geometry_exports_what_the_jax_package_does():
    import nope_nerf_torch.geometry as tgeo
    import nope_nerf_tpu.geometry as jgeo
    names = {n for n in dir(jgeo) if not n.startswith("_") and callable(getattr(jgeo, n))}
    missing = sorted(n for n in names if not hasattr(tgeo, n))
    assert not missing, missing
