"""Port parity for the plain-torch pieces of the hierarchical slice: the
occupancy grid (ops/occupancy.py), the phong geometry view (ops/phong.py,
Trainer.render_geo), nerf_gradient and the normal output of
render_nope_nerf, against nope_nerf_tpu on the CPU in float32, with every
random draw pinned (the grid jitter, the occupancy sampler's draw, the
normal output's neighbour jitter are recomputed with jax.random and handed
to the port).

Tolerances. Grid lookups and masks: exact. Everything else float32 through
the same operations, summed in another order: 1e-5 absolute (values of
order 1), as nerf_gradient and the normals are held. The occupancy sampler
inverts a cdf as sample_pdf does: 1e-5 relative (tests/test_torch_hierarchical.py
says why its bins are kept off zero; here the floor 0.01 keeps them so).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.config import load_config as jax_load_config
from nope_nerf_tpu.data import SceneData as JSceneData, batch_for_frame as jax_batch
from nope_nerf_tpu.data import make_synthetic_scene
from nope_nerf_tpu.geometry.camera import camera_matrix_from_focal
from nope_nerf_tpu.models.nerf import NerfConfig as JNerfConfig, init_nerf_params
from nope_nerf_tpu.models.nerf import nerf_gradient as jax_nerf_gradient
from nope_nerf_tpu.ops import occupancy as jocc
from nope_nerf_tpu.ops import phong as jphong
from nope_nerf_tpu.ops import render as jrender
from nope_nerf_tpu.training import ModelConfigs as JModelConfigs, Trainer as JTrainer
from nope_nerf_tpu.training import create_train_state as jax_create

from nope_nerf_torch.config import load_config
from nope_nerf_torch.convert import params_from_numpy
from nope_nerf_torch.data import SceneData, batch_for_frame
from nope_nerf_torch.models.nerf import NerfConfig, nerf_gradient
from nope_nerf_torch.ops import occupancy as tocc
from nope_nerf_torch.ops import phong as tphong
from nope_nerf_torch.ops import render as trender
from nope_nerf_torch.training import ModelConfigs, Trainer

torch.set_num_threads(2)
HIDDEN, RES, RADIUS, N_RAYS = 32, 8, 4.0, 16


def _nerf(dist_alpha=False, shift=0.0, seed=0, scale=1.0):
    """Seeded float32 params; `scale` and `shift` act on the density head (a
    scale of 30 and a shift of -4 give a field whose occupancy crosses the
    phong threshold 0.5 inside the view)."""
    jc = JNerfConfig(hidden_dim=HIDDEN, compute_dtype="float32", dist_alpha=dist_alpha)
    tc = NerfConfig(hidden_dim=HIDDEN, compute_dtype="float32", dist_alpha=dist_alpha)
    jp = init_nerf_params(jax.random.key(seed), jc)
    jp["density_w"] = jp["density_w"] * scale
    jp["density_b"] = jp["density_b"] + shift
    return jc, tc, jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _camera(seed=0, n=N_RAYS):
    rng = np.random.default_rng(seed)
    cam = np.array(camera_matrix_from_focal(jnp.asarray(1.2), jnp.asarray(1.4)))
    world = np.eye(4, dtype=np.float32)
    world[:3, 3] = [0.3, -0.2, 2.5]
    pixels = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, size=(n, 1)).astype(np.float32)
    return cam, world, pixels, depth


def _grid(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(RES, RES, RES)) ** 3).astype(np.float32)


def test_grid_lookup_matches_jax():
    grid = _grid()
    pts = np.random.default_rng(2).uniform(-5, 5, size=(40, 7, 3)).astype(np.float32)
    ref = jocc.grid_lookup(jnp.asarray(grid), jnp.asarray(pts), RADIUS)
    got = tocc.grid_lookup(torch.from_numpy(grid), torch.from_numpy(pts), RADIUS)
    assert got.shape == (40, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.min()) == 0.0 and bool((got > 0).any())   # some points outside the cube
    assert torch.equal(tocc.make_occupancy_grid(RES, "cpu"), torch.ones(RES, RES, RES))


@pytest.mark.parametrize("dist_alpha", [False, True])
def test_update_occupancy_grid_matches_jax(dist_alpha):
    jc, tc, jp, tp = _nerf(dist_alpha)
    grid = _grid()
    key = jax.random.key(4)
    ref = jocc.update_occupancy_grid(jnp.asarray(grid), jp, key, jc, radius=RADIUS, decay=0.9)
    jitter = np.array(jax.random.uniform(key, (RES ** 3, 3), minval=-0.5, maxval=0.5))
    got = tocc.update_occupancy_grid(torch.from_numpy(grid), tp, tc, radius=RADIUS, decay=0.9,
                                     jitter=torch.from_numpy(jitter))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert bool((got > torch.from_numpy(grid) * 0.9).any())   # some cells took the new alpha
    gen = torch.Generator().manual_seed(3)
    a = tocc.update_occupancy_grid(torch.from_numpy(grid), tp, tc, generator=gen)
    b = tocc.update_occupancy_grid(torch.from_numpy(grid), tp, tc,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("add_noise", [False, True])
def test_occupancy_z_samples_matches_jax(add_noise):
    grid = _grid()
    rng = np.random.default_rng(5)
    origin = np.array([0.3, -0.2, 0.5], np.float32)
    v = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    steps, depth_range = 32, (0.5, 6.0)
    key = jax.random.key(6)
    ref = jocc.occupancy_z_samples(key, jnp.asarray(origin), jnp.asarray(v), jnp.asarray(grid),
                                   steps, depth_range, RADIUS, 0.01, add_noise)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (N_RAYS, steps), jnp.float32)))
    got = tocc.occupancy_z_samples(torch.from_numpy(origin), torch.from_numpy(v),
                                   torch.from_numpy(grid), steps, depth_range, RADIUS, 0.01,
                                   add_noise, noise=noise)
    assert got.shape == (N_RAYS, steps) and bool((got[:, 1:] >= got[:, :-1]).all())
    assert float(got.min()) >= 0.5 and float(got.max()) <= 6.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_render_with_occupancy_grid_matches_jax():
    """The grid-guided z feeds the renderer (and the fused train route) as any z."""
    jc, tc, jp, tp = _nerf(shift=-3.0)
    grid = _grid()
    cam, world, pixels, depth = _camera()
    rk = dict(num_points=32, depth_range=(0.5, 6.0))
    key = jax.random.key(7)
    ref = jrender.render_nope_nerf(jp, jnp.asarray(pixels), jnp.asarray(depth), jnp.asarray(cam),
                                   jnp.asarray(world), None, key, jrender.RenderConfig(**rk), jc,
                                   occ_grid=jnp.asarray(grid))
    _, knoise, _ = jax.random.split(key, 3)
    noise = torch.from_numpy(np.array(jax.random.uniform(knoise, (N_RAYS, 32), jnp.float32)))
    args = (torch.from_numpy(pixels), torch.from_numpy(depth), torch.from_numpy(cam),
            torch.from_numpy(world), None, None, trender.RenderConfig(**rk))
    got = trender.render_nope_nerf(tp, *args, tc, noise=noise, occ_grid=torch.from_numpy(grid))
    for k in ("z_vals", "rgb", "depth_pred", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    _, z, _, _ = trender.fused_train_prepare(*args, True, noise=noise,
                                             occ_grid=torch.from_numpy(grid))
    assert torch.equal(z, got["z_vals"])


def test_nerf_gradient_matches_jax():
    jc, tc, jp, tp = _nerf()
    pts = np.random.default_rng(8).normal(size=(50, 3)).astype(np.float32)
    ref = np.asarray(jax_nerf_gradient(jp, jnp.asarray(pts), jc))
    got = nerf_gradient(tp, torch.from_numpy(pts), tc)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert not got.requires_grad
    # in grad mode the normals stay differentiable in the params (create_graph)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    g = nerf_gradient(leaves, torch.from_numpy(pts), tc)
    g.square().sum().backward()
    assert float(leaves["trunk0_0_w"].grad.abs().max()) > 0
    with torch.no_grad():
        assert not nerf_gradient(leaves, torch.from_numpy(pts), tc).requires_grad


def test_normal_output_matches_jax():
    jc, tc, jp, tp = _nerf()
    cam, world, pixels, depth = _camera()
    rk = dict(num_points=32, normal_loss=True)
    key = jax.random.key(9)
    ref = jrender.render_nope_nerf(jp, jnp.asarray(pixels), jnp.asarray(depth), jnp.asarray(cam),
                                   jnp.asarray(world), None, key, jrender.RenderConfig(**rk), jc)
    _, knoise, knormal = jax.random.split(key, 3)
    noise = np.array(jax.random.uniform(knoise, (N_RAYS, 32), jnp.float32))
    nnoise = np.array(jax.random.uniform(knormal, (N_RAYS, 3), jnp.float32))
    args = (torch.from_numpy(pixels), torch.from_numpy(depth), torch.from_numpy(cam),
            torch.from_numpy(world), None, None, trender.RenderConfig(**rk), tc)
    got = trender.render_nope_nerf(tp, *args, noise=torch.from_numpy(noise),
                                   normal_noise=torch.from_numpy(nnoise))
    assert got["normal"].shape == (N_RAYS,)
    np.testing.assert_allclose(got["normal"].numpy(), np.asarray(ref["normal"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]), rtol=0, atol=1e-5)
    assert "normal" not in trender.render_nope_nerf(tp, *args, add_noise=False, eval_=True)


def test_ray_marching_and_phong_render_match_jax():
    jc, tc, jp, tp = _nerf(shift=-4.0, scale=30.0)
    cam, world, pixels, _ = _camera(n=64)
    ref = jphong.phong_render(jp, jnp.asarray(pixels), jnp.asarray(cam), jnp.asarray(world), None,
                              jc, radius=RADIUS, n_steps=128)
    got = tphong.phong_render(tp, torch.from_numpy(pixels), torch.from_numpy(cam),
                              torch.from_numpy(world), None, tc, radius=RADIUS, n_steps=128)
    mask = got["mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(ref["mask"]))
    assert mask.any() and not mask.all()             # both hits and misses
    for k in ("rgb", "rgb_surf", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    hits, sphere = tphong.get_sphere_intersection(torch.tensor([0.0, 0.0, 5.0]),
                                                  torch.tensor([[0.0, 0.0, -1.0],
                                                                [1.0, 0.0, 0.0]]), r=RADIUS)
    assert sphere.tolist() == [True, False]
    torch.testing.assert_close(hits[0], torch.tensor([1.0, 9.0]))


def _occ_cfg(**rendering):
    over = {"model": {"hidden_dim": HIDDEN},
            "rendering": {"occupancy_grid": True, "occupancy_res": RES, **rendering},
            "tpu": {"compute_dtype": "float32"}}
    return load_config(overrides=over)


def test_trainer_keeps_the_occupancy_grid():
    cfg = _occ_cfg()
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=3, h=12, w=16)).to_device("cpu")
    mc = ModelConfigs.from_cfg(cfg, 3)
    from nope_nerf_torch.training import create_train_state
    state = create_train_state(0, mc, device="cpu")
    a, b = Trainer(cfg, mc), Trainer(cfg, mc)
    assert a.occ_grid is None
    a.update_occupancy(state, 0)
    b.update_occupancy(state, 0)
    assert a.occ_grid.shape == (RES,) * 3 and torch.equal(a.occ_grid, b.occ_grid)
    before = a.occ_grid.clone()
    a.update_occupancy(state, 1)
    assert not torch.equal(a.occ_grid, before)
    a.reset_occupancy()
    assert torch.equal(a.occ_grid, torch.ones(RES, RES, RES))
    b.set_occupancy_grid(before.numpy())
    assert torch.equal(b.occ_grid, before)
    # the step takes the grid: its z differ from the stratified ones
    state, ld = a.step(state, batch_for_frame(scene, 0, ref_idx=1), 0, 10000)
    assert all(bool(torch.isfinite(v).all()) for v in ld.values())
    # off: nothing is created or installed; with ndc sampling the grid is off
    off = Trainer(load_config(overrides={"model": {"hidden_dim": HIDDEN}}), mc)
    off.update_occupancy(state, 0)
    off.set_occupancy_grid(before.numpy())
    assert off.occ_grid is None
    ndc = _occ_cfg(sample_option="ndc")
    assert Trainer(ndc, ModelConfigs.from_cfg(ndc, 3))._occ_enabled is False


def test_render_geo_matches_jax():
    """Trainer.render_geo of a state without learned poses (the frame's own
    pose) against the JAX package's, from the same params: the camera and the
    field of the phong test above, so that the view holds hits and misses."""
    over = {"model": {"hidden_dim": HIDDEN}, "tpu": {"compute_dtype": "float32"},
            "pose": {"learn_pose": False}}
    scene_np = dict(make_synthetic_scene(n_frames=3, h=12, w=16))
    jcfg = jax_load_config(overrides=over)
    jmc = JModelConfigs.from_cfg(jcfg, 3)
    jstate, optimizers = jax_create(jax.random.key(0), jmc)
    _, _, jp, tp = _nerf(shift=-4.0, scale=30.0)
    jstate.params["nerf"] = jp
    cam, world, _, _ = _camera()
    pose = np.linalg.inv(world).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in jax_batch(JSceneData.from_dict(scene_np), 1).items()}
    jbatch.update(pose_gt=jnp.asarray(pose), camera_mat=jnp.asarray(cam))
    ref = JTrainer(jcfg, jmc, optimizers).render_geo(jstate, jbatch, (6, 8), chunk=16, n_steps=64)

    cfg = load_config(overrides=over)
    mc = ModelConfigs.from_cfg(cfg, 3)
    from nope_nerf_torch.training import create_train_state
    state = create_train_state(0, mc, device="cpu")
    state.params["nerf"] = tp
    batch = batch_for_frame(SceneData.from_dict(scene_np).to_device("cpu"), 1)
    batch.update(pose_gt=torch.from_numpy(pose), camera_mat=torch.from_numpy(cam))
    got = Trainer(cfg, mc).render_geo(state, batch, (6, 8), chunk=16, n_steps=64)
    assert got.shape == (6, 8, 3) and np.isfinite(got).all()
    assert (got < 1.0).any() and (got == 1.0).all(axis=-1).any()   # shaded hits and white misses
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
