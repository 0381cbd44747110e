"""Port parity for the whole first slice: checkpoint -> novel-view render.

A checkpoint written by nope_nerf_tpu (with its real optax state) is read by
the port, and the port's render CLI must reproduce the JAX render CLI's
frames (JAX unfused bfloat16 path vs the port's fused route on the CPU) on a
24x32 frame at hidden width 128, tolerance 2e-3 x max|ref| as in
test_torch_render.py. A port-written checkpoint must load in JAX the way
nope_nerf_tpu's render CLI loads it (load_model_only=True), and the
parameter conversion must round-trip exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nope_nerf_tpu.cli.render import render as jax_render
from nope_nerf_tpu.config import load_config
from nope_nerf_tpu.data import make_synthetic_scene
from nope_nerf_tpu.geometry.lie import log_so3
from nope_nerf_tpu.training import ModelConfigs, create_train_state
from nope_nerf_tpu.training.checkpoints import load_checkpoint as jax_load
from nope_nerf_tpu.training.checkpoints import save_checkpoint as jax_save

from nope_nerf_torch.cli.render import render as port_render
from nope_nerf_torch.config import load_config as port_load_config
from nope_nerf_torch.convert import params_from_numpy, params_to_numpy
from nope_nerf_torch.training.checkpoints import load_params as port_load
from nope_nerf_torch.training.checkpoints import save_params as port_save

torch.set_num_threads(2)
N_CAMS = 8   # the synthetic scene both render CLIs build


def _overrides(out_dir, port, traj="bspline", **extra):
    o = {"model": {"hidden_dim": 128},
         "training": {"out_dir": str(out_dir)},
         "extract_images": {"resolution": [24, 32], "N_novel_imgs": 2, "traj_option": traj},
         # the JAX side renders unfused (no TPU here), the port through its fused route
         "tpu": {"use_pallas_renderer": port}}
    o.update(extra)
    return o


def _jax_state(cfg, seed=3):
    state, _ = create_train_state(jax.random.key(seed), ModelConfigs.from_cfg(cfg, N_CAMS))
    c2ws = jnp.asarray(make_synthetic_scene(n_frames=N_CAMS, h=120, w=160)["c2ws_gt"])
    params = dict(state.params)
    params["pose"] = {"r": log_so3(c2ws[:, :3, :3]), "t": c2ws[:, :3, 3]}
    return state.replace(params=params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ckpt")
    cfg = load_config(overrides=_overrides(out, False))
    state = _jax_state(cfg)
    jax_save(str(out), "model.ckpt", state, scalars={"epoch": 3})
    return out, state


def test_port_reads_jax_checkpoint(jax_ckpt):
    out, state = jax_ckpt
    params, scalars = port_load(str(out), "model.ckpt", device="cpu")
    assert scalars == {"epoch": 3}
    assert set(params) == set(state.params) == {"nerf", "pose", "distortion"}
    ref = dict(_leaves(jax.tree.map(np.asarray, state.params)))
    got = dict(_leaves(params))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert port_load(str(out), "missing.ckpt", device="cpu") is None


@pytest.mark.parametrize("traj", ["bspline", "interp", "spiral"])
def test_render_cli_matches_jax(jax_ckpt, traj):
    out, _ = jax_ckpt
    ref = jax_render(load_config(overrides=_overrides(out, False, traj)), synthetic=True)
    got = port_render(port_load_config(overrides=_overrides(out, True, traj)), synthetic=True,
                      device="cpu", save=False)
    assert len(got) == len(ref) == 2
    for f_got, f_ref in zip(got, ref):
        for k in ("rgb", "depth", "disp"):
            r = np.asarray(f_ref[k])
            assert f_got[k].shape == r.shape and np.isfinite(f_got[k]).all()
            if k == "disp":
                np.testing.assert_allclose(f_got[k], r, rtol=4e-3)
            else:
                assert np.max(np.abs(f_got[k] - r)) < 2e-3 * max(1e-3, np.abs(r).max()), k


def test_jax_reads_port_checkpoint(tmp_path):
    cfg = load_config(overrides=_overrides(tmp_path, False))
    state = _jax_state(cfg, seed=5)
    port_params = params_from_numpy(jax.tree.map(np.asarray, state.params), device="cpu")
    port_save(str(tmp_path), "model.ckpt", port_params)
    template = _jax_state(cfg, seed=6)
    loaded, scalars = jax_load(str(tmp_path), "model.ckpt", template, load_model_only=True)
    assert scalars == {}
    ref = dict(_leaves(jax.tree.map(np.asarray, state.params)))
    got = dict(_leaves(jax.tree.map(np.asarray, loaded.params)))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_convert_round_trip_exact():
    cfg = load_config(overrides={"model": {"hidden_dim": 128},
                                 "pose": {"learn_focal": True, "init_pose": True}})
    mc = ModelConfigs.from_cfg(cfg, 4)
    c2ws = jnp.tile(jnp.eye(4)[None], (4, 1, 1))
    state, _ = create_train_state(jax.random.key(1), mc, init_c2w=c2ws, init_focal=[1.1, 0.9])
    tree = jax.tree.map(np.asarray, state.params)
    assert set(tree) == {"nerf", "pose", "focal", "distortion"}
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    ref, got = dict(_leaves(tree)), dict(_leaves(back))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(ValueError):
        params_from_numpy({"optimizer": {}}, device="cpu")


def test_port_render_requires_checkpoint_and_synthetic(tmp_path):
    cfg = port_load_config(overrides=_overrides(tmp_path, True))
    with pytest.raises(FileNotFoundError):
        port_render(cfg, synthetic=True, device="cpu", save=False)
    # scenes on disk are ported: a config that names none is refused by name
    with pytest.raises(ValueError, match="dataloading.path"):
        port_render(cfg, synthetic=False, device="cpu", save=False)


def test_port_config_defaults_match_jax():
    assert port_load_config() == load_config()
    o = _overrides("x", True)
    assert port_load_config(overrides=o) == load_config(overrides=o)
