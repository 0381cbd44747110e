"""The invariant-depth train step against itself in float64, on the CPU: is
the gap between the two packages' float32 gradients round-off?

tests/test_torch_parallel.py holds the port's invariant-depth step
(depth_loss_type invariant: the depth loss after a least-squares scale and
shift fit of the rendered depth to the prior, and a median) against the JAX
package's at 3e-4 of each gradient block's largest entry. Here the port's
one-process step is evaluated again in float64 (default dtype float64, the
parameters and the batch cast up; the constants built in float32, such as
the sample depths, are the same values) on the same inputs. Both packages'
float32 gradients lie within float32 round-off of it: each is no farther
from it than twice the largest change its own float32 step shows when only
the order of the same 64 rays changes, which changes nothing but the order
of the sums (a formula that differed would move every order alike, and
stand out). The port is the nearer of the two; the JAX package's float32
step is the farther (its reductions accumulate in another order).
Loss terms agree to float32 round-off as well.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_parallel import FRAME, H, N_FRAMES, REF, W, _overrides, _port_setup, _ray_idx

torch.set_num_threads(2)
PERMUTATIONS = 3


def _blocks_dev(got, ref, scale=None):
    """The largest deviation of `got` from `ref` over the gradient blocks, each
    relative to the block's largest entry in `scale` (default `ref`)."""
    scale = scale or ref
    worst = 0.0
    for g in ref:
        for k, r in ref[g].items():
            top = float(np.abs(np.asarray(scale[g][k])).max()) if r.size else 0.0
            if top > 0:
                diff = np.asarray(got[g][k], np.float64) - np.asarray(r, np.float64)
                worst = max(worst, float(np.abs(diff).max()) / top)
    return worst


def _np(tree):
    return {g: {k: v.detach().cpu().numpy() for k, v in d.items()} for g, d in tree.items()}


def _jax_step(weights):
    """The JAX package's one-process step on the same scene, as a function of
    (params as numpy, ray indices)."""
    import jax
    import jax.numpy as jnp

    from nope_nerf_tpu.config import load_config as jload
    from nope_nerf_tpu.data import SceneData as JScene, batch_for_frame as jbatch
    from nope_nerf_tpu.data import make_synthetic_scene as jscene
    from nope_nerf_tpu.training import ModelConfigs as JModelConfigs
    from nope_nerf_tpu.training.trainer import compute_step_loss
    cfg = jload(overrides=_overrides("invariant"))
    scene = JScene.from_dict(dict(jscene(n_frames=N_FRAMES, h=H, w=W)))
    mc = dataclasses.replace(JModelConfigs.from_cfg(cfg, N_FRAMES), stratified_noise=False)
    batch = {k: jnp.asarray(v) for k, v in jbatch(scene, FRAME, ref_idx=REF).items()}
    w = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
    vg = jax.jit(jax.value_and_grad(functools.partial(
        compute_step_loss, mc=mc, rgb_loss_type="l1"), has_aux=True))

    def step(params_np, ray_idx):
        (_, ld), g = vg(jax.tree.map(jnp.asarray, params_np), batch, w,
                        jnp.asarray(ray_idx.astype(np.int32)), jax.random.key(7))
        return jax.tree.map(np.asarray, g), {k: float(v) for k, v in ld.items()}

    return step


@pytest.fixture(scope="module")
def steps():
    from nope_nerf_torch.convert import params_to_numpy
    from nope_nerf_torch.data import batch_for_frame
    from nope_nerf_torch.training.trainer import step_gradients
    _, scene, mc, weights, state = _port_setup("invariant")
    batch = batch_for_frame(scene, FRAME, ref_idx=REF)
    ray_idx = _ray_idx()

    def port(params, b, idx):
        g, ld = step_gradients(params, b, weights, torch.from_numpy(idx), None, mc, "l1")
        return _np(g), {k: float(v) for k, v in ld.items()}

    jax_step = _jax_step(weights)
    params_np = params_to_numpy(state.params)
    out = {"port": port(state.params, batch, ray_idx), "jax": jax_step(params_np, ray_idx)}
    params64 = {g: {k: v.detach().double() for k, v in d.items()}
                for g, d in state.params.items()}
    batch64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
               for k, v in batch.items()}
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out["f64"] = port(params64, batch64, ray_idx)
    finally:
        torch.set_default_dtype(default)
    rng = np.random.default_rng(11)
    perms = [ray_idx[rng.permutation(len(ray_idx))] for _ in range(PERMUTATIONS)]
    out["permuted"] = {"port": [port(state.params, batch, p)[0] for p in perms],
                       "jax": [jax_step(params_np, p)[0] for p in perms]}
    return out


def test_the_float64_step_is_float64(steps):
    for d in steps["f64"][0].values():
        assert all(v.dtype == np.float64 for v in d.values())


@pytest.mark.parametrize("package", ["port", "jax"])
def test_float32_gradients_within_round_off_of_float64(steps, package):
    ref = steps["f64"][0]
    base = steps[package][0]
    # the package's own float32 step over orders of the same rays: only the sums
    # reorder, so what moves is round-off
    round_off = max(_blocks_dev(g, base, scale=ref) for g in steps["permuted"][package])
    dev = _blocks_dev(base, ref)
    print(f"{package}: {dev:.3g} of a block's largest entry from float64; "
          f"{round_off:.3g} between ray orders")
    assert dev <= 2.0 * round_off, (package, dev, round_off)
    # both within the tolerance tests/test_torch_parallel.py holds them to each other
    assert dev <= 3e-4, (package, dev)


def test_the_port_is_the_nearer(steps):
    ref, _ = steps["f64"]
    assert _blocks_dev(steps["port"][0], ref) <= _blocks_dev(steps["jax"][0], ref)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_loss_terms_within_round_off_of_float64(steps, package):
    ref = steps["f64"][1]
    got = steps[package][1]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=1e-7, err_msg=f"{package} {k}")
