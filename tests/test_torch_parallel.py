"""The multi-device layer of the port (nope_nerf_torch/parallel/ and the mesh
argument of the train step) on the CPU: two gloo processes joined by a
file:// rendezvous, held against the port's one-process step and against the
JAX package's compute_step_loss on a 2-device mesh of the conftest's virtual
CPU devices.

The ranks are this file run as a script,
`python tests/test_torch_parallel.py <job> <rank> <world> <rendezvous file> <work dir>`.
They import the port only (jax and nope_nerf_tpu are blocked in sys.modules)
and leave what they computed in the work directory as pickles of numpy
arrays. One run of both ranks (the `ranks` fixture) serves every test below
that reads a rank's results.

Scene: the synthetic plane scene at 24x32, 4 frames, 64 rays (32 a rank),
learned poses and distortions, the default losses (rgb, depth, Chamfer,
photometric warp). The float32 paths (unfused l1, invariant depth): hidden
width 32, 16 samples, nerf_apply in float32. The fused path: width 128, 128
samples, K1's plain version (bf16 operands, as the kernel). The ray indices
are pinned and the stratified jitter is off wherever JAX is compared (its
mesh step splits the key per device, the port draws the global jitter on
every rank); the draw test and the Adam steps turn the jitter on and let the
ranks draw from their generators.

Tolerances. Sharded against one process, in either package: JAX's own
(tests/test_parallel.py), loss terms rtol 2e-5, gradients 5e-5 of each
block's largest entry. The port against JAX: the same on the unfused l1
path; on the invariant-depth path gradients 3e-4, since the one-process port
already differs from the one-process JAX step by up to 1.6e-4 of a block's
largest entry there: float32 round-off, the JAX package's the larger
(tests/test_torch_invariant_depth.py holds both against the step in
float64; sharding adds nothing to it); on the fused path the trainer test's bf16 tolerances
(2e-3 loss, 2e-2 gradients), since the two packages round the kernel's
operands differently. Params after
3 Adam steps against one process: atol 1e-5, as the trainer test's (Adam
divides by sqrt(nu)). Between the ranks, and for the frame, the checkpoint
resume and cli.train: bit-equal.
"""

import dataclasses
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
SEED = 0
H, W, N_FRAMES, N_RAYS = 24, 32, 4, 64
FRAME, REF = 1, 2
KINDS = ("unfused", "invariant", "fused")
ADAM_FRAMES = [(0, 1), (3, 2), (1, 2)]
RESOLUTIONS = [(24, 32), (23, 32)]


def _overrides(kind: str) -> dict:
    fused = kind == "fused"
    return {
        "model": {"hidden_dim": 128 if fused else 32},
        "rendering": {"num_points": 128 if fused else 16},
        "training": {"n_training_points": N_RAYS,
                     "depth_loss_type": "invariant" if kind == "invariant" else "l1"},
        "pose": {"learn_pose": True, "init_pose": True},
        "tpu": {"use_pallas_renderer": fused,
                "compute_dtype": "bfloat16" if fused else "float32"},
    }


def _cli_overrides(out_dir, **tpu) -> dict:
    return {
        "model": {"hidden_dim": 32},
        "rendering": {"num_points": 8},
        "training": {"n_training_points": 64, "out_dir": str(out_dir), "print_every": 0,
                     "checkpoint_every": 0, "backup_every": 0, "visualize_every": 0,
                     "vis_reprojection_every": 0, "eval_pose_every": 1, "eval_img_every": 1,
                     "vis_geo": False},
        "pose": {"learn_pose": True, "init_pose": True},
        "tpu": tpu,
    }


def _ray_idx() -> np.ndarray:
    return np.random.default_rng(7).permutation(H * W)[:N_RAYS].astype(np.int64)


def _port_setup(kind: str, noise: bool = False):
    """(cfg, scene, mc, trainer weights, state) of the port, on the CPU."""
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import SceneData, make_synthetic_scene
    from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
    cfg = load_config(overrides=_overrides(kind))
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=N_FRAMES, h=H, w=W)).to_device("cpu")
    mc = dataclasses.replace(ModelConfigs.from_cfg(cfg, N_FRAMES), stratified_noise=noise)
    state = create_train_state(SEED, mc, init_c2w=scene.c2ws_gt, device="cpu")
    return cfg, scene, mc, Trainer(cfg, mc).weights_at(0, 10000), state


def _numpy_tree(tree):
    return {g: {k: v.detach().cpu().numpy() for k, v in d.items()} for g, d in tree.items()}


def _flat_state(state) -> dict:
    out = {"generator": state.generator.get_state().numpy(), "it": np.int64(state.it)}
    for g, d in state.params.items():
        out[f"count/{g}"] = np.int64(state.opt_state[g].count)
        for k, v in d.items():
            out[f"params/{g}/{k}"] = v.detach().cpu().numpy()
            out[f"mu/{g}/{k}"] = state.opt_state[g].mu[k].cpu().numpy()
            out[f"nu/{g}/{k}"] = state.opt_state[g].nu[k].cpu().numpy()
    return out


def _bit_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                                    for k in a)


# ---- the ranks ---------------------------------------------------------------------------

def _dump(work: Path, name: str, rank: int, obj) -> None:
    with open(work / f"{name}_{rank}.pkl", "wb") as f:
        pickle.dump(obj, f)


def _collective_fn(w, w2, x, c, mesh=None):
    """A loss through all three collectives (one process: mesh None): a psum'd
    sum over this rank's rows, squared; a gathered per-row term weighted by a
    replicated c; and a replicated term on w alone."""
    from nope_nerf_torch.parallel import all_gather_tiled, psum, pvary
    if mesh is None:
        s, g = torch.tanh(x @ w).sum(), torch.tanh(x @ w2)
    else:
        per = x.shape[0] // mesh.size
        xs = x[mesh.rank * per:(mesh.rank + 1) * per]
        s = psum(torch.tanh(xs @ pvary(w, mesh)).sum(), mesh)
        g = all_gather_tiled(torch.tanh(xs @ pvary(w2, mesh)), mesh)
    return s * s + (g * c).sum() + (w * w).sum()


def _collective_inputs():
    gen = torch.Generator().manual_seed(3)
    return [torch.randn(shape, generator=gen, dtype=torch.float64)
            for shape in ((5, 3), (5, 2), (8, 5), (8, 2))]


def _job_collectives(mesh, work):
    w, w2, x, c = _collective_inputs()
    w.requires_grad_(True)
    w2.requires_grad_(True)
    loss = _collective_fn(w, w2, x, c, mesh)
    gw, gw2 = torch.autograd.grad(loss, [w, w2])
    _dump(work, "collectives", mesh.rank, {"loss": loss.item(), "w": gw.numpy(),
                                           "w2": gw2.numpy()})


def _job_rank_zero_first(mesh, work):
    """Rank 0 writes a file inside the block, after a pause; rank 1 looks for
    it as its block starts."""
    from nope_nerf_torch.parallel.multihost import rank_zero_first
    marker = work / "rank0_wrote"
    with rank_zero_first(mesh):
        if mesh.rank == 0:
            time.sleep(0.5)
            marker.write_text("0")
        seen = marker.exists()
    _dump(work, "rank_zero_first", mesh.rank, seen)


def _job_steps(mesh, work):
    from nope_nerf_torch.data import batch_for_frame
    from nope_nerf_torch.training.trainer import _sample_rays, step_gradients
    out = {}
    for kind in KINDS:
        cfg, scene, mc, weights, state = _port_setup(kind)
        g, ld = step_gradients(state.params, batch_for_frame(scene, FRAME, ref_idx=REF), weights,
                               torch.from_numpy(_ray_idx()), None, mc, "l1", mesh=mesh)
        out[kind] = (_numpy_tree(g), {k: float(v) for k, v in ld.items()})
    # the draws: jitter on, everything drawn from the state's generator
    cfg, scene, mc, weights, state = _port_setup("unfused", noise=True)
    ray_idx = _sample_rays(state.generator, H * W, N_RAYS, None, False)
    g, ld = step_gradients(state.params, batch_for_frame(scene, FRAME, ref_idx=REF), weights,
                           ray_idx, state.generator, mc, "l1", mesh=mesh)
    out["draws"] = (_numpy_tree(g), {k: float(v) for k, v in ld.items()},
                    ray_idx.numpy(), state.generator.get_state().numpy())
    _dump(work, "steps", mesh.rank, out)


def _adam_steps(trainer, state, scene, frames):
    from nope_nerf_torch.data import batch_for_frame
    for idx, ref in frames:
        state, _ = trainer.step(state, batch_for_frame(scene, idx, ref_idx=ref), 0, 10000)
    return state


def _job_adam(mesh, work):
    from nope_nerf_torch.training import Trainer
    cfg, scene, mc, _, state = _port_setup("unfused", noise=True)
    state = _adam_steps(Trainer(cfg, mc, mesh=mesh), state, scene, ADAM_FRAMES)
    _dump(work, "adam", mesh.rank, _flat_state(state))


def _job_render(mesh, work):
    from nope_nerf_torch.data import batch_for_frame
    from nope_nerf_torch.training import Trainer
    cfg, scene, mc, _, state = _port_setup("unfused")
    trainer = Trainer(cfg, mc, mesh=mesh)
    batch = batch_for_frame(scene, FRAME, ref_idx=REF)
    _dump(work, "render", mesh.rank,
          [trainer.render_frame_multihost(state, batch, res, chunk=100) for res in RESOLUTIONS])


def _job_checkpoint(mesh, work):
    """2 steps, a checkpoint (rank 1 saves first, then rank 0), a restore on
    both ranks and 2 more steps, against 4 steps straight."""
    import torch.distributed as dist
    from nope_nerf_torch.training import Trainer
    from nope_nerf_torch.training.checkpoints import load_checkpoint, save_checkpoint
    cfg, scene, mc, _, state = _port_setup("unfused", noise=True)
    trainer = Trainer(cfg, mc, mesh=mesh)
    frames = ADAM_FRAMES + [(2, 1)]
    state = _adam_steps(trainer, state, scene, frames[:2])
    ckpt_dir = str(work / "ckpt")
    seen = {}
    for writer in (1, 0):
        if mesh.rank == writer:
            path = save_checkpoint(ckpt_dir, "model.ckpt", state, {"epoch_it": 1})
            seen[f"path after rank {writer}"] = path
        dist.barrier()
        seen[f"exists after rank {writer}"] = os.path.exists(os.path.join(ckpt_dir, "model.ckpt"))
    _, _, _, _, fresh = _port_setup("unfused", noise=True)
    resumed, scalars = load_checkpoint(ckpt_dir, "model.ckpt", fresh)
    resumed = _adam_steps(trainer, resumed, scene, frames[2:])
    _, _, _, _, straight = _port_setup("unfused", noise=True)
    straight = _adam_steps(trainer, straight, scene, frames)
    _dump(work, "checkpoint", mesh.rank, {
        **seen, "scalars": scalars, "resumed": _flat_state(resumed),
        "equal": _bit_equal(_flat_state(resumed), _flat_state(straight))})


def _job_cli(mesh, work):
    """cli.train with tpu.mesh_shape [2]: 2 epochs straight, and 1 epoch then a
    resume to 2; which ranks write a checkpoint; a mesh_shape the group does
    not match raises."""
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.training import checkpoints
    writes = []
    real_write = checkpoints._write

    def counting_write(out_dir, filename, payload):
        writes.append(filename)
        return real_write(out_dir, filename, payload)

    checkpoints._write = counting_write
    try:
        straight, _, _ = train(load_config(overrides=_cli_overrides(work / "cli_a", mesh_shape=[2])),
                               synthetic=True, max_epochs=2, device="cpu")
        cfg_b = load_config(overrides=_cli_overrides(work / "cli_b", mesh_shape=[2]))
        train(cfg_b, synthetic=True, max_epochs=1, device="cpu")
        resumed, _, _ = train(cfg_b, synthetic=True, max_epochs=2, device="cpu")
    finally:
        checkpoints._write = real_write
    try:
        train(load_config(overrides=_cli_overrides(work / "cli_c", mesh_shape=[4])),
              synthetic=True, max_epochs=1, device="cpu")
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    _dump(work, "cli", mesh.rank, {"writes": writes, "straight": _flat_state(straight),
                                   "equal": _bit_equal(_flat_state(resumed),
                                                       _flat_state(straight)),
                                   "mismatch": mismatch,
                                   "c_exists": os.path.exists(work / "cli_c")})


JOBS = {"all": (_job_collectives, _job_rank_zero_first, _job_steps, _job_adam, _job_render, _job_checkpoint,
                _job_cli)}


def _rank_main(argv) -> None:
    job, rank, world, rendezvous, work = argv[0], int(argv[1]), int(argv[2]), argv[3], Path(argv[4])
    for name in ("jax", "jaxlib", "nope_nerf_tpu"):
        sys.modules[name] = None
    sys.path.insert(0, str(REPO))
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=3 if job == "timeout" else 120))
    from nope_nerf_torch.parallel import make_mesh
    from nope_nerf_torch.parallel.sharding import all_reduce
    mesh = make_mesh(world, device="cpu")
    if job in ("crash", "timeout") and rank == 1:
        if job == "crash":
            sys.exit(3)
        time.sleep(60)                      # never joins the collective
    if job in ("crash", "timeout"):
        all_reduce(torch.ones(4), mesh)     # a failed peer: this raises
        return
    for fn in JOBS[job]:
        fn(mesh, work)
    dist.destroy_process_group()


def _run_ranks(job: str, work: Path, timeout_s: float = 240):
    from nope_nerf_torch.parallel.multihost import run_ranks
    work.mkdir(parents=True, exist_ok=True)
    rendezvous = work / "rendezvous"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmds = [[sys.executable, __file__, job, str(r), str(WORLD), str(rendezvous), str(work)]
            for r in range(WORLD)]
    return run_ranks(cmds, timeout_s, env=env, cwd=str(REPO))


def _load(work: Path, name: str):
    out = []
    for r in range(WORLD):
        with open(work / f"{name}_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
    sys.exit(0)


# ---- the tests ---------------------------------------------------------------------------

import pytest  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    outs = _run_ranks("all", work)
    return work, outs


def _assert_blocks(got, ref, rel, what):
    assert set(got) == set(ref), what
    for g in ref:
        assert set(got[g]) == set(ref[g]), (what, g)
        for k in ref[g]:
            r = np.asarray(ref[g][k])
            err = float(np.max(np.abs(np.asarray(got[g][k]) - r))) if r.size else 0.0
            assert err <= rel * float(np.max(np.abs(r))) + 1e-7, f"{what} {g}/{k}: {err}"


def _assert_loss_dict(got, ref, rtol, what):
    assert set(got) == set(ref), what
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, atol=1e-7,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("n,pc,pi", [(n, pc, pi) for n, pc in ((64, 2), (1024, 4), (24, 3),
                                                             (23, 2), (23, 4), (3, 4))
                                     for pi in range(pc)])
def test_multihost_helpers_match_jax(n, pc, pi):
    from nope_nerf_tpu.parallel import multihost as jmh
    from nope_nerf_torch.parallel import multihost as mh
    assert mh.host_image_tiles(n, pi, pc) == jmh.host_image_tiles(n, pi, pc)
    if n % pc == 0:
        assert mh.host_ray_slice(n, pi, pc) == jmh.host_ray_slice(n, pi, pc)
    else:
        with pytest.raises(ValueError, match="divide"):
            mh.host_ray_slice(n, pi, pc)
    for shuffle in (True, False):
        np.testing.assert_array_equal(mh.host_frame_schedule(n, pi, 5 + pc, shuffle),
                                      jmh.host_frame_schedule(n, pi, 5 + pc, shuffle))


def test_helpers_default_to_one_process():
    import torch.distributed as dist
    from nope_nerf_torch.parallel import (globalize_replicated, host_image_tiles,
                                          host_ray_slice, process_count, process_index)
    assert not dist.is_initialized()
    assert (process_index(), process_count()) == (0, 1)
    assert host_ray_slice(64) == (0, 64) and host_image_tiles(23) == (0, 23)
    tree = {"a": torch.ones(3)}
    assert globalize_replicated(tree, None) is tree


def test_mesh_refuses_what_it_cannot_build():
    from nope_nerf_torch.parallel import make_mesh
    with pytest.raises(NotImplementedError, match="1-axis"):
        make_mesh(2, device="cpu", axis_names=("data", "model"))
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node 2"):
        make_mesh(2, device="cpu")          # this process has no group of 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)


def test_collective_gradients_match_one_process(ranks):
    work, _ = ranks
    w, w2, x, c = _collective_inputs()
    w.requires_grad_(True)
    w2.requires_grad_(True)
    loss = _collective_fn(w, w2, x, c)
    gw, gw2 = torch.autograd.grad(loss, [w, w2])
    for r, got in enumerate(_load(work, "collectives")):
        np.testing.assert_allclose(got["loss"], loss.item(), rtol=1e-12, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["w"], gw.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got["w2"], gw2.numpy(), rtol=1e-12, atol=1e-12)


def test_rank_zero_first_runs_rank_0_first(ranks):
    work, _ = ranks
    assert _load(work, "rank_zero_first") == [True, True]


def _port_one_process(kind):
    from nope_nerf_torch.data import batch_for_frame
    from nope_nerf_torch.training.trainer import step_gradients
    cfg, scene, mc, weights, state = _port_setup(kind)
    g, ld = step_gradients(state.params, batch_for_frame(scene, FRAME, ref_idx=REF), weights,
                           torch.from_numpy(_ray_idx()), None, mc, "l1")
    return _numpy_tree(g), {k: float(v) for k, v in ld.items()}, state, weights


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_step_matches_one_process(ranks, kind):
    work, _ = ranks
    g_ref, ld_ref, _, _ = _port_one_process(kind)
    results = _load(work, "steps")
    for r, res in enumerate(results):
        g, ld = res[kind]
        _assert_loss_dict(ld, ld_ref, 2e-5, f"{kind} rank {r}")
        _assert_blocks(g, g_ref, 5e-5, f"{kind} rank {r}")
    # the ranks hold the same bytes
    for grp, d in results[0][kind][0].items():
        for k, v in d.items():
            np.testing.assert_array_equal(v, results[1][kind][0][grp][k])


def test_sharded_step_draws_what_one_process_draws(ranks):
    """Jitter on, every draw from the state's generator: both ranks draw the
    global ray indices and jitter, and end with the generator state the
    one-process step leaves."""
    from nope_nerf_torch.data import batch_for_frame
    from nope_nerf_torch.training.trainer import _sample_rays, step_gradients
    work, _ = ranks
    cfg, scene, mc, weights, state = _port_setup("unfused", noise=True)
    ray_idx = _sample_rays(state.generator, H * W, N_RAYS, None, False)
    g_ref, ld_ref = step_gradients(state.params, batch_for_frame(scene, FRAME, ref_idx=REF),
                                   weights, ray_idx, state.generator, mc, "l1")
    for r, res in enumerate(_load(work, "steps")):
        g, ld, idx, gen_state = res["draws"]
        np.testing.assert_array_equal(idx, ray_idx.numpy())
        np.testing.assert_array_equal(gen_state, state.generator.get_state().numpy())
        _assert_loss_dict(ld, {k: float(v) for k, v in ld_ref.items()}, 2e-5, f"rank {r}")
        _assert_blocks(g, _numpy_tree(g_ref), 5e-5, f"rank {r}")


def _jax_mesh_step(kind, params_np, weights):
    import functools

    import jax
    import jax.numpy as jnp

    from nope_nerf_tpu.config import load_config as jload
    from nope_nerf_tpu.data import SceneData as JScene, batch_for_frame as jbatch
    from nope_nerf_tpu.data import make_synthetic_scene as jscene
    from nope_nerf_tpu.parallel import make_mesh as jmesh
    from nope_nerf_tpu.training import ModelConfigs as JModelConfigs
    from nope_nerf_tpu.training.trainer import compute_step_loss
    cfg = jload(overrides=_overrides(kind))
    scene = JScene.from_dict(dict(jscene(n_frames=N_FRAMES, h=H, w=W)))
    mc = dataclasses.replace(JModelConfigs.from_cfg(cfg, N_FRAMES), stratified_noise=False)
    batch = {k: jnp.asarray(v) for k, v in jbatch(scene, FRAME, ref_idx=REF).items()}
    w = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
    params = jax.tree.map(jnp.asarray, params_np)
    vg = jax.jit(jax.value_and_grad(functools.partial(
        compute_step_loss, mc=mc, rgb_loss_type="l1", mesh=jmesh(2)), has_aux=True))
    ray_idx = jnp.asarray(_ray_idx().astype(np.int32))
    if kind == "fused":
        from jax.experimental.pallas import tpu as pltpu
        with pltpu.force_tpu_interpret_mode():
            (_, ld), g = vg(params, batch, w, ray_idx, jax.random.key(7))
    else:
        (_, ld), g = vg(params, batch, w, ray_idx, jax.random.key(7))
    return jax.tree.map(np.asarray, g), {k: float(v) for k, v in ld.items()}


def _check_against_jax(ranks, kind, loss_rtol, grad_rel):
    from nope_nerf_torch.convert import params_to_numpy
    work, _ = ranks
    _, _, state, weights = _port_one_process(kind)
    g_ref, ld_ref = _jax_mesh_step(kind, params_to_numpy(state.params), weights)
    for r, res in enumerate(_load(work, "steps")):
        g, ld = res[kind]
        _assert_loss_dict(ld, ld_ref, loss_rtol, f"{kind} rank {r} vs JAX")
        _assert_blocks(g, g_ref, grad_rel, f"{kind} rank {r} vs JAX")


@pytest.mark.parametrize("kind", ["unfused", "invariant"])
def test_sharded_step_matches_jax_mesh_step(ranks, kind):
    _check_against_jax(ranks, kind, 2e-5, 5e-5 if kind == "unfused" else 3e-4)


@pytest.mark.slow
def test_sharded_fused_step_matches_jax_mesh_step(ranks):
    """JAX's train kernel in interpret mode: slow."""
    _check_against_jax(ranks, "fused", 2e-3, 2e-2)


def test_ranks_stay_equal_over_adam_steps(ranks):
    from nope_nerf_torch.training import Trainer
    work, _ = ranks
    got = _load(work, "adam")
    assert _bit_equal(got[0], got[1])
    cfg, scene, mc, _, state = _port_setup("unfused", noise=True)
    ref = _flat_state(_adam_steps(Trainer(cfg, mc), state, scene, ADAM_FRAMES))
    assert set(got[0]) == set(ref)
    for k, v in ref.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got[0][k], v, rtol=0, atol=1e-5, err_msg=k)
        elif not k.startswith(("mu/", "nu/")):
            np.testing.assert_array_equal(got[0][k], v, err_msg=k)


def test_render_frame_multihost_equals_render_frame(ranks):
    from nope_nerf_torch.data import batch_for_frame
    from nope_nerf_torch.training import Trainer
    work, _ = ranks
    cfg, scene, mc, _, state = _port_setup("unfused")
    batch = batch_for_frame(scene, FRAME, ref_idx=REF)
    frames = _load(work, "render")
    for i, res in enumerate(RESOLUTIONS):
        ref = Trainer(cfg, mc).render_frame(state, batch, res, chunk=100)
        for r in range(WORLD):
            assert frames[r][i]["rgb"].shape == res + (3,)
            np.testing.assert_array_equal(frames[r][i]["rgb"], ref["rgb"])
            np.testing.assert_array_equal(frames[r][i]["depth"], ref["depth"])


def test_checkpoint_written_by_rank_0_and_resume_bit_equal(ranks):
    work, _ = ranks
    got = _load(work, "checkpoint")
    path = str(work / "ckpt" / "model.ckpt")
    assert got[1]["path after rank 1"] == path and got[0]["path after rank 0"] == path
    for r in range(WORLD):
        assert got[r]["exists after rank 1"] is False     # rank 1 wrote nothing
        assert got[r]["exists after rank 0"] is True
        assert got[r]["scalars"] == {"epoch_it": 1}
        assert got[r]["equal"] is True                     # 2 + 2 steps == 4 straight
    assert _bit_equal(got[0]["resumed"], got[1]["resumed"])


def test_cli_train_with_mesh_shape(ranks):
    work, _ = ranks
    got = _load(work, "cli")
    assert got[1]["writes"] == []
    assert got[0]["writes"] and set(got[0]["writes"]) <= {"model.ckpt", "model_best.ckpt"}
    assert os.path.exists(work / "cli_b" / "model.ckpt")
    for r in range(WORLD):
        assert got[r]["equal"] is True                     # 1 epoch + resume == 2 straight
        assert "torch.distributed.run --nproc_per_node 4" in got[r]["mismatch"]
        assert got[r]["c_exists"] is False                 # refused before anything ran
    assert _bit_equal(got[0]["straight"], got[1]["straight"])
    assert int(got[0]["straight"]["it"]) == 15             # 2 epochs of the 8-frame scene


@pytest.mark.parametrize("job", ["crash", "timeout"])
def test_failed_rank_fails_the_run(tmp_path, job):
    """A rank that exits non-zero, or a collective that times out: run_ranks
    stops the peer and raises; nothing hangs."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="exited with code") as err:
        _run_ranks(job, tmp_path, timeout_s=120)
    assert time.perf_counter() - t0 < 60
    if job == "crash":
        assert "rank 1 exited with code 3" in str(err.value)
