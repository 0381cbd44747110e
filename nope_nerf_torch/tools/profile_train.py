"""Where a step's time goes on the card, eager and replayed from a captured
CUDA graph: `python3 -m nope_nerf_torch.tools.profile_train` from the root of
a checkout, on a machine with one NVIDIA GPU.

Sets up the train paths of chip_smoke.py at 188x621 with 1024 rays on the
4-frame synthetic scene (default config, learned poses) and profiles STEPS
steps of each twice: through Trainer(graphs=False), every operation
launched from the host, and through the replays of the captured step
(training/graphs.py). The paths: the fused step (K1, the dW kernel, K2),
the unfused step (depth_loss_type invariant: K3, K4 full), the hierarchical
step (n_importance 64: K5 twice, K6 full), the fern step (configs/LLFF/
fern.yaml's keys on chip_smoke.py's 756x1008 scene written to a temporary
directory and read through DataField: K1, K7 twice) and the test-time pose-optimisation
step (evaluation/pose_opt.py::PoseOptRun) on the fused route (K3, K4's
frozen variant) and the hierarchical one (K5 twice, K6's frozen variant).
For each: wall ms per step by the host clock (unprofiled), device busy ms
per step and the idle share from torch.profiler, cudaGraphLaunch and
cudaLaunchKernel calls per step, and the device time per call of each
hand-written kernel. Plain text; PERF.md quotes it.
"""

from __future__ import annotations

import dataclasses
import sys
import time

STEPS = 8
SEED = 0
RESOLUTION = (188, 621)
TRAIN_RAYS = 1024
N_IMPORTANCE = 64
DENSITY_SHIFT = -4.0   # keeps the seeded field's transmittance alive to the last sample
HOST_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
              "cudaStreamSynchronize")
# K1 and K4 full are both render_full_kernel (its LOSS and plain instances)
KERNELS = ("render_full_kernel", "render_fwd_kernel", "render_bwd_frozen_kernel",
           "point_mlp_fwd_kernel", "point_mlp_bwd_kernel", "point_mlp_bwd_frozen_kernel",
           "chain_reduce_kernel", "dw_sm90_kernel", "dw_reduce_kernel", "chamfer_bidir_sweep",
           "chamfer_bidir_finish", "chamfer_nearest_sweep", "chamfer_nearest_merge")


def _self_device_us(event) -> float:
    """An averaged event's own device time; the attribute was renamed between
    PyTorch releases."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    raise AttributeError("the profiler event carries no device time")


def _device_us(prof, needle: str) -> float:
    """Mean device microseconds per call of the kernels whose name holds `needle`."""
    events = [e for e in prof.key_averages() if needle in e.key]
    return sum(_self_device_us(e) for e in events) / max(sum(e.count for e in events), 1)


def profile_steps(torch, run, steps: int, label: str) -> dict:
    """run() performs `steps` steps: their wall time unprofiled (after one
    warm-up run), then the device's busy time, host API calls and the
    kernels' time per call from a profile of one more run. Prints one line
    and returns the numbers."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # device-side rows only: an operator's row repeats its kernels' time
    device_ms = sum(_self_device_us(e) for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / steps
    calls = {name: sum(e.count for e in ka if e.key == name) / steps for name in HOST_CALLS}
    kernels = {k: _device_us(prof, k) for k in KERNELS if any(k in e.key for e in ka)}
    print(f"{label}: {wall_ms:.3f} ms per step by the host clock; device busy {device_ms:.3f} ms "
          f"per step (idle share {1 - device_ms / wall_ms:.1%}); per step "
          + ", ".join(f"{v:g} {k}" for k, v in calls.items()))
    print("  device time per call: " + ", ".join(f"{k} {v:.0f} us" for k, v in kernels.items()))
    return {"wall_ms": wall_ms, "device_ms": device_ms, "calls": calls, "kernels_us": kernels}


def train_paths(torch, np, dev) -> None:
    """The fused, unfused and hierarchical train steps, eager and replayed."""
    from ..config import load_config
    from ..data import SceneData, epoch_order, make_synthetic_scene
    from ..training import ModelConfigs, Trainer, create_train_state

    h, w = RESOLUTION
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    order, refs = np.resize(order, STEPS), np.resize(refs, STEPS)
    base = {"training": {"n_training_points": TRAIN_RAYS},
            "pose": {"learn_pose": True, "init_pose": True}}
    paths = {"fused train step": {},
             "unfused train step (depth_loss_type invariant)":
                 {"training": {"n_training_points": TRAIN_RAYS, "depth_loss_type": "invariant"}},
             f"hierarchical train step (n_importance {N_IMPORTANCE})":
                 {"rendering": {"n_importance": N_IMPORTANCE}}}
    for label, extra in paths.items():
        cfg = load_config(overrides={**base, **extra})
        mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
        for graphs in (False, True):
            state = create_train_state(SEED, mc, init_c2w=scene.c2ws_gt, device=dev)
            trainer = Trainer(cfg, mc, graphs=graphs)
            profile_steps(torch, lambda: trainer.run_steps(state, scene, order, refs, epoch=0,
                                                           scheduling_start=10000),
                          STEPS, f"{label}, {'replayed' if graphs else 'eager'}")
            trainer.release_graphs()
            torch.cuda.empty_cache()


def fern_path(torch, np, dev) -> None:
    """The fern train step from a scene on disk, eager and replayed: the
    scene and config chip_smoke.py's phase 7 writes and reads (this file
    runs from the root of a checkout, beside chip_smoke.py)."""
    import os
    import tempfile
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from ..cli.train import build_scene
    from ..training import ModelConfigs, Trainer, create_train_state

    with tempfile.TemporaryDirectory() as root:
        chip_smoke.write_disk_scenes(np, root)
        cfg = chip_smoke.disk_config("fern", root)
        scene = build_scene(cfg, False).to_device(dev)
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    order = np.resize(np.arange(scene.n_frames), STEPS)
    refs = np.where(order == scene.n_frames - 1, order - 1, order + 1)
    for graphs in (False, True):
        state = create_train_state(SEED, mc, device=dev)
        trainer = Trainer(cfg, mc, graphs=graphs)
        profile_steps(torch, lambda: trainer.run_steps(state, scene, order, refs, epoch=0,
                                                       scheduling_start=10000),
                      STEPS, f"fern train step (756x1008 from disk), "
                             f"{'replayed' if graphs else 'eager'}")
        trainer.release_graphs()
        torch.cuda.empty_cache()


def pose_opt_paths(torch, np, dev) -> None:
    """One test view's pose-optimisation step at 188x621, fused and
    hierarchical, eager and replayed."""
    from ..config import load_config
    from ..data import SceneData, make_synthetic_scene
    from ..evaluation.pose_opt import PoseOptRun
    from ..models.nerf import init_nerf_params
    from ..training import ModelConfigs

    h, w = RESOLUTION
    view = SceneData.from_dict(make_synthetic_scene(n_frames=1, h=h, w=w))
    mc = ModelConfigs.from_cfg(load_config(overrides={}), num_cams=1)
    nerf = init_nerf_params(mc.nerf, torch.Generator().manual_seed(5), device=dev)
    nerf["density_b"] = nerf["density_b"] + DENSITY_SHIFT
    routes = {"fused": mc.render,
              "hierarchical": dataclasses.replace(mc.render, n_importance=N_IMPORTANCE)}
    for route, rcfg in routes.items():
        for graphs in (False, True):
            run = PoseOptRun(nerf, None, view, mc.nerf, rcfg, init_c2ws=view.c2ws_gt,
                             n_points=TRAIN_RAYS, seed=SEED, device=dev, graphs=graphs)
            run.rate.fill_(1e-3)

            def steps():
                for _ in range(STEPS):
                    run.step()
            profile_steps(torch, steps, STEPS,
                          f"pose-opt step ({route}), {'replayed' if graphs else 'eager'}")


def main() -> int:
    import subprocess
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_train: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    from ..ops._build import LIBRARIES, build_all
    from ..training import graphs   # noqa: F401  (imports every kernel's library)
    t0 = time.perf_counter()
    build_all(LIBRARIES)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    train_paths(torch, np, dev)
    fern_path(torch, np, dev)
    pose_opt_paths(torch, np, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
