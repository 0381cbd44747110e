"""Where a train step's time goes on the card: `python3 -m nope_nerf_torch.tools.profile_train`
from the root of a checkout, on a machine with one NVIDIA GPU.

Sets up chip_smoke.py's train path (default config, 188x621 4-frame
synthetic scene, 1024 rays) and profiles 4 steps of Trainer.run_steps with
torch.profiler: device time by kernel, host API calls (launches, copies,
blocking syncs) and device kernels per step, and the device's idle share.
Then the same for the unfused train step (depth_loss_type invariant) and
for a test-time pose-optimisation step, both through render_fwd and
render_bwd. Prints plain text; PERF.md quotes it.
"""

from __future__ import annotations

import os
import sys
import time

STEPS = 4
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


# K1 and K4 full are both render_full_kernel (its LOSS and plain instances)
KERNELS = ("render_full_kernel", "render_bwd_frozen_kernel", "render_fwd_kernel",
           "chain_reduce_kernel", "dw_sm90_kernel", "dw_reduce_kernel", "chamfer_bidir_sweep",
           "chamfer_bidir_finish")


def profile_steps(torch, run, steps: int, label: str, table: bool = False) -> None:
    """run() performs `steps` steps: their wall time unprofiled, then device
    time by kernel, host API calls and the device's idle share from a profile."""
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
    if table:
        print(ka.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=56))
    # device-side rows only: an operator's row repeats its kernels' time
    device_ms = sum(_self_device_us(e) for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / steps
    calls = {name: sum(e.count for e in ka if e.key == name) / steps
             for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    print(f"{label}, unprofiled: {wall_ms:.2f} ms by the host clock; device busy "
          f"{device_ms:.2f} ms per step (idle share {1 - device_ms / wall_ms:.1%}); per step "
          + ", ".join(f"{v:.0f} {k}" for k, v in calls.items()))
    print("per call: " + ", ".join(f"{k} {_device_us(prof, k):.0f} us" for k in KERNELS
                                   if any(k in e.key for e in ka)))


def profile_paths(torch, np, dev) -> None:
    """The fused train step, the unfused one (depth_loss_type invariant:
    render_fwd + render_bwd) and one test-time pose-optimisation step."""
    import chip_smoke
    from ..evaluation.pose_opt import pose_opt_step
    from ..models.nerf import init_nerf_params
    from ..models.poses import PoseConfig, init_pose_params
    from ..training.state import init_adam
    *_, trainer, state, scene, order, refs, mc = chip_smoke.run_train_path(torch, np, dev)
    profile_steps(torch, lambda: trainer.run_steps(state, scene, order[:STEPS], refs[:STEPS],
                                                   epoch=0, scheduling_start=10000),
                  STEPS, "train step", table=True)
    _, utrainer, ustate, uscene, uorder, urefs = chip_smoke.run_unfused_steps(torch, np, dev)
    profile_steps(torch, lambda: utrainer.run_steps(ustate, uscene, uorder[:STEPS], urefs[:STEPS],
                                                    epoch=0, scheduling_start=10000),
                  STEPS, "unfused train step (depth_loss_type invariant)")

    gen = torch.Generator().manual_seed(5)
    nerf = init_nerf_params(mc.nerf, gen, device=dev)
    nerf["density_b"] = nerf["density_b"] + chip_smoke.DENSITY_SHIFT
    pcfg = PoseConfig(num_cams=1, use_init_c2w=True)
    pose = init_pose_params(pcfg, scene.c2ws_gt[:1], device=dev)
    adam = init_adam(pose)
    h, w = scene.imgs.shape[1:3]
    ray_idx = torch.randperm(h * w, device=dev)[:chip_smoke.TRAIN_RAYS]

    def pose_steps():
        for _ in range(STEPS):
            pose_opt_step(pose, adam, nerf, None, scene.imgs[0], 0, scene.K, ray_idx, 1e-3, pcfg,
                          None, mc.nerf, mc.render)
    profile_steps(torch, pose_steps, STEPS, "pose-opt step")


def main() -> int:
    import subprocess
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_train: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())   # chip_smoke.py sits at the root of the checkout
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    profile_paths(torch, np, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
