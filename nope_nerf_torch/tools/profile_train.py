"""Where a train step's time goes on the card: `python3 -m nope_nerf_torch.tools.profile_train`
from the root of a checkout, on a machine with one NVIDIA GPU.

1. Sets up chip_smoke.py's train path (default config, 188x621 4-frame
   synthetic scene, 1024 rays) and profiles 4 steps of Trainer.run_steps with
   torch.profiler: device time by kernel, host API calls (launches, copies,
   blocking syncs) and device kernels per step, and the device's idle share.
   Then the same for the unfused train step (depth_loss_type invariant) and
   for a test-time pose-optimisation step, both through render_fwd and
   render_bwd.
2. Times the train kernel at 1024 rays x 128 samples beside two variants of
   its source built on the spot: `no_dw_traffic` keeps the dW products but
   neither reads nor writes the per-CTA partial buffer, `store_only` writes it
   without reading. The differences are what the partial sums' trip through
   device memory costs. (The variants' gradients are wrong by construction:
   they exist to be timed.)
Prints plain text; PERF.md quotes it.
"""

from __future__ import annotations

import os
import sys
import time

STEPS = 4
_RMW = ("        float2 v0 = *p0, v1 = *p1;\n        v0.x += acc[a][b][0];\n"
        "        v0.y += acc[a][b][1];\n        v1.x += acc[a][b][2];\n"
        "        v1.y += acc[a][b][3];\n        *p0 = v0;\n        *p1 = v1;")
_VARIANTS = {
    "as_built": (None, None),
    # a store the compiler cannot drop and the data never takes
    "no_dw_traffic": (_RMW, "        if (acc[a][b][0] == 1234.5f) { *p0 = make_float2(acc[a][b][0], "
                            "acc[a][b][1]); *p1 = make_float2(acc[a][b][2], acc[a][b][3]); }"),
    "store_only": ("        float2 v0 = *p0, v1 = *p1;",
                   "        float2 v0 = make_float2(0.f, 0.f), v1 = v0;"),
}


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


KERNELS = ("render_train_kernel", "render_bwd_kernel", "render_fwd_kernel",
           "reduce_partials_kernel", "chamfer_bidir_kernel")


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


def time_variants(torch, dev) -> None:
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from ..models.nerf import NerfConfig, init_nerf_params
    from ..ops import fused_render as F
    from ..ops._build import BUILD_DIR, CSRC_DIR, CudaLibrary, build_all
    # the products the variants patch live in the shared header: inline it
    include = '#include "nerf_bwd.cuh"'
    src = (CSRC_DIR / "render_train.cu").read_text()
    if include not in src:
        raise RuntimeError("render_train.cu no longer includes nerf_bwd.cuh")
    src = src.replace(include, (CSRC_DIR / "nerf_bwd.cuh").read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, (old, new) in _VARIANTS.items():
        text = src if old is None else src.replace(old, new)
        if old is not None and text == src:
            raise RuntimeError(f"variant {name}: its pattern is not in render_train.cu")
        path = BUILD_DIR / f"render_train_{name}.cu"
        path.write_text(text)
        libs[name] = CudaLibrary(str(path), F._setup_train)
    build_all(list(libs.values()))
    gen = torch.Generator().manual_seed(3)
    cfg = NerfConfig(hidden_dim=256, use_pallas=True)
    params = init_nerf_params(cfg, gen, device=dev)
    params["density_b"] = params["density_b"] + chip_smoke.DENSITY_SHIFT
    rays, z, tgt = chip_smoke.train_inputs(torch, dev, gen, chip_smoke.TRAIN_RAYS)
    as_built = F.RENDER_TRAIN
    try:
        for name, lib in libs.items():
            F.RENDER_TRAIN = lib
            for _ in range(2):
                F._train_cuda(params, rays, z, tgt, cfg, False, 1, False)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    F._train_cuda(params, rays, z, tgt, cfg, False, 1, False)
                torch.cuda.synchronize()
            print(f"render_train_kernel, {chip_smoke.TRAIN_RAYS} rays x 128, variant {name}: "
                  f"{_device_us(prof, 'render_train_kernel'):.0f} us")
    finally:
        F.RENDER_TRAIN = as_built


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
    time_variants(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
