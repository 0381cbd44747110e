"""Where a train step's time goes on the card: `python3 -m nope_nerf_torch.tools.profile_train`
from the root of a checkout, on a machine with one NVIDIA GPU.

1. Sets up chip_smoke.py's train path (default config, 188x621 4-frame
   synthetic scene, 1024 rays) and profiles 4 steps of Trainer.run_steps with
   torch.profiler: device time by kernel, host API calls (launches, copies,
   blocking syncs) and device kernels per step, and the device's idle share.
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


def profile_step(torch, np, dev) -> None:
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    *_, trainer, state, scene, order, refs, _mc = chip_smoke.run_train_path(torch, np, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run_steps(state, scene, order[:STEPS], refs[:STEPS], epoch=0, scheduling_start=10000)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_steps(state, scene, order[:STEPS], refs[:STEPS], epoch=0,
                          scheduling_start=10000)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=56))
    # device-side rows only: an operator's row repeats its kernels' time
    device_ms = sum(_self_device_us(e) for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / STEPS
    calls = {name: sum(e.count for e in ka if e.key == name) / STEPS
             for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    print(f"train step, unprofiled: {wall_ms:.2f} ms by the host clock; device busy "
          f"{device_ms:.2f} ms per step (idle share {1 - device_ms / wall_ms:.1%}); per step "
          + ", ".join(f"{v:.0f} {k}" for k, v in calls.items()))
    print(f"per call: render_train_kernel {_device_us(prof, 'render_train_kernel'):.0f} us, "
          f"reduce_partials_kernel {_device_us(prof, 'reduce_partials_kernel'):.0f} us, "
          f"chamfer_bidir_kernel {_device_us(prof, 'chamfer_bidir_kernel'):.0f} us")


def time_variants(torch, dev) -> None:
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from ..models.nerf import NerfConfig, init_nerf_params
    from ..ops import fused_render as F
    from ..ops._build import BUILD_DIR, CSRC_DIR, CudaLibrary, build_all
    src = (CSRC_DIR / "render_train.cu").read_text()
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
    profile_step(torch, np, dev)
    time_variants(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
