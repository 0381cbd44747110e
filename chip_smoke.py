#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`nope_nerf_torch`) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. In order it
1. prints the card's name and power limit (nvidia-smi) and builds every
   kernel from nope_nerf_torch/csrc/ (one nvcc per source);
2. holds each kernel against its plain PyTorch version on the card, over
   the flags it takes;
3. drives the main path, novel-view rendering: nope_nerf_torch.cli.render
   .render on the synthetic driving scene at V-KITTI's 188x621, from a
   checkpoint the port wrote with seeded random weights at the full model
   width; checks that every kernel of the path launched, that the frames are
   finite, and that a slab of view 0 agrees with the plain version;
4. times the frame and each kernel at the main path's shapes (CUDA events),
   prints one `kernels` JSON line and, last, {"ok": true, "device": {...}}.
It exits non-zero, and prints no result, when CUDA is missing, outside a
checkout, or when any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
RESOLUTION = (188, 621)      # V-KITTI extraction size (configs/V_KITTI/example_scene.yaml)
N_VIEWS = 3
CHECK_RAYS = 2048
DENSITY_SHIFT = -4.0         # main-path density bias: keeps transmittance alive to the
                             # last of the 128 samples, so the composite is exercised whole
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 rate (data sheet)


def tolerance(ref) -> float:
    """2e-3 absolute for [0,1] quantities (rgb, weights, alpha), relative to
    the largest value above 1 (dist): the kernel and the plain version sum
    the same bf16 products in another order, so an activation now and then
    rounds to the neighbouring bf16 value and the difference propagates."""
    return 2e-3 * max(1.0, float(ref.abs().max()))


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def time_ms(fn, reps: int) -> float:
    """Mean ms of fn() over `reps` runs after one warm-up, by CUDA events."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mlp_flops(D: int, n_rays: int, S: int, pos_in: int = 63, dir_in: int = 27) -> int:
    """2 x the MACs of the 9-layer MLP with its skip and heads over n_rays x S
    points. The direction encoding is per ray, so its share of the rgb-hidden
    layer, dir_in x D/2, is counted once per ray (the kernel folds it into
    that layer's bias)."""
    per_point = (pos_in * D + 3 * D * D + (D + pos_in) * D + 3 * D * D + D
                 + D * D + D * (D // 2) + (D // 2) * 3)
    return 2 * (per_point * n_rays * S + dir_in * (D // 2) * n_rays)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nope_nerf_torch.cli.render import load_scene, novel_trajectory, render
    from nope_nerf_torch.config import DEFAULTS, update_recursive
    from nope_nerf_torch.evaluation.extract import render_trajectory
    from nope_nerf_torch.geometry.camera import pixel_grid, rigid_inverse
    from nope_nerf_torch.geometry.lie import log_so3
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import (
        RENDER_FWD, pack_rays, pack_weights, render_rays_fused, render_rays_fused_plain)
    from nope_nerf_torch.ops.render import RenderConfig, _ray_geometry, fused_inputs
    from nope_nerf_torch.training.checkpoints import load_checkpoint, save_checkpoint

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    RENDER_FWD.lib()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {RENDER_FWD.source.name}")
    for line in RENDER_FWD.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 2. each kernel against its plain version ---------------------------
    gen = torch.Generator().manual_seed(SEED)
    worst = 0.0
    for occ in ("softplus", "relu"):
        for dist_alpha in (False, True):
            ncfg = NerfConfig(hidden_dim=256, occ_activation=occ, dist_alpha=dist_alpha,
                              use_pallas=True)
            params = init_nerf_params(ncfg, gen, device=dev)
            origin = torch.randn(CHECK_RAYS, 3, generator=gen) * 3.0
            ray_vec = torch.nn.functional.normalize(
                torch.randn(CHECK_RAYS, 3, generator=gen), dim=1)
            rays = pack_rays(origin, ray_vec, -ray_vec).to(dev)
            z = torch.sort(0.01 + 9.99 * torch.rand(CHECK_RAYS, 128, generator=gen),
                           dim=1).values.to(dev)
            for want_aux in (False, True):
                got = render_rays_fused(params, rays, z, ncfg, dist_alpha, want_aux)
                torch.cuda.synchronize()
                ref = render_rays_fused_plain(params, rays, z, ncfg, dist_alpha, want_aux)
                report = []
                for name, g, r in zip(("rgb", "dist", "weights", "alpha"), got, ref):
                    if r is None:
                        continue
                    err, tol = max_err(g, r), tolerance(r)
                    worst = max(worst, err)
                    report.append(f"{name} {err:.3g}/{tol:.3g}")
                    if not err <= tol:
                        raise RuntimeError(f"render_fwd disagrees with its plain version: "
                                           f"{name} err {err} > {tol} (occ={occ}, "
                                           f"dist_alpha={dist_alpha}, want_aux={want_aux})")
                print(f"render_fwd vs plain, occ={occ} dist_alpha={dist_alpha} "
                      f"want_aux={want_aux}: " + ", ".join(report))

    # ---- 3. the main path: novel views through the render CLI ---------------
    scene = load_scene("driving")
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = copy.deepcopy(DEFAULTS)
        update_recursive(cfg, {"training": {"out_dir": out_dir},
                               "extract_images": {"resolution": list(RESOLUTION),
                                                  "N_novel_imgs": N_VIEWS}})
        ncfg, rcfg = NerfConfig.from_cfg(cfg), RenderConfig.from_cfg(cfg)
        c2ws = torch.as_tensor(scene.c2ws_gt)
        nerf = init_nerf_params(ncfg, gen, device=dev)
        nerf["density_b"] = nerf["density_b"] + DENSITY_SHIFT
        params = {"nerf": nerf,
                  "pose": {"r": log_so3(c2ws[:, :3, :3]).to(dev),
                           "t": c2ws[:, :3, 3].contiguous().to(dev)}}
        save_checkpoint(out_dir, cfg["extract_images"]["model_file"], params)

        RENDER_FWD.launches = 0
        frames = render(cfg, synthetic="driving", device=dev, save=False)
        launches = RENDER_FWD.launches
        params, _ = load_checkpoint(out_dir, cfg["extract_images"]["model_file"], device=dev)

    h, w = RESOLUTION
    n_rays = h * w
    per_frame = math.ceil(n_rays / 131072)
    print(f"main path: {len(frames)} views at {h}x{w}, render_fwd launches {launches} "
          f"(expected {N_VIEWS * per_frame})")
    if launches != N_VIEWS * per_frame:
        raise RuntimeError("the main path did not launch render_fwd once per chunk")
    if len(frames) != N_VIEWS:
        raise RuntimeError(f"expected {N_VIEWS} frames, got {len(frames)}")
    for f in frames:
        if f["rgb"].shape != (h, w, 3) or f["depth"].shape != (h, w):
            raise RuntimeError(f"bad frame shapes {f['rgb'].shape} {f['depth'].shape}")
        if not (np.isfinite(f["rgb"]).all() and np.isfinite(f["depth"]).all()):
            raise RuntimeError("non-finite values in a rendered frame")
    d0 = frames[0]["depth"]
    print(f"frames finite; view 0 rgb mean {frames[0]['rgb'].mean():.4f}, depth mean "
          f"{d0.mean():.4f} std {d0.std():.4f} min {d0.min():.4f} max {d0.max():.4f}")

    # a row slab of view 0 through the plain version on the card
    traj = novel_trajectory(cfg, scene, params)
    camera_mat = torch.as_tensor(scene.K, device=dev)
    world_mat = rigid_inverse(torch.as_tensor(traj[0], device=dev))
    pixels = torch.from_numpy(pixel_grid(RESOLUTION)[1]).to(dev)
    ones = torch.ones((n_rays, 1), device=dev)

    def view0_inputs(rows: int):
        geo = _ray_geometry(pixels[:rows * w], ones[:rows * w], camera_mat, world_mat, None,
                            None, rcfg, False)
        table, z = fused_inputs(geo, rcfg)
        return table, z, geo["ray_norm"]

    table, z, ray_norm = view0_inputs(8)
    ref = render_rays_fused_plain(params["nerf"], table, z, ncfg, rcfg.dist_alpha, want_aux=True)
    got_rgb = torch.as_tensor(frames[0]["rgb"][:8].reshape(-1, 3), device=dev)
    got_depth = torch.as_tensor(frames[0]["depth"][:8].reshape(-1), device=dev)
    for name, g, r in (("rgb", got_rgb, ref[0]), ("depth", got_depth, ref[1] / ray_norm)):
        err, tol = max_err(g, r), tolerance(r)
        print(f"view 0 rows 0-7 vs plain: {name} err {err:.3g} (tol {tol:.3g})")
        if not err <= tol:
            raise RuntimeError(f"main-path frame disagrees with the plain version: {name}")
    # the same slab's per-sample weights and alpha, from the kernel with want_aux
    got = render_rays_fused(params["nerf"], table, z, ncfg, rcfg.dist_alpha, want_aux=True)
    left = 1.0 - ref[2].sum(dim=1)
    print(f"view 0 rows 0-7: transmittance past the last sample mean {left.mean():.4f}, "
          f"min {left.min():.4f}")
    for name, g, r in (("weights", got[2], ref[2]), ("alpha", got[3], ref[3])):
        err, tol = max_err(g, r), tolerance(r)
        print(f"view 0 rows 0-7 vs plain: {name} err {err:.3g} (tol {tol:.3g})")
        if not err <= tol:
            raise RuntimeError(f"main-path {name} disagree with the plain version")

    # ---- 4. timing at the main path's shapes --------------------------------
    frame_ms = time_ms(lambda: render_trajectory(params["nerf"], traj[:1], scene.K,
                                                 RESOLUTION, ncfg, rcfg, device=dev), N_VIEWS)
    table, z, _ = view0_inputs(h)
    kernel_ms = time_ms(lambda: render_rays_fused(params["nerf"], table, z, ncfg,
                                                  rcfg.dist_alpha, want_aux=False), 3)
    plain_ms = time_ms(lambda: render_rays_fused_plain(params["nerf"], table, z, ncfg,
                                                       rcfg.dist_alpha, want_aux=False), 1)
    flops = mlp_flops(ncfg.hidden_dim, n_rays, z.shape[1])
    W, B = pack_weights(params["nerf"], ncfg)
    nbytes = (table.numel() + z.numel() + 4 * n_rays) * 4 \
        + sum(t.numel() * t.element_size() for t in W + B)
    bound_ops_ms, bound_bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    print(f"frame {h}x{w}: {frame_ms:.2f} ms end to end ({n_rays / frame_ms * 1e3:.0f} rays/s), "
          f"render_fwd {kernel_ms:.2f} ms ({kernel_ms / frame_ms:.1%} of the frame), "
          f"plain version {plain_ms:.1f} ms; {flops / 1e12:.2f} TFLOP, {nbytes / 1e6:.1f} MB "
          f"-> bound {bound_ms:.2f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s achieved)")

    print(json.dumps({"kernels": [{
        "name": "render_fwd", "route": "cuda",
        "source": "nope_nerf_torch/csrc/render_fwd.cu",
        "replaces": "nope_nerf_tpu/ops/pallas_render.py:368",
        "launches": launches, "max_abs_err": worst,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
