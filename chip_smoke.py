#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`nope_nerf_torch`) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. In order it
1. prints the card's name and power limit (nvidia-smi) and builds every
   kernel from nope_nerf_torch/csrc/ (one nvcc per source, side by side);
2. holds each kernel against its plain PyTorch version on the card, over the
   flags it takes: render_fwd (K3), render_train (K1, with the bit-equality
   of two launches) and chamfer_bidir (K2, by matched distances);
3. drives the render path: nope_nerf_torch.cli.render.render on the synthetic
   driving scene at V-KITTI's 188x621, from a checkpoint the port wrote with
   seeded random weights at the full model width; checks that its kernel
   launched once per frame, that the frames are finite, and that a slab of
   view 0 agrees with the plain version;
4. drives the train path: create_train_state and Trainer.run_steps on the
   188x621 4-frame synthetic scene with the default config, 8 steps after a
   warm-up step; checks the launch counts per step, the loss terms and the
   parameters, and holds step 1 against the same step through the plain
   versions on the card;
5. times each path and each kernel at its main path's shapes (CUDA events),
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
TRAIN_CHECK_RAYS = 256
TRAIN_RAYS = 1024            # configs/default.yaml training.n_training_points
TRAIN_STEPS = 8
DENSITY_SHIFT = -4.0         # density bias of the seeded weights: keeps transmittance alive
                             # to the last of the 128 samples, so the composite and its
                             # backward are exercised whole
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 rate outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 rate (data sheet)


def tolerance(ref) -> float:
    """2e-3 absolute for [0,1] quantities (rgb, weights, alpha), relative to
    the largest value above 1 (dist): the kernel and the plain version sum
    the same bf16 products in another order, so an activation now and then
    rounds to the neighbouring bf16 value and the difference propagates."""
    return 2e-3 * max(1.0, float(ref.abs().max()))


def grad_tolerance(ref) -> float:
    """5e-3 of the block's largest entry (+1e-6). In the backward every
    cotangent is rounded to bf16 before each product and every ReLU mask comes
    from a bf16 activation; the kernel and the plain version sum the same
    products in another order, so now and then a rounding or a mask flips at
    one point and travels down that point's chain. (Measured worst over the
    16 cases below: 1.4e-3 for a weight block, 6.3e-2 for single entries of dz.)"""
    return 5e-3 * float(ref.abs().max()) + 1e-6


def grad_share(got, ref, per_sample: bool) -> float:
    """The error of a gradient block as a share of what is allowed (<= 1 passes).
    A weight or bias gradient sums over all points: every entry within
    grad_tolerance. d(rays) and dz are per ray and per sample: nothing averages
    a flipped mask away, and the encoding derivative multiplies it by up to 2^9,
    so a handful of entries may be off by more. There the block's L2 error is
    held to 2e-2 of its L2 norm, and at most 1 entry in 1000 may be off by
    more than 2e-2 of the largest entry."""
    err = (got - ref).abs()
    if not per_sample:
        return float(err.max()) / grad_tolerance(ref)
    l2 = float(err.norm()) / (2e-2 * float(ref.norm()) + 1e-12)
    outliers = float((err > 2e-2 * float(ref.abs().max()) + 1e-6).float().mean()) / 1e-3
    return max(l2, outliers)


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


def train_flops(D: int, n_rays: int, S: int) -> int:
    """The train kernel's products: the forward, and in the backward one
    dX = g W^T and one dW = x^T g per weight, each with the forward's MAC
    count (every weight, the encoding-facing ones included, takes part once
    in each: d(rays) needs the encodings' cotangents). The direction part is
    again counted once per ray."""
    return 3 * mlp_flops(D, n_rays, S)


def bound(flops: float, peak_flops: float, nbytes: float):
    """(bound ms, 'operations' or 'bytes', ops ms, bytes ms)."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms


def numel_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_render_fwd(torch, dev, gen) -> float:
    """K3 against its plain version over {softplus, relu} x dist_alpha x want_aux."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import (pack_rays, render_rays_fused,
                                                  render_rays_fused_plain)
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
    return worst


def train_inputs(torch, dev, gen, n_rays: int, S: int = 128):
    """Seeded (rays, z, tgt) for the train kernel: rays from near the origin,
    sorted z on [0.1, 6], targets with a mixed depth mask."""
    from nope_nerf_torch.ops.fused_render import pack_rays, pack_targets
    origin = torch.randn(n_rays, 3, generator=gen) * 0.5
    ray_vec = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=gen), dim=1)
    rays = pack_rays(origin, ray_vec, -ray_vec).to(dev)
    z = torch.sort(0.1 + 5.9 * torch.rand(n_rays, S, generator=gen), dim=1).values.to(dev)
    mask = (torch.arange(n_rays) % 3 != 0).to(dev)
    tgt = pack_targets(torch.rand(n_rays, 3, generator=gen).to(dev),
                       (1.0 + 4.0 * torch.rand(n_rays, generator=gen)).to(dev), mask,
                       0.7 / n_rays, 0.3 / float(mask.sum()))
    return rays, z, tgt


def check_render_train(torch, dev, gen):
    """K1 against its plain version over {softplus, relu} x dist_alpha x rgb_p x
    white_bg, and the bit-equality of two launches. Returns (worst absolute
    error of total/sums, worst gradient error as a share of its tolerance)."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import (render_ray_loss_fused,
                                                  render_ray_loss_fused_plain)
    rays, z, tgt = train_inputs(torch, dev, gen, TRAIN_CHECK_RAYS)
    worst_val, worst_share, failed = 0.0, 0.0, []
    for occ in ("softplus", "relu"):
        for dist_alpha in (False, True):
            ncfg = NerfConfig(hidden_dim=256, occ_activation=occ, dist_alpha=dist_alpha,
                              use_pallas=True)
            params = init_nerf_params(ncfg, gen, device=dev)
            if occ == "softplus" and not dist_alpha:
                # occupancy 1 - exp(-softplus) saturates within a few samples at the seeded
                # bias; delta-scaled opacity is small as it is, and relu would be cut to 0
                params["density_b"] = params["density_b"] + DENSITY_SHIFT
            for rgb_p in (1, 2):
                for white_bg in (False, True):
                    runs = []
                    for _ in range(2):
                        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
                        ins = [t.clone().requires_grad_(True) for t in (rays, z, tgt)]
                        total, sums = render_ray_loss_fused(leaves, *ins, ncfg, dist_alpha,
                                                            rgb_p, white_bg)
                        total.backward()
                        torch.cuda.synchronize()
                        grads = {k: v.grad for k, v in leaves.items()}
                        grads.update(rays=ins[0].grad, z=ins[1].grad, tgt=ins[2].grad)
                        runs.append((total.detach(), sums, grads))
                    (total, sums, grads), (total2, sums2, grads2) = runs
                    case = (f"occ={occ} dist_alpha={dist_alpha} rgb_p={rgb_p} "
                            f"white_bg={white_bg}")
                    if not (torch.equal(total, total2) and torch.equal(sums, sums2)
                            and all(torch.equal(grads[k], grads2[k]) for k in grads)):
                        raise RuntimeError(f"render_train: two launches differ ({case})")
                    r_total, r_sums, r_grads = render_ray_loss_fused_plain(
                        params, rays, z, tgt, ncfg, dist_alpha, rgb_p, white_bg)
                    r_grads = dict(r_grads["params"], rays=r_grads["rays"], z=r_grads["z"],
                                   tgt=r_grads["tgt"])
                    for name, g, r in (("total", total, r_total), ("sums", sums, r_sums)):
                        rel = float(((g - r).abs() / r.abs().clamp_min(1e-12)).max())
                        worst_val = max(worst_val, max_err(g, r))
                        if not rel <= 2e-3:
                            raise RuntimeError(f"render_train disagrees with its plain "
                                               f"version: {name} rel {rel} ({case})")
                    shares = {k: grad_share(grads[k], r_grads[k], k in ("rays", "z"))
                              for k in r_grads}
                    k_worst = max(shares, key=shares.get)
                    worst_share = max(worst_share, shares[k_worst])
                    print(f"render_train vs plain, {case}: total {float(total):.6g} "
                          f"(plain {float(r_total):.6g}), {len(shares)} gradient blocks, worst "
                          f"{k_worst} at {shares[k_worst]:.3f} of its tolerance (rays "
                          f"{shares['rays']:.3f}, z {shares['z']:.3f}, largest weight block "
                          f"{max(v for k, v in shares.items() if k.endswith('_w')):.3f}); "
                          f"two launches bit-equal")
                    if not shares[k_worst] <= 1.0:
                        failed.append(f"{k_worst} at {shares[k_worst]:.2f} of its tolerance "
                                      f"({case})")
    if failed:
        raise RuntimeError("render_train disagrees with its plain version: " + "; ".join(failed))
    return worst_val, worst_share


def depth_lifted_clouds(torch, dev, gen, h: int, w: int):
    """Two (h*w, 3) clouds as the train step lifts them: a pixel grid times
    seeded depths through the scene's K^-1, the second moved by a small pose."""
    from nope_nerf_torch.geometry.camera import intrinsics_ndc_np, pixel_grid, transform_to_world
    K = torch.from_numpy(intrinsics_ndc_np(0.7 * 621, 0.7 * 621, 621, 188)).to(dev)
    pix = torch.from_numpy(pixel_grid((h, w))[1]).to(dev)
    clouds = []
    for _ in range(2):
        depth = (4.0 + 4.0 * torch.rand(h * w, 1, generator=gen)).to(dev)
        clouds.append(transform_to_world(pix, depth, K))
    shift = torch.tensor([0.15, -0.05, 0.3], device=dev)
    return clouds[0] + shift, clouds[1]


def check_chamfer(torch, dev, gen) -> float:
    """K2 against its plain version by matched distances (13 of d2's 23 mantissa
    bits are masked, so among near-ties either may win), and by index on a cloud
    without near-ties. Returns the worst distance gap."""
    from nope_nerf_torch.ops.chamfer import (nearest_idx_bidirectional,
                                             nearest_idx_bidirectional_plain)
    worst = 0.0
    cases = [("7285 x 7285 depth-lifted", depth_lifted_clouds(torch, dev, gen, 47, 155)),
             ("301 x 77 ragged", ((torch.rand(301, 3, generator=gen) * 6 - 3).to(dev),
                                  (torch.rand(77, 3, generator=gen) * 6 - 3).to(dev)))]
    for name, (x, y) in cases:
        got = nearest_idx_bidirectional(x, y)
        torch.cuda.synchronize()
        ref = nearest_idx_bidirectional_plain(x, y)
        for direction, ig, ir, src, dst in (("x->y", got[0], ref[0], x, y),
                                            ("y->x", got[1], ref[1], y, x)):
            if ig.shape != ir.shape or int(ig.min()) < 0 or int(ig.max()) >= dst.shape[0]:
                raise RuntimeError(f"chamfer_bidir: bad indices ({name}, {direction})")
            d_g = (src - dst[ig]).norm(dim=1)
            d_r = (src - dst[ir]).norm(dim=1)
            gap = (d_g - d_r).abs()
            worst = max(worst, float(gap.max()))
            if not bool((gap <= 2.0 ** -10 * d_r + 1e-6).all()):
                raise RuntimeError(f"chamfer_bidir disagrees with its plain version: matched "
                                   f"distances differ by {float(gap.max())} ({name}, {direction})")
            print(f"chamfer_bidir vs plain, {name} {direction}: indices equal "
                  f"{float((ig == ir).float().mean()):.4f}, worst distance gap "
                  f"{float(gap.max()):.3g}")
    # no near-ties: a jittered lattice against a shuffled, jittered copy
    side = torch.arange(18.0)
    lattice = torch.stack(torch.meshgrid(side, side, side, indexing="ij"), -1).reshape(-1, 3)
    x = (lattice + 0.1 * (torch.rand(lattice.shape, generator=gen) - 0.5)).to(dev)
    y = (lattice[torch.randperm(len(lattice), generator=gen)]
         + 0.1 * (torch.rand(lattice.shape, generator=gen) - 0.5)).to(dev)
    got, ref = nearest_idx_bidirectional(x, y), nearest_idx_bidirectional_plain(x, y)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise RuntimeError("chamfer_bidir: indices differ from the plain version on a cloud "
                           "without near-ties")
    print(f"chamfer_bidir vs plain, {len(lattice)} lattice points without near-ties: "
          f"indices equal")
    return worst


def run_render_path(torch, np, dev, gen):
    """Phase 3. Returns what the timings need: (launches, params, traj, scene, ncfg, rcfg)."""
    from nope_nerf_torch.cli.render import load_scene, novel_trajectory, render
    from nope_nerf_torch.config import DEFAULTS, update_recursive
    from nope_nerf_torch.geometry.camera import pixel_grid, rigid_inverse
    from nope_nerf_torch.geometry.lie import log_so3
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import (RENDER_FWD, render_rays_fused,
                                                  render_rays_fused_plain)
    from nope_nerf_torch.ops.render import RenderConfig, _ray_geometry, fused_inputs
    from nope_nerf_torch.training.checkpoints import load_checkpoint, save_checkpoint

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
    print(f"render path: {len(frames)} views at {h}x{w}, render_fwd launches {launches} "
          f"(expected {N_VIEWS * per_frame})")
    if launches != N_VIEWS * per_frame:
        raise RuntimeError("the render path did not launch render_fwd once per chunk")
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
            raise RuntimeError(f"render-path frame disagrees with the plain version: {name}")
    # the same slab's per-sample weights and alpha, from the kernel with want_aux
    got = render_rays_fused(params["nerf"], table, z, ncfg, rcfg.dist_alpha, want_aux=True)
    left = 1.0 - ref[2].sum(dim=1)
    print(f"view 0 rows 0-7: transmittance past the last sample mean {left.mean():.4f}, "
          f"min {left.min():.4f}")
    for name, g, r in (("weights", got[2], ref[2]), ("alpha", got[3], ref[3])):
        err, tol = max_err(g, r), tolerance(r)
        print(f"view 0 rows 0-7 vs plain: {name} err {err:.3g} (tol {tol:.3g})")
        if not err <= tol:
            raise RuntimeError(f"render-path {name} disagree with the plain version")
    return launches, params, traj, scene, ncfg, rcfg, view0_inputs


def run_train_path(torch, np, dev):
    """Phase 4: the bench workload of the JAX package (bench.py: default config,
    learned poses on top of the scene's, 1024 rays, the 4-frame synthetic scene
    at 188x621). Returns (launch counts per kernel, step ms, trainer, state,
    scene, order, refs)."""
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import (SceneData, batch_for_frame, epoch_order,
                                      make_synthetic_scene)
    from nope_nerf_torch.ops.chamfer import CHAMFER_BIDIR
    from nope_nerf_torch.ops.fused_render import RENDER_FWD, RENDER_TRAIN
    from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
    from nope_nerf_torch.training.trainer import _sample_rays, step_gradients

    h, w = RESOLUTION
    cfg = load_config(overrides={"training": {"n_training_points": TRAIN_RAYS},
                                 "pose": {"learn_pose": True, "init_pose": True}})
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    state = create_train_state(SEED, mc, init_c2w=scene.c2ws_gt, device=dev)
    trainer = Trainer(cfg, mc)
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    order, refs = np.resize(order, TRAIN_STEPS), np.resize(refs, TRAIN_STEPS)
    weights, _, rgb_loss_type = trainer._sched_at(0, 10000)

    # step 1 of this state, through the kernels and through their plain versions
    batch = batch_for_frame(scene, int(order[0]), ref_idx=int(refs[0]))
    ray_idx = _sample_rays(torch.Generator(device=dev).manual_seed(SEED + 1), h * w, TRAIN_RAYS,
                           None, False)
    noise = torch.rand((TRAIN_RAYS, mc.render.num_points),
                       generator=torch.Generator(device=dev).manual_seed(SEED + 2), device=dev)
    g_k, ld_k = step_gradients(state.params, batch, weights, ray_idx, None, mc, rgb_loss_type,
                               noise=noise)
    g_p, ld_p = step_gradients(state.params, batch, weights, ray_idx, None, mc, rgb_loss_type,
                               noise=noise, force_plain=True)
    torch.cuda.synchronize()
    for k in ld_p:
        err = abs(float(ld_k[k]) - float(ld_p[k]))
        if not err <= 2e-3 * abs(float(ld_p[k])) + 1e-7:
            raise RuntimeError(f"train step 1: loss term {k} {float(ld_k[k])} differs from the "
                               f"plain versions' {float(ld_p[k])}")
    report = []
    for group in ("pose", "distortion"):
        for k, ref in g_p[group].items():
            err, top = max_err(g_k[group][k], ref), float(ref.abs().max())
            report.append(f"{group}/{k} {err:.3g} of {top:.3g}")
            # sums of d(rays) and dz over the batch: their tolerance (grad_tolerance)
            if not err <= 5e-2 * top + 1e-9:
                raise RuntimeError(f"train step 1: gradient {group}/{k} differs from the plain "
                                   f"versions' by {err} (largest entry {top})")
    print(f"train step 1 vs plain versions: {len(ld_p)} loss terms within 2e-3 "
          f"(loss {float(ld_k['loss']):.6g} vs {float(ld_p['loss']):.6g}); gradient errors "
          + ", ".join(report))

    # warm-up step, then the counted run
    state, _ = trainer.run_steps(state, scene, order[:1], refs[:1], epoch=0,
                                 scheduling_start=10000)
    before = {g: {k: v.clone() for k, v in d.items()} for g, d in state.params.items()}
    kernels = {"render_train": RENDER_TRAIN, "chamfer_bidir": CHAMFER_BIDIR,
               "render_fwd": RENDER_FWD}
    for lib in kernels.values():
        lib.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, lds = trainer.run_steps(state, scene, order, refs, epoch=0, scheduling_start=10000)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    counts = {name: lib.launches for name, lib in kernels.items()}
    print(f"train path: {TRAIN_STEPS} steps of {TRAIN_RAYS} rays at {h}x{w}, launches "
          f"render_train {counts['render_train']}, chamfer_bidir {counts['chamfer_bidir']}, "
          f"render_fwd {counts['render_fwd']} (expected {TRAIN_STEPS}, {TRAIN_STEPS}, 0)")
    if (counts["render_train"], counts["chamfer_bidir"], counts["render_fwd"]) != (
            TRAIN_STEPS, TRAIN_STEPS, 0):
        raise RuntimeError("the train path did not launch each of its kernels once per step")
    for k, v in lds.items():
        if v.shape[0] != TRAIN_STEPS or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"train path: loss term {k} is not finite over the steps")
    ray_loss = (lds["loss_rgb"] + lds["loss_depth"]).tolist()
    print("train path: loss_rgb + loss_depth per step " + " ".join(f"{v:.4f}" for v in ray_loss)
          + f"; loss {float(lds['loss'][0]):.4f} -> {float(lds['loss'][-1]):.4f}")
    if not ray_loss[-1] < ray_loss[0]:
        raise RuntimeError("train path: loss_rgb + loss_depth did not fall over the steps")
    for group, d in state.params.items():
        if not all(bool(torch.isfinite(v).all()) for v in d.values()):
            raise RuntimeError(f"train path: non-finite parameter in group {group}")
        if not any(not torch.equal(v, before[group][k]) for k, v in d.items()):
            raise RuntimeError(f"train path: parameter group {group} did not change")
    if state.it != TRAIN_STEPS:
        raise RuntimeError(f"train path: iteration counter {state.it}, expected {TRAIN_STEPS}")
    return counts, step_ms, trainer, state, scene, order, refs, mc


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nope_nerf_torch.evaluation.extract import render_trajectory
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops._build import build_all
    from nope_nerf_torch.ops.chamfer import (CHAMFER_BIDIR, nearest_idx_bidirectional,
                                             nearest_idx_bidirectional_plain)
    from nope_nerf_torch.ops.fused_render import (
        RENDER_FWD, RENDER_TRAIN, STASH_HALF_DIMS, pack_weights, render_ray_loss_fused,
        render_ray_loss_fused_plain, render_rays_fused, render_rays_fused_plain)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)

    # ---- 1. build -----------------------------------------------------------
    libraries = (RENDER_FWD, RENDER_TRAIN, CHAMFER_BIDIR)
    t0 = time.perf_counter()
    build_all(libraries)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          + ", ".join(lib.source.name for lib in libraries) + " (side by side)")
    for lib in libraries:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib.source.name}:", line.strip())

    # ---- 2. each kernel against its plain version ---------------------------
    gen = torch.Generator().manual_seed(SEED)
    fwd_err = check_render_fwd(torch, dev, gen)
    train_err, train_share = check_render_train(torch, dev, gen)
    print(f"render_train: worst gradient error over the 16 cases at {train_share:.3f} of its "
          f"tolerance (grad_share)")
    chamfer_gap = check_chamfer(torch, dev, gen)

    # ---- 3. the render path: novel views through the render CLI --------------
    fwd_launches, params, traj, scene, ncfg, rcfg, view0_inputs = run_render_path(
        torch, np, dev, gen)

    # ---- 4. the train path: Trainer.run_steps --------------------------------
    counts, step_ms, trainer, state, tscene, order, refs, mc = run_train_path(torch, np, dev)

    # ---- 5. timing at the main paths' shapes ---------------------------------
    h, w = RESOLUTION
    n_rays = h * w
    frame_ms = time_ms(lambda: render_trajectory(params["nerf"], traj[:1], scene.K,
                                                 RESOLUTION, ncfg, rcfg, device=dev), N_VIEWS)
    table, z, _ = view0_inputs(h)
    fwd_ms = time_ms(lambda: render_rays_fused(params["nerf"], table, z, ncfg,
                                               rcfg.dist_alpha, want_aux=False), 3)
    fwd_plain_ms = time_ms(lambda: render_rays_fused_plain(params["nerf"], table, z, ncfg,
                                                           rcfg.dist_alpha, want_aux=False), 1)
    W, B = pack_weights(params["nerf"], ncfg)
    fwd_flops = mlp_flops(ncfg.hidden_dim, n_rays, z.shape[1])
    fwd_bytes = (table.numel() + z.numel() + 4 * n_rays) * 4 + numel_bytes(W + B)
    fwd_bound, fwd_by, _, _ = bound(fwd_flops, PEAK_BF16_FLOPS, fwd_bytes)
    print(f"frame {h}x{w}: {frame_ms:.2f} ms end to end ({n_rays / frame_ms * 1e3:.0f} rays/s), "
          f"render_fwd {fwd_ms:.2f} ms ({fwd_ms / frame_ms:.1%} of the frame), "
          f"plain version {fwd_plain_ms:.1f} ms; {fwd_flops / 1e12:.2f} TFLOP, "
          f"{fwd_bytes / 1e6:.1f} MB -> bound {fwd_bound:.2f} ms "
          f"({fwd_flops / fwd_ms / 1e9:.1f} TFLOP/s achieved)")

    # the train step end to end, and K1 / K2 at its shapes
    def steps():
        trainer.run_steps(state, tscene, order, refs, epoch=0, scheduling_start=10000)
    steps_ms = time_ms(steps, 2) / TRAIN_STEPS
    gen = torch.Generator().manual_seed(SEED + 3)
    tcfg = NerfConfig(hidden_dim=256, use_pallas=True)
    tparams = init_nerf_params(tcfg, gen, device=dev)
    tparams["density_b"] = tparams["density_b"] + DENSITY_SHIFT
    S = mc.render.num_points
    rays, tz, tgt = train_inputs(torch, dev, gen, TRAIN_RAYS, S)
    train_ms = time_ms(lambda: render_ray_loss_fused(tparams, rays, tz, tgt, tcfg, False, 1,
                                                     False), 10)
    train_plain_ms = time_ms(lambda: render_ray_loss_fused_plain(tparams, rays, tz, tgt, tcfg,
                                                                 False, 1, False), 2)
    W, B = pack_weights(tparams, tcfg)
    grad_bytes = 4 * sum(v.numel() for v in tparams.values())
    stash_bytes = TRAIN_RAYS * S * STASH_HALF_DIMS * tcfg.hidden_dim   # bf16, 9.5 D per point
    io_bytes = 2 * numel_bytes([rays, tz, tgt]) + 2 * numel_bytes(W) + numel_bytes(B) + grad_bytes
    t_flops = train_flops(tcfg.hidden_dim, TRAIN_RAYS, S)
    t_bound, t_by, t_ops_ms, t_bytes_ms = bound(t_flops, PEAK_BF16_FLOPS,
                                                io_bytes + 2 * stash_bytes)
    print(f"render_train {TRAIN_RAYS} rays x {S}: {train_ms:.3f} ms, plain version "
          f"{train_plain_ms:.1f} ms; {t_flops / 1e12:.3f} TFLOP ({t_ops_ms:.3f} ms), "
          f"{io_bytes / 1e6:.1f} MB of rays, weights and gradients plus a "
          f"{stash_bytes / 1e6:.1f} MB stash written and read ({t_bytes_ms:.3f} ms) -> bound "
          f"{t_bound:.3f} ms by {t_by} ({t_flops / train_ms / 1e9:.1f} TFLOP/s achieved)")

    cx, cy = depth_lifted_clouds(torch, dev, gen, h // mc.pc_ratio, w // mc.pc_ratio)
    chamfer_ms = time_ms(lambda: nearest_idx_bidirectional(cx, cy), 20)
    chamfer_plain_ms = time_ms(lambda: nearest_idx_bidirectional_plain(cx, cy), 3)

    def library_sweep():
        d = torch.cdist(cx, cy)
        return d.min(dim=1), d.min(dim=0)
    chamfer_lib_ms = time_ms(library_sweep, 10)
    pairs = cx.shape[0] * cy.shape[0]
    c_flops = 8 * pairs            # 3 FMAs and 2 adds per pair, in f32 outside the tensor cores
    c_bytes = 16 * (cx.shape[0] + cy.shape[0])   # 12 bytes in, one int32 index out, per point
    c_bound, c_by, _, _ = bound(c_flops, PEAK_F32_FLOPS, c_bytes)
    print(f"chamfer_bidir {cx.shape[0]} x {cy.shape[0]}: {chamfer_ms * 1e3:.1f} us with its two "
          f"fills and index masks, plain version {chamfer_plain_ms:.2f} ms, torch.cdist + two "
          f"mins {chamfer_lib_ms:.3f} ms; {pairs / 1e6:.1f} M pairs -> bound "
          f"{c_bound * 1e3:.1f} us by {c_by}: launch-bound at this size")
    rest_ms = steps_ms - train_ms - chamfer_ms
    print(f"train step {h}x{w}, {TRAIN_RAYS} rays: {steps_ms:.2f} ms end to end by CUDA events "
          f"({TRAIN_RAYS / steps_ms * 1e3:.0f} rays/s; {step_ms:.2f} ms by the host clock in the "
          f"counted run), render_train {train_ms / steps_ms:.1%}, chamfer_bidir "
          f"{chamfer_ms / steps_ms:.1%}, the rest (plain torch ops, autograd, Adam, host) "
          f"{rest_ms:.2f} ms = {rest_ms / steps_ms:.1%}")

    print(json.dumps({"kernels": [
        {"name": "render_fwd", "route": "cuda",
         "source": "nope_nerf_torch/csrc/render_fwd.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_render.py:368",
         "launches": fwd_launches, "max_abs_err": fwd_err, "ms": fwd_ms,
         "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
         "library_ms": None},
        {"name": "render_train", "route": "cuda",
         "source": "nope_nerf_torch/csrc/render_train.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_render.py:605",
         "launches": counts["render_train"], "max_abs_err": train_err, "ms": train_ms,
         "plain_ms": train_plain_ms, "bound_ms": t_bound, "bound_by": t_by,
         "library_ms": None},
        {"name": "chamfer_bidir", "route": "cuda",
         "source": "nope_nerf_torch/csrc/chamfer_bidir.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_chamfer.py:78",
         "launches": counts["chamfer_bidir"], "max_abs_err": chamfer_gap, "ms": chamfer_ms,
         "plain_ms": chamfer_plain_ms, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": chamfer_lib_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
