#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`nope_nerf_torch`) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. In order it
1. prints the card's name and power limit (nvidia-smi) and builds every
   kernel from nope_nerf_torch/csrc/ (one nvcc per source, ten side by side);
2. holds each kernel against its plain PyTorch version on the card, over the
   flags it takes: render_fwd (K3), render_train (K1, with the bit-equality
   of two launches), render_bwd (K4: two cotangent sets, bit-equality, its
   frozen-network variant, and the train kernel's own cotangents fed through
   it), chamfer_bidir (K2, by matched distances, and two launches
   bit-equal), point_mlp_fwd (K5) and
   point_mlp_bwd (K6, with the bit-equality of two launches and its
   frozen-network variant's d(points), d(directions) equal to the full
   one's), the last two at the fine pass's point count made ragged, the
   weight-gradient kernel dw_sm90 (the dW products of K1, K4 full and K6
   full, on its own over every block shape of K6's table at 1, 127, 128 and
   that many points, with two launches bit-equal), and
   chamfer_nearest (K7: d2 and indices bit-equal at the LLFF and Tanks train steps' 47,628- and
   32,400-point clouds, ragged shapes, a lattice and clouds with exact duplicates across
   every segment edge of its grid, two launches bit-equal; nearest_dists' gradient);
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
5. drives the train CLI and the evaluation path at the full model width on the
   built-in synthetic scene: cli.train.train for 2 epochs with the validate
   and checkpoint hooks firing, a resume (1 epoch + checkpoint + 1 epoch) held
   bit-equal to 2 epochs straight, an epoch with the visualize (phong geometry
   view included) and reprojection hooks writing PNGs through the port's own
   writer, cli.eval.evaluate with test-time pose optimisation (one render_fwd
   launch and one of render_bwd's frozen-network variant per step) saving its
   per-view PNGs,
   cli.eval_poses.evaluate_poses, and 4 train steps of a config outside the
   fused-loss gate (depth_loss_type invariant: render_fwd + render_bwd's full
   variant per step), each with its launch counts asserted and its first
   step (loss terms and gradients) held against the plain versions' route;
6. drives hierarchical sampling (rendering.n_importance 64) through K5 and K6:
   the train path of phase 4 (step 1 against the plain versions, then 4
   counted steps: K5 twice and K6 once per step, no fused render kernel),
   Trainer.render_frame at 188x621 (K5 twice per chunk, a slab against the
   plain versions), pose-optimisation steps (K5 twice and K6's
   frozen-network variant once per step); then the rest of the slice:
   train steps with normal_loss, cli.train with the occupancy grid (its
   resume bit-equal, grid included) and Trainer.render_geo;
7. drives scenes on disk, written by the port's write_vkitti_scene in the
   V-KITTI/LLFF layout and read back through data/fields.py::DataField: the
   configs configs/LLFF/fern.yaml (756x1008, DPT npz priors, NDC), configs/
   Tanks/Ballroom.yaml (540x960) and configs/V_KITTI/straight_d4.yaml (375x1242
   on disk, 188x621 after resize_factor 2, 16-bit depths, intrinsics.npz,
   noisy COLMAP poses), each through cli.train for 1 epoch with its launches
   per step asserted (K7 twice on the first two, whose Chamfer clouds exceed
   K2's 8,192 points; K2 once on the third); fern's step 1 against the plain
   versions; then cli.eval_poses (the PLY), cli.render and cli.eval on the fern
   scene. Ballroom's frames are JPEG files, as the Tanks scenes ship,
   written by nope_nerf_torch/tools/jpeg_writer.py (4:2:0 at quality 95; one
   frame 4:4:4, one 4:2:2 with a restart interval, one with an Exif
   orientation of 1) and each decoded before cli.train: its shape, its PSNR
   against the source over what a JPEG keeps above 35 dB, two reads
   identical; fern and straight_d4 stay PNG. The decode times (a Ballroom
   frame, a 375x1242 Paeth-filtered PNG, one 3024x4032 JPEG frame) and the
   Ballroom scene's load through DataField go on their own JSON line. The one
   cut: fern is written at its working size with resize_factor 1, not as
   3024x4032 originals minified by 4;
8. prepares a scene and measures it perceptually on phase 7's straight
   scene: LPIPS (VGG16, seeded weights saved as a JAX-layout .npz) on a
   188x621 pair and DPT-Hybrid (default widths, the JAX package's random
   init) on one 384x1280 input, each on the card against the same module on
   this machine's CPU (DPT: l1 to l4, path1, the inverse depth and the
   depth); cli.preprocess with configs/V_KITTI/preprocess_straight.yaml's
   keys writes the 6 priors; cli.train trains straight_d2 for 1 epoch on them
   (K1 and K2 once a step); cli.eval reports LPIPS; cli.get_vkitti turns a
   raw V-KITTI tree (375x1242 PNGs, extrinsics txt) into a scene that
   DataField reads back; DPT and LPIPS are timed beside their FLOP bounds and
   printed on their own JSON line (library calls, not kernels);
10. drives the multi-device layer (nope_nerf_torch/parallel/) while phase 7's
   scene is still on disk, in processes of its own (this file run with
   --parallel-worker or --cli-worker), each printing its own launch counts:
   (a) the sharded fused train step at the width of phase 4 on 2 ranks
   under gloo on this one card (512 rays a rank through K1 and the dW
   kernel, K2 on each rank): step 1 against the one-process step on the
   same draws, 4 counted steps, the ranks' states bit-equal; (d)
   Trainer.render_frame_multihost at 188x621 (K3 once a rank), bit-equal to
   render_frame; (b) the invariant-depth step (K3 and K4 full a rank, the
   median over the gathered batch) the same way; (c) the sharded step on a
   1-rank NCCL mesh, bit-equal to the unsharded step; (e) cli.train with
   tpu.mesh_shape [2] through torch.distributed.run on the straight_d4
   scene, only rank 0 writing checkpoints and a resume bit-equal to a
   straight run. A rank that fails, or a collective that times out, fails
   the phase. It runs before phase 9's timings;
11. replays the train step and the pose-optimisation step as captured CUDA
   graphs (nope_nerf_torch/training/graphs.py), after phase 10: the phase-4
   fused path (8 steps: K1, the dW kernel, K2), depth_loss_type invariant (4:
   K3, K4 full), n_importance 64 (4: K5 twice, K6 full) and fern from phase
   7's disk (5: K7 twice), each N steps eagerly (Trainer(graphs=False)) and N
   replayed from copies of one state and generator, twice: states, loss terms
   and generators torch.equal, launches per step through the replays equal
   to the eager ones; cli.train with the occupancy grid (2 epochs eager,
   replayed, and replayed with a resume, bit-equal) and with tpu.scan_steps
   false against true; optimize_test_poses for 20 epochs on the fused and
   the hierarchical route, replayed against eager. Each step body also runs
   once eagerly under torch.cuda.set_sync_debug_mode('error'). The eager and
   replayed ms per step, capture seconds and graph pool MB go on one JSON
   line. `python3 chip_smoke.py --step-graphs` builds the kernels and runs
   this phase alone;
12. holds the render kernels at every sample count the JAX kernels take
   (S % 128 == 0), after phase 11: K1 (two flag sets: softplus, relu with
   dist_alpha) and K4 full and frozen against their plain versions at
   S = 256, 384, 1024 and 2048, at D = 256 and 128, on 133 rays (no multiple
   of the SMs), two launches bit-equal; K3 at S = 2048 and 4096; K1 at
   1024 rays x 2048, its dW operands in chunks of rays within the budget
   (ops/fused_render.py::render_chunks), bit-equal over two launches and
   within tolerance of one chunk, with both peaks of device memory; then the
   default widths with rendering.num_points 512 through the main path, launch
   counts asserted: the 188x621 train path eager against replayed
   (torch.equal), 4 invariant-depth steps (K3, K4 full), cli.train,
   cli.eval's pose optimisation (K4 frozen), cli.render at 188x621; one
   Trainer.render_frame at 2048 samples (a row against the plain versions)
   and one 1024 x 2048 train step (K1 in 8 chunks) with its peak memory.
   `python3 chip_smoke.py --many-samples` builds the kernels and runs this
   phase alone;
13. holds the kernels at hidden_dim 384 and 512 (the 64-point trunk of
   csrc/mlp_fwd_wide_sm90.cuh and the 64-point dX chain of
   csrc/mlp_dx_wide_sm90.cuh), after phase 12: K3 at S = 128 and 1024 on
   133 rays and K5 at 1, 127 and 196,645 points, K4's frozen-network
   variant at S = 128, 256 and 1024 on the pose-opt step's 1024 rays and
   K6's at 1, 63, 64, 65,
   127 and 196,645 points, and K6 full (every dW and dB block, d(points)
   and d(directions): those torch.equal to K6 frozen's) at 1, 63, 64, 65,
   127, 129 and 196,645 points, and K1 and K4 full (every dW and dB block;
   K1's loss sums and d(target)) on 1024 rays x 128 and 512, 4096 x 256 and
   4097 x 128, in chunks of rays, with K4 full's d(rays), dz
   torch.equal to K4 frozen's and K4 full fed K1's cotangents bit-equal to
   K1, against their plain versions over two flag sets (softplus; relu with
   dist_alpha), two launches bit-equal; then at each
   width the render path from a checkpoint of seeded random weights the port
   wrote: cli.render over 3 views at 188x621 (K3 once a frame, view 0's rows
   0-7 against the plain version), Trainer.render_frame fused (K3 once) and
   with n_importance 64 (K5 twice a chunk), each with rows 0-7 against the
   plain versions; and from the same weights cli.eval's test-time pose
   optimisation (K3 and K4 frozen once a step, its metrics finite),
   optimize_test_poses replayed from its captured step against eager runs
   (torch.equal), fused and hierarchical, and 4 hierarchical pose-opt steps
   (K5 twice and K6 frozen once a step); hierarchical training from the same
   weights: cli.train, one epoch of 8 steps (K5 twice, K6 full, the dW
   kernel and K2 once a step; K1 and K4 full never), and 4 replayed steps of
   Trainer.run_steps against the same steps eager (torch.equal); the default
   config's training from the same weights: cli.train, one epoch of 8 fused
   steps (K1, the dW kernel and K2 once a step), and at 188x621 4 fused and
   4 depth_loss_type invariant steps (K3 and K4 full) replayed against the
   same steps eager (torch.equal).
   `python3 chip_smoke.py --wide` builds the kernels and runs this phase
   alone;
14. holds the backward kernels at hidden_dim 128 and 256 (the 128-point
   chain of csrc/mlp_dx_sm90.cuh, its forward summed ring slice by ring
   slice from zero) on phase 13's cases, by its rules and invariants, after
   phase 13: K1 and K4 full on 1024 rays x 128 and 512, 4096 x 256 and 4097
   x 128 over both flag sets (every dW and dB block by 5e-3, K1's sums and
   d(target); K4 full's d(rays), dz torch.equal to K4 frozen's, K4 full fed
   K1's cotangents bit-equal to K1, two launches bit-equal), K4 frozen at S
   = 128, 256 and 1024 on 1024 rays (beside phase 12's 133), K6 frozen at
   1 to 196,645 points and K6 full at 1 to 196,645 points (d(points),
   d(directions) torch.equal to K6 frozen's). Every hold reports before the
   phase fails. `python3 chip_smoke.py --narrow` builds the kernels and runs
   this phase alone;
15. holds the one forward that every kernel runs, after phase 14: at
   hidden_dim 128, 256, 384 and 512 over both flag sets, the X operands of
   the dW products (pe, x0..x7, feat; and de) that the check builds of K3
   and K5 write, torch.equal to those K4 full and K1 hand their dW kernel on
   1024 rays x 128 and x 256 and 133 x 128, and to those K6 full hands it on
   1 to 196,645 points; the check builds' outputs torch.equal to the main
   builds'. Every hold reports before the phase fails. `python3 chip_smoke.py
   --forward` builds the kernels and runs this phase alone;
9. times each path and each kernel at its main path's shapes (CUDA events;
   dw_sm90 also on its own over K1's and K4 full's 11 blocks, beside the
   bytes of the operands those kernels hand it; K2 and K7 through their
   wrappers and as the bare C call, beside their FLOP bound and the issue
   floor of their hot loop's SASS; K1, K4 full and K4 frozen again at the
   512-sample path's 1024 x 512 and K3 per 188x621 frame at 2048 samples, each
   held against its plain version at that shape and timed beside its bound,
   with a `many_samples` JSON line; per width of phase 13 a frame end to end,
   K3 over its rays, K5 at 196,608 points, K4 frozen at 1024 x 128, K6
   frozen and K6 full at 196,608 points, K1 and K4 full at 1024 x 128 (K6
   full, K1 and K4 full with the dW kernel's share by torch.profiler and
   their operand bytes), each held against its plain version and timed
   beside its bound, and the replayed pose-opt, hierarchical, fused and
   invariant-depth train steps, with a `wide` JSON line), prints one
   `kernels` JSON line and, last, {"ok": true, "device": {...}}.
It exits non-zero, and prints no result, when CUDA is missing, outside a
checkout, or when any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
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
BWD_CHECK_RAYS = 301         # no multiple of the card's 132 SMs
CLI_EPOCHS = 2               # cli.train on the 8-frame synthetic scene: 8 steps per epoch
POSE_OPT_EPOCHS = 20         # eval_pose.opt_pose_epoch for the check (default 1000)
UNFUSED_STEPS = 4
POINT_CHECK_M = 196_608 + 37   # the fine pass's points per train step, made ragged
N_IMPORTANCE = 64            # hierarchical fine samples per ray on the K5/K6 path
HIER_STEPS = 4
DENSITY_SHIFT = -4.0         # density bias of the seeded weights: keeps transmittance alive
                             # to the last of the 128 samples, so the composite and its
                             # backward are exercised whole
DISK_FRAMES = 6              # frames per scene on disk: frame 4 is the eval split (sample
                             # rate 8), so an epoch is 5 train steps
# The three configurations' own keys, as configs/LLFF/fern.yaml, configs/Tanks/
# Ballroom.yaml and configs/V_KITTI/straight_d4.yaml set them (the card's machine
# has no PyYAML; tests/test_torch_cli_disk.py holds them equal to the files).
DISK_CONFIGS = {
    "fern": {
        "dataloading": {"path": "data/nerf_llff_data", "scene": ["fern"], "random_ref": 1,
                        "resize_factor": 4},
        "depth": {"type": None},
        "pose": {"learn_pose": True},
        "rendering": {"depth_range": [0.0, 1.0], "dist_alpha": True, "sample_option": "ndc"},
        "training": {"out_dir": "out/llff/fern", "vis_resolution": [75, 100]},
        "extract_images": {"resolution": [756, 1008]}},
    "Ballroom": {
        "dataloading": {"path": "data/Tanks", "scene": ["Ballroom"], "customized_focal": False,
                        "random_ref": 1},
        "depth": {"type": None},
        "pose": {"learn_pose": True},
        "training": {"out_dir": "out/Tanks/Ballroom", "auto_scheduler": True},
        "extract_images": {"resolution": [540, 960]}},
    "straight_d4": {
        "dataloading": {"path": "data/V_KITTI", "scene": ["straight"], "resize_factor": 2,
                        "customized_focal": True, "customized_poses": False,
                        "load_colmap_poses": True, "random_ref": 1, "with_depth": True,
                        "depth_scale": 0.01, "sparsify_depth": True,
                        "sparsify_depth_pattern": [1, 3, 1, 3]},
        "depth": {"type": None},
        "pose": {"learn_pose": True, "init_pose": True, "init_pose_type": "colmap",
                 "init_R_only": False, "learn_R": False, "learn_t": False,
                 "learn_focal": False, "update_focal": True},
        "distortion": {"learn_distortion": True, "learn_scale": False, "learn_shift": False},
        "training": {"out_dir": "out/V_KITTI/straight_d4", "depth_loss_type": "l1",
                     "match_method": "dense", "with_ssim": False, "auto_scheduler": True},
        "extract_images": {"resolution": [188, 621], "eval_depth": True,
                           "traj_option": "interp", "bspline_degree": 100}},
}
DISK_SIZES = {"fern": (756, 1008), "Ballroom": (540, 960), "straight_d4": (375, 1242)}
# Ballroom's frames as JPEG files (tools/jpeg_writer.py): 4:2:0 at quality 95 but for
# these frames
BALLROOM_JPEG = {0: {"sampling": "4:4:4"}, 1: {"sampling": "4:2:2", "restart_interval": 4},
                 2: {"orientation": 1}}
# Phase 8 on phase 7's straight scene: configs/V_KITTI/preprocess_straight.yaml writes its
# DPT priors, configs/V_KITTI/straight_d2.yaml trains on them (their keys, as above;
# tests/test_torch_preprocess.py holds them equal to the files)
PREP_CONFIGS = {
    "preprocess_straight": {
        "dataloading": {"path": "data/V_KITTI", "scene": ["straight"], "resize_factor": 2,
                        "customized_focal": True, "customized_poses": False,
                        "load_colmap_poses": True},
        "depth": {"type": "DPT"},
        "training": {"mode": "all"}},
    "straight_d2": {
        "dataloading": {"path": "data/V_KITTI", "scene": ["straight"], "resize_factor": 2,
                        "customized_focal": True, "customized_poses": False,
                        "load_colmap_poses": True, "random_ref": 1},
        "depth": {"type": None},
        "pose": {"learn_pose": True, "init_pose": True, "init_pose_type": "colmap",
                 "init_R_only": False, "learn_R": False, "learn_t": False,
                 "learn_focal": False, "update_focal": True},
        "distortion": {"learn_distortion": True},
        "training": {"out_dir": "out/V_KITTI/straight_d2", "depth_loss_type": "l1",
                     "match_method": "dense", "with_ssim": False, "auto_scheduler": True},
        "extract_images": {"resolution": [188, 621], "eval_depth": True,
                           "traj_option": "interp", "bspline_degree": 100}},
}
DPT_INPUT = (384, 1280)      # a 188x621 V-KITTI frame after the DPT input transform
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


def held(got: dict, want: dict, per_sample) -> tuple:
    """(worst absolute error, the block furthest into its tolerance, its share
    of it, every block's share) of a kernel's gradient blocks against its plain
    version's, by grad_share; the blocks named in `per_sample` are per ray or
    per sample."""
    shares = {k: grad_share(got[k], want[k], k in per_sample) for k in want}
    k_worst = max(shares, key=shares.get)
    return max(max_err(got[k], want[k]) for k in want), k_worst, shares[k_worst], shares


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


def issue_floor_text(sass, pairs: int, kernel_ms: float) -> str:
    """The issue floor of a Chamfer sweep: its hot loop's SASS instructions per
    pair (nope_nerf_torch/tools/chamfer_profile.py) at 132 SMs x 4
    warp-instructions a clock x 1.98 GHz."""
    from nope_nerf_torch.tools.chamfer_profile import issue_floor_ms
    if sass is None:
        return "issue floor not measured (no cuobjdump, or no hot loop found)"
    floor = issue_floor_ms(sass[0], pairs)
    return (f"{sass[0]:.2f} SASS instructions per pair in the hot loop -> issue floor "
            f"{floor:.4f} ms (kernel alone {kernel_ms / floor:.2f} x)")


def check_render_fwd(torch, dev, gen) -> float:
    """K3 against its plain version over {softplus, relu} x dist_alpha x want_aux
    at 128 samples and D=256; then at the shared-memory-tight 1024 samples at
    both widths, on a ray count that is no multiple of the card's SMs."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import (pack_rays, render_rays_fused,
                                                  render_rays_fused_plain)
    worst = 0.0

    def held(gen, D, S, n_rays, occ, dist_alpha, want_aux, label):
        nonlocal worst
        ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=dist_alpha,
                          use_pallas=True)
        params = init_nerf_params(ncfg, gen, device=dev)
        origin = torch.randn(n_rays, 3, generator=gen) * 3.0
        ray_vec = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=gen), dim=1)
        rays = pack_rays(origin, ray_vec, -ray_vec).to(dev)
        z = torch.sort(0.01 + 9.99 * torch.rand(n_rays, S, generator=gen), dim=1).values.to(dev)
        for aux in want_aux:
            got = render_rays_fused(params, rays, z, ncfg, dist_alpha, aux)
            torch.cuda.synchronize()
            ref = render_rays_fused_plain(params, rays, z, ncfg, dist_alpha, aux)
            report = []
            for name, g, r in zip(("rgb", "dist", "weights", "alpha"), got, ref):
                if r is None:
                    continue
                err, tol = max_err(g, r), tolerance(r)
                worst = max(worst, err)
                report.append(f"{name} {err:.3g}/{tol:.3g}")
                if not err <= tol:
                    raise RuntimeError(f"render_fwd disagrees with its plain version: "
                                       f"{name} err {err} > {tol} (D={D}, S={S}, occ={occ}, "
                                       f"dist_alpha={dist_alpha}, want_aux={aux})")
            print(f"render_fwd vs plain, {label}occ={occ} dist_alpha={dist_alpha} "
                  f"want_aux={aux}: " + ", ".join(report))

    for occ in ("softplus", "relu"):
        for dist_alpha in (False, True):
            held(gen, 256, 128, CHECK_RAYS, occ, dist_alpha, (False, True), "")
    # a generator of their own: the later phases draw the same inputs as before
    gen_s = torch.Generator().manual_seed(SEED + 6)
    for D in (256, 128):
        for occ, dist_alpha in (("softplus", False), ("relu", True)):
            held(gen_s, D, 1024, BWD_CHECK_RAYS, occ, dist_alpha, (True,),
                 f"D={D} S=1024 {BWD_CHECK_RAYS} rays, ")
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


def bwd_cotangents(torch, params, rays, z, tgt, ncfg, dist_alpha: bool, aux: bool):
    """Cotangents for the render-backward kernel, those of a smooth loss of the
    forward's own outputs: 0.7 mean|rgb - gt|^2 + 0.3 mean (dist - dgt)^2 and,
    with `aux`, + mean over rays of sum(weights[:, ::7]^2) + sum(alpha[:, 5])."""
    from nope_nerf_torch.ops.fused_render import TGT_DEPTH, render_rays_fused_plain
    rgb, dist, weights, alpha = render_rays_fused_plain(params, rays, z, ncfg, dist_alpha, True)
    n = rays.shape[0]
    g_rgb = (1.4 / n * (rgb - tgt[:, 0:3])).contiguous()
    g_dist = (0.6 / n * (dist - tgt[:, TGT_DEPTH])).contiguous()
    if not aux:
        return g_rgb, g_dist, None, None
    g_w = torch.zeros_like(weights)
    g_w[:, ::7] = 2.0 / n * weights[:, ::7]
    g_a = torch.zeros_like(alpha)
    g_a[:, 5] = 1.0 / n
    return g_rgb, g_dist, g_w, g_a


def check_render_bwd(torch, dev, gen):
    """K4 against its plain version over {softplus, relu} x head dist_alpha x
    renderer dist_alpha x {rgb and dist cotangents only, all four}: the full
    variant, two launches bit-equal, and the frozen-network variant's d(rays)
    and dz equal to the full one's. Then the train kernel's own cotangents fed
    through K4, which must give K1's gradients. Returns (worst absolute error
    of a gradient entry, the same over d(rays) and dz alone, which are all the
    frozen-network variant returns, worst error as a share of its tolerance)."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import (_render_bwd_cuda, _train_cuda,
                                                  render_rays_fused_bwd_plain, unpack_grads)
    rays, z, tgt = train_inputs(torch, dev, gen, BWD_CHECK_RAYS)
    worst_abs, worst_abs_frozen, worst_share, failed = 0.0, 0.0, 0.0, []

    def flat(out):
        return [*out[0], *out[1], out[2], out[3]]

    for occ in ("softplus", "relu"):
        for head_da in (False, True):
            ncfg = NerfConfig(hidden_dim=256, occ_activation=occ, dist_alpha=head_da,
                              use_pallas=True)
            params = init_nerf_params(ncfg, gen, device=dev)
            if occ == "softplus" and not head_da:
                params["density_b"] = params["density_b"] + DENSITY_SHIFT   # see check_render_train
            for dist_alpha in (False, True):
                for aux in (False, True):
                    cot = bwd_cotangents(torch, params, rays, z, tgt, ncfg, dist_alpha, aux)
                    a = _render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha)
                    b = _render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha)
                    frozen = _render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha,
                                              want_param_grads=False)
                    torch.cuda.synchronize()
                    case = (f"occ={occ} head_dist_alpha={head_da} dist_alpha={dist_alpha} "
                            f"cotangents={'rgb,dist,weights,alpha' if aux else 'rgb,dist'}")
                    if not all(torch.equal(x, y) for x, y in zip(flat(a), flat(b))):
                        raise RuntimeError(f"render_bwd: two launches differ ({case})")
                    if not (frozen[0] is None and torch.equal(frozen[2], a[2])
                            and torch.equal(frozen[3], a[3])):
                        raise RuntimeError(f"render_bwd: the frozen-network variant's d(rays), dz "
                                           f"differ from the full variant's ({case})")
                    ref = render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, dist_alpha)
                    got = dict(unpack_grads(a[0], a[1], ncfg), rays=a[2], z=a[3])
                    want = dict(unpack_grads(ref[0], ref[1], ncfg), rays=ref[2], z=ref[3])
                    shares = {k: grad_share(got[k], want[k], k in ("rays", "z")) for k in want}
                    k_worst = max(shares, key=shares.get)
                    worst_share = max(worst_share, shares[k_worst])
                    worst_abs = max(worst_abs, max(max_err(got[k], want[k]) for k in want))
                    worst_abs_frozen = max(worst_abs_frozen, max_err(frozen[2], ref[2]),
                                           max_err(frozen[3], ref[3]))
                    print(f"render_bwd vs plain, {case}: {len(shares)} gradient blocks, worst "
                          f"{k_worst} at {shares[k_worst]:.3f} of its tolerance (rays "
                          f"{shares['rays']:.3f}, z {shares['z']:.3f}, largest weight block "
                          f"{max(v for k, v in shares.items() if k.endswith('_w')):.3f}); two "
                          f"launches bit-equal; frozen-network variant equal")
                    if not shares[k_worst] <= 1.0:
                        failed.append(f"{k_worst} at {shares[k_worst]:.2f} of its tolerance "
                                      f"({case})")
    if failed:
        raise RuntimeError("render_bwd disagrees with its plain version: " + "; ".join(failed))

    # K1 forms g_rgb = w_rgb d|rgb-gt|^p and g_dist = w_depth m sign(dist-dgt) itself and
    # writes their negatives into d(tgt): fed to K4, they must reproduce K1's gradients
    ncfg = NerfConfig(hidden_dim=256, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=dev)
    params["density_b"] = params["density_b"] + DENSITY_SHIFT
    for rgb_p in (1, 2):
        _, dWs, dBs, drays, dz, dtgt = _train_cuda(params, rays, z, tgt, ncfg, False, rgb_p, False)
        out = _render_bwd_cuda(params, rays, z, (-dtgt[:, 0:3]).contiguous(),
                               (-dtgt[:, 3]).contiguous(), None, None, ncfg, False)
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for x, y in zip([*dWs, *dBs, drays, dz], flat(out)))
        print(f"render_bwd on render_train's cotangents, rgb_p={rgb_p}: dW, dB, d(rays), dz "
              f"bit-equal to render_train's: {equal}")
        if not equal:
            raise RuntimeError("render_bwd does not reproduce render_train's gradients from "
                               "its cotangents")
    return worst_abs, worst_abs_frozen, worst_share


def point_inputs(torch, dev, gen, m: int):
    """Seeded points in the occupied part of the scene cube and unit directions."""
    pts = (torch.randn(m, 3, generator=gen) * 1.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(m, 3, generator=gen), dim=1).to(dev)
    return pts, dirs


def check_point_mlp_fwd(torch, dev, gen) -> float:
    """K5 against its plain version over {softplus, relu} x head dist_alpha at a
    ragged M (no multiple of the 128-point pass). Returns the worst error."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_mlp import _mlp_fwd_cuda, point_mlp_fwd_plain
    pts, dirs = point_inputs(torch, dev, gen, POINT_CHECK_M)
    worst = 0.0
    for occ in ("softplus", "relu"):
        for head_da in (False, True):
            ncfg = NerfConfig(hidden_dim=256, occ_activation=occ, dist_alpha=head_da,
                              use_pallas=True)
            params = init_nerf_params(ncfg, gen, device=dev)
            got = _mlp_fwd_cuda(params, pts, dirs, ncfg)
            torch.cuda.synchronize()
            ref = point_mlp_fwd_plain(params, pts, dirs, ncfg)
            report = []
            for name, g, r in zip(("rgb", "density"), got, ref):
                err, tol = max_err(g, r), tolerance(r)
                worst = max(worst, err)
                report.append(f"{name} {err:.3g}/{tol:.3g}")
                if not err <= tol:
                    raise RuntimeError(f"point_mlp_fwd disagrees with its plain version: {name} "
                                       f"err {err} > {tol} (occ={occ}, head_dist_alpha={head_da})")
            print(f"point_mlp_fwd vs plain, {POINT_CHECK_M} points, occ={occ} "
                  f"head_dist_alpha={head_da}: " + ", ".join(report))
    return worst


def point_cotangents(torch, params, pts, dirs, ncfg):
    """Cotangents for the point-query MLP backward, those of a smooth loss of
    the forward's own outputs (tests/test_pallas_mlp.py's): mean over points
    of |rgb - 0.5|^2 / 3 + 0.1 density. Cotangents that are noise instead
    (zero-mean, independent per point) make every gradient block a random
    walk over the points, and a single flipped bf16 rounding or ReLU mask
    then moves a bias gradient by a share of its largest entry that real
    training never sees."""
    from nope_nerf_torch.ops.fused_mlp import point_mlp_fwd_plain
    rgb, _ = point_mlp_fwd_plain(params, pts, dirs, ncfg)
    m = pts.shape[0]
    g_rgb = (2.0 / (3 * m) * (rgb - 0.5)).contiguous()
    return g_rgb, torch.full((m, 1), 0.1 / m, device=pts.device)


def check_point_mlp_bwd(torch, dev, gen):
    """K6 against its plain version over {softplus, relu} x head dist_alpha at
    the same ragged M, on the cotangents of a smooth loss: weight and bias
    blocks within 5e-3 of each block's largest entry, d(points) and
    d(directions) by the per-sample rule (grad_share), two launches bit-equal;
    then its frozen-network variant (point_mlp_bwd_frozen.cu): d(points) and
    d(directions) bit-equal to the full variant's, held against the frozen
    plain version. Returns (worst absolute error of a gradient entry, worst
    share of its tolerance, the frozen variant's worst absolute error)."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_mlp import _mlp_bwd_cuda, point_mlp_bwd_plain
    from nope_nerf_torch.ops.fused_render import unpack_grads
    pts, dirs = point_inputs(torch, dev, gen, POINT_CHECK_M)
    worst_abs, worst_share, worst_frozen, failed = 0.0, 0.0, 0.0, []
    for occ in ("softplus", "relu"):
        for head_da in (False, True):
            ncfg = NerfConfig(hidden_dim=256, occ_activation=occ, dist_alpha=head_da,
                              use_pallas=True)
            params = init_nerf_params(ncfg, gen, device=dev)
            g_rgb, g_den = point_cotangents(torch, params, pts, dirs, ncfg)
            a = _mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)
            b = _mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg)
            frozen = _mlp_bwd_cuda(params, pts, dirs, g_rgb, g_den, ncfg, want_param_grads=False)
            torch.cuda.synchronize()
            case = f"occ={occ} head_dist_alpha={head_da}"
            flat_a, flat_b = [*a[0], *a[1], a[2], a[3]], [*b[0], *b[1], b[2], b[3]]
            if not all(torch.equal(x, y) for x, y in zip(flat_a, flat_b)):
                raise RuntimeError(f"point_mlp_bwd: two launches differ ({case})")
            ref = point_mlp_bwd_plain(params, pts, dirs, g_rgb, g_den, ncfg)
            got = dict(unpack_grads(a[0], a[1], ncfg), points=a[2], directions=a[3])
            want = dict(unpack_grads(ref[0], ref[1], ncfg), points=ref[2], directions=ref[3])
            shares = {k: grad_share(got[k], want[k], k in ("points", "directions"))
                      for k in want}
            k_worst = max(shares, key=shares.get)
            worst_share = max(worst_share, shares[k_worst])
            worst_abs = max(worst_abs, max(max_err(got[k], want[k]) for k in want))
            print(f"point_mlp_bwd vs plain, {POINT_CHECK_M} points, {case}: {len(shares)} "
                  f"gradient blocks, worst {k_worst} at {shares[k_worst]:.3f} of its tolerance "
                  f"(points {shares['points']:.3f}, directions {shares['directions']:.3f}, "
                  f"largest weight block "
                  f"{max(v for k, v in shares.items() if k.endswith('_w')):.3f}); two launches "
                  f"bit-equal")
            if not shares[k_worst] <= 1.0:
                failed.append(f"{k_worst} at {shares[k_worst]:.2f} of its tolerance ({case})")
            if not (frozen[0] is None and torch.equal(frozen[2], a[2])
                    and torch.equal(frozen[3], a[3])):
                raise RuntimeError(f"point_mlp_bwd: the frozen-network variant's d(points), "
                                   f"d(directions) differ from the full variant's ({case})")
            fref = point_mlp_bwd_plain(params, pts, dirs, g_rgb, g_den, ncfg,
                                       want_param_grads=False)
            fshares = {k: grad_share(g, r, True) for k, g, r in
                       (("points", frozen[2], fref[2]), ("directions", frozen[3], fref[3]))}
            worst_frozen = max(worst_frozen, max_err(frozen[2], fref[2]),
                               max_err(frozen[3], fref[3]))
            print(f"point_mlp_bwd frozen-network variant, {POINT_CHECK_M} points, {case}: "
                  f"d(points), d(directions) bit-equal to the full variant's; vs the frozen "
                  f"plain version points {fshares['points']:.3f}, directions "
                  f"{fshares['directions']:.3f} of their tolerance")
            if not max(fshares.values()) <= 1.0:
                failed.append(f"frozen variant at {max(fshares.values()):.2f} of its tolerance "
                              f"({case})")
    if failed:
        raise RuntimeError("point_mlp_bwd disagrees with its plain version: " + "; ".join(failed))
    return worst_abs, worst_share, worst_frozen


def dw_operands(torch, dev, gen, shapes, m: int, poison: bool):
    """Seeded bf16 operands X (m, K), G (m, N) for each (K, N) and their
    tiled copies; with poison, the padding rows of the last row tile are NaN
    (the kernel must read rows past m as zero)."""
    from nope_nerf_torch.ops.fused_mlp import DW_ROWS, tile_operand
    xs, gs, xt, gt = [], [], [], []
    for K, N in shapes:
        x = torch.randn(m, K, generator=gen).to(dev).to(torch.bfloat16)
        g = torch.randn(m, N, generator=gen).to(dev).to(torch.bfloat16)
        X, G = tile_operand(x), tile_operand(g)
        if poison and m % DW_ROWS:
            X[-1, :, m % DW_ROWS:] = float("nan")
            G[-1, :, m % DW_ROWS:] = float("nan")
        xs.append(x)
        gs.append(g)
        xt.append(X)
        gt.append(G)
    return xs, gs, xt, gt


def check_dw(torch, dev, gen) -> float:
    """The weight-gradient kernel (dw_sm90.cuh) on its own against dw_plain,
    over every block shape of K6's work table at D = 256, at M = 1, 127, 128
    and POINT_CHECK_M, with the padding rows NaN: each entry within 1e-4 of
    the sum of its products' magnitudes (f32 sums of up to 33,000 terms a
    chunk, in the tensor cores' order against matmul's), two launches
    bit-equal. Returns the worst absolute error."""
    from nope_nerf_torch.ops.fused_mlp import (dw_chunks, dw_cta_tiles, dw_plain, dw_sm90,
                                               point_dw_table)
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = sorted({(K, N) for *_, K, N in point_dw_table(256)})
    Ks = [K for K, _ in shapes]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst_abs, failed = 0.0, []
    for m in (1, 127, 128, POINT_CHECK_M):
        xs, gs, xt, gt = dw_operands(torch, dev, gen, shapes, m, poison=True)
        chunks = dw_chunks(dw_cta_tiles(Ks), m, sms)
        a = dw_sm90(xt, gt, Ks, m, chunks)
        b = dw_sm90(xt, gt, Ks, m, chunks)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise RuntimeError(f"dw_sm90: two launches differ (M = {m})")
        share = 0.0
        for got, x, g in zip(a, xs, gs):
            ref = dw_plain(x, g, chunks)
            mag = x.float().abs().t() @ g.float().abs()
            err = (got - ref).abs()
            worst_abs = max(worst_abs, float(err.max()))
            share = max(share, float((err / (1e-4 * mag + 1e-30)).max()))
        print(f"dw_sm90 vs plain, {m} points, {chunks} chunks: {len(shapes)} block shapes "
              f"{shapes}, worst entry at {share:.3g} of its tolerance; two launches bit-equal")
        if not share <= 1.0:
            failed.append(f"M = {m} at {share:.3g} of its tolerance")
    if failed:
        raise RuntimeError("dw_sm90 disagrees with its plain version: " + "; ".join(failed))
    return worst_abs


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
    # the partials leave no trace of the order the blocks ran in
    x, y = cases[0][1]
    first, again = nearest_idx_bidirectional(x, y), nearest_idx_bidirectional(x, y)
    same = all(torch.equal(a, b) and a.dtype == torch.int64 for a, b in zip(first, again))
    print(f"chamfer_bidir, {cases[0][0]}: two launches bit-equal, int64 indices: {same}")
    if not same:
        raise RuntimeError("chamfer_bidir: two launches differ")
    return worst


def edge_duplicate_clouds(torch, gen, s: int, d: int):
    """Two random clouds (s,3), (d,3) in which, for each cloud as dst, the
    point before every segment edge of K7's grid (ops/chamfer.py::
    nearest_geometry) is copied onto the point after it, and one point of the
    other cloud is moved to 1e-3 from that pair: an exact tie across the edge,
    which the earlier segment must win. Returns (x, y, {direction: (src rows,
    the dst indices they must get)})."""
    from nope_nerf_torch.ops.chamfer import nearest_geometry
    x = torch.rand(s, 3, generator=gen) * 6 - 3
    y = torch.rand(d, 3, generator=gen) * 6 - 3
    edges = {}
    for direction, src, dst in (("x->y", x, y), ("y->x", y, x)):
        seg = nearest_geometry(src.shape[0], dst.shape[0]).seg_len
        edges[direction] = torch.arange(seg, dst.shape[0], seg)
        dst[edges[direction]] = dst[edges[direction] - 1]
    pinned = {}
    for direction, other, src, dst in (("x->y", "y->x", x, y), ("y->x", "x->y", y, x)):
        # src rows that hold no duplicate of the other direction
        taken = set(edges[other].tolist()) | set((edges[other] - 1).tolist())
        rows = torch.tensor([i for i in range(src.shape[0]) if i not in taken]
                            [:len(edges[direction])], dtype=torch.int64)
        e = edges[direction][:len(rows)]
        src[rows] = dst[e] + torch.tensor([1e-3, 0.0, 0.0])
        pinned[direction] = (rows, e - 1)
    return x, y, pinned


def check_chamfer_nearest(torch, dev, gen) -> float:
    """K7 against its plain version: d2 and indices bit-equal (both round each
    product and sum at the same place), at the Chamfer clouds of the LLFF and
    Tanks train steps (189x252 = 47,628 and 135x240 = 32,400 depth-lifted
    points), ragged shapes and a lattice, both directions; then the gradient
    of nearest_dists against its plain route (the same ops but for the sweep;
    index_add_ sums d(dst) with atomics, so within 1e-6 of the largest entry).
    Returns the worst d2 difference (0 when bit-equal)."""
    from nope_nerf_torch.ops.chamfer import nearest_dists, nearest_idx, nearest_idx_plain
    from nope_nerf_torch.ops.fused_render import plain_versions
    side = torch.arange(18.0)
    lattice = torch.stack(torch.meshgrid(side, side, side, indexing="ij"), -1).reshape(-1, 3)
    lx = (lattice + 0.1 * (torch.rand(lattice.shape, generator=gen) - 0.5)).to(dev)
    ly = (lattice[torch.randperm(len(lattice), generator=gen)]
          + 0.1 * (torch.rand(lattice.shape, generator=gen) - 0.5)).to(dev)
    cases = [("47628 x 47628 depth-lifted (LLFF 189x252)", depth_lifted_clouds(torch, dev, gen, 189, 252)),
             ("32400 x 32400 depth-lifted (Tanks 135x240)", depth_lifted_clouds(torch, dev, gen, 135, 240)),
             ("301 x 77 ragged", ((torch.rand(301, 3, generator=gen) * 6 - 3).to(dev),
                                  (torch.rand(77, 3, generator=gen) * 6 - 3).to(dev))),
             ("5 x 40000", ((torch.rand(5, 3, generator=gen) * 6 - 3).to(dev),
                            (torch.rand(40000, 3, generator=gen) * 6 - 3).to(dev))),
             (f"{len(lattice)} lattice points", (lx, ly))]
    # its own generator: the phases after it draw the inputs they drew before it existed
    egen = torch.Generator().manual_seed(SEED + 13)
    edge_pinned = {}
    for s, d in ((47628, 47628), (300, 40000)):
        x, y, pinned = edge_duplicate_clouds(torch, egen, s, d)
        cases.append((f"{s} x {d} with duplicates across every segment edge",
                      (x.to(dev), y.to(dev))))
        edge_pinned[cases[-1][0]] = pinned
    worst = 0.0
    for name, (x, y) in cases:
        for direction, src, dst in (("x->y", x, y), ("y->x", y, x)):
            d2_k, i_k = nearest_idx(src, dst)
            d2_a, i_a = nearest_idx(src, dst)
            torch.cuda.synchronize()
            d2_p, i_p = nearest_idx_plain(src, dst)
            same_i, same_d2 = torch.equal(i_k, i_p), torch.equal(d2_k, d2_p)
            again = torch.equal(i_a, i_k) and torch.equal(d2_a, d2_k)
            worst = max(worst, float((d2_k - d2_p).abs().max()))
            line = (f"chamfer_nearest vs plain, {name} {direction}: indices equal {same_i}, d2 "
                    f"bit-equal {same_d2}, two launches bit-equal {again}")
            if name in edge_pinned:
                src_rows, want = edge_pinned[name][direction]
                lowest = torch.equal(i_k[src_rows.to(dev)].cpu(), want)
                line += f", the lower of each duplicate pair wins {lowest}"
                same_i = same_i and lowest
            print(line)
            if not (same_i and same_d2 and again):
                raise RuntimeError(f"chamfer_nearest differs from its plain version ({name}, "
                                   f"{direction}): worst d2 gap {worst}")
    x, y = cases[1][1]
    w = (0.5 + torch.rand(x.shape[0], generator=gen)).to(dev)

    def grads():
        xs, ys = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        (w * nearest_dists(xs, ys)).sum().backward()
        return xs.grad, ys.grad

    g_k = grads()
    with plain_versions():
        g_p = grads()
    for name, a, b in (("src", g_k[0], g_p[0]), ("dst", g_k[1], g_p[1])):
        err, top = max_err(a, b), float(b.abs().max())
        print(f"nearest_dists gradient into {name} vs the plain route: {err:.3g} of {top:.3g}")
        if not err <= 1e-6 * top:
            raise RuntimeError(f"nearest_dists: gradient into {name} differs from the plain route")
    return worst


def novel_view0(torch, dev, cfg, rcfg, scene, params):
    """(the novel trajectory cli.render takes, view0_inputs): view0_inputs(rows,
    points=0) gives the fused render's (ray table, z, ray norms) of the first
    `rows` rows of novel view 0 at RESOLUTION (at `points` samples, else
    rcfg's)."""
    from nope_nerf_torch.cli.render import novel_trajectory
    from nope_nerf_torch.geometry.camera import pixel_grid, rigid_inverse
    from nope_nerf_torch.ops.render import _ray_geometry, fused_inputs
    h, w = RESOLUTION
    traj = novel_trajectory(cfg, scene, params)
    camera_mat = torch.as_tensor(scene.K, device=dev)
    world_mat = rigid_inverse(torch.as_tensor(traj[0], device=dev))
    pixels = torch.from_numpy(pixel_grid(RESOLUTION)[1]).to(dev)
    ones = torch.ones((h * w, 1), device=dev)

    def view0_inputs(rows: int, points: int = 0):
        rc = dataclasses.replace(rcfg, num_points=points) if points else rcfg
        geo = _ray_geometry(pixels[:rows * w], ones[:rows * w], camera_mat, world_mat, None,
                            None, rc, False)
        table, z = fused_inputs(geo, rc)
        return table, z, geo["ray_norm"]

    return traj, view0_inputs


def run_render_path(torch, np, dev, gen):
    """Phase 3. Returns what the timings need: (launches, params, traj, scene, ncfg, rcfg)."""
    from nope_nerf_torch.cli.render import load_scene, render
    from nope_nerf_torch.config import DEFAULTS, update_recursive
    from nope_nerf_torch.geometry.lie import log_so3
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import (RENDER_FWD, render_rays_fused,
                                                  render_rays_fused_plain)
    from nope_nerf_torch.ops.render import RenderConfig
    from nope_nerf_torch.training.checkpoints import load_params, save_params

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
        save_params(out_dir, cfg["extract_images"]["model_file"], params)

        RENDER_FWD.launches = 0
        frames = render(cfg, synthetic="driving", device=dev, save=False)
        launches = RENDER_FWD.launches
        params, _ = load_params(out_dir, cfg["extract_images"]["model_file"], device=dev)

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
    traj, view0_inputs = novel_view0(torch, dev, cfg, rcfg, scene, params)
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
    from nope_nerf_torch.ops.fused_mlp import DW_SM90
    from nope_nerf_torch.ops.fused_render import RENDER_FWD, RENDER_TRAIN, plain_versions
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
    with plain_versions():
        g_p, ld_p = step_gradients(state.params, batch, weights, ray_idx, None, mc,
                                   rgb_loss_type, noise=noise)
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
               "render_fwd": RENDER_FWD, "dw_sm90": DW_SM90}
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
          f"render_fwd {counts['render_fwd']}, dw_sm90 {counts['dw_sm90']} (expected "
          f"{TRAIN_STEPS}, {TRAIN_STEPS}, 0, {TRAIN_STEPS})")
    if (counts["render_train"], counts["chamfer_bidir"], counts["render_fwd"],
            counts["dw_sm90"]) != (TRAIN_STEPS, TRAIN_STEPS, 0, TRAIN_STEPS):
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


def kernel_counters():
    from nope_nerf_torch.ops.chamfer import CHAMFER_BIDIR, CHAMFER_NEAREST
    from nope_nerf_torch.ops.fused_mlp import (DW_SM90, POINT_MLP_BWD, POINT_MLP_BWD_FROZEN,
                                               POINT_MLP_FWD)
    from nope_nerf_torch.ops.fused_render import (RENDER_BWD, RENDER_BWD_FROZEN, RENDER_FWD,
                                                  RENDER_TRAIN)
    return {"render_train": RENDER_TRAIN, "chamfer_bidir": CHAMFER_BIDIR,
            "render_fwd": RENDER_FWD, "render_bwd": RENDER_BWD,
            "render_bwd_frozen": RENDER_BWD_FROZEN, "point_mlp_fwd": POINT_MLP_FWD,
            "point_mlp_bwd": POINT_MLP_BWD, "point_mlp_bwd_frozen": POINT_MLP_BWD_FROZEN,
            "chamfer_nearest": CHAMFER_NEAREST, "dw_sm90": DW_SM90}


def counted(fn, expected: dict, what: str):
    """Run fn() with every kernel's launch count set to 0 just before and read
    just after; fail unless the counts are `expected` (a kernel it does not
    name: 0). render_bwd counts both variants of the render-backward kernel,
    render_bwd_frozen those of its frozen-network variant among them;
    point_mlp_bwd and point_mlp_bwd_frozen likewise for K6; dw_sm90 counts
    the weight-gradient kernel, which K6's full variant launches once and K1
    and K4's full variant once per chunk of rays (render_chunks), as they
    launch their own chain kernel.
    Returns (fn's result, counts)."""
    import torch
    libs = kernel_counters()
    expected = {name: expected.get(name, 0) for name in libs}
    for lib in libs.values():
        lib.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: lib.launches for name, lib in libs.items()}
    order = ("render_train", "chamfer_bidir", "render_fwd", "render_bwd", "render_bwd_frozen",
             "point_mlp_fwd", "point_mlp_bwd", "point_mlp_bwd_frozen", "chamfer_nearest",
             "dw_sm90")
    print(f"{what}: launches " + ", ".join(f"{k} {counts[k]}" for k in order) + " (expected "
          + ", ".join(str(expected[k]) for k in order) + ")")
    if counts != expected:
        raise RuntimeError(f"{what}: launch counts {counts}, expected {expected}")
    return out, counts


def states_bit_equal(torch, a, b) -> bool:
    """Parameters, Adam moments and counts, iteration counter, generator state."""
    same = a.it == b.it and torch.equal(a.generator.get_state(), b.generator.get_state())
    for g, d in a.params.items():
        same = same and a.opt_state[g].count == b.opt_state[g].count
        for k, v in d.items():
            same = (same and torch.equal(v, b.params[g][k])
                    and torch.equal(a.opt_state[g].mu[k], b.opt_state[g].mu[k])
                    and torch.equal(a.opt_state[g].nu[k], b.opt_state[g].nu[k]))
    return bool(same)


def run_cli_path(torch, np, dev):
    """Phase 5a: the train CLI, its resume, the eval CLI with test-time pose
    optimisation and the pose-eval CLI, at the full model width on the
    built-in 8-frame 120x160 synthetic scene. Returns (launch counts of the
    eval run, what the timings need)."""
    from nope_nerf_torch.cli.eval import evaluate, split_synthetic_scene
    from nope_nerf_torch.cli.eval_poses import evaluate_poses
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data.image_io import read_png
    from nope_nerf_torch.evaluation.pose_opt import (optimize_test_poses, pose_opt_loss)
    from nope_nerf_torch.models.poses import PoseConfig, init_pose_params
    from nope_nerf_torch.ops.fused_render import plain_versions
    from nope_nerf_torch.training import ModelConfigs

    steps = CLI_EPOCHS * 8

    def cfg_for(out_dir, **extra):
        over = {"training": {"out_dir": out_dir, "n_training_points": TRAIN_RAYS,
                             "vis_geo": False, "print_every": 8, "validate_every": 8,
                             "checkpoint_every": 8, "visualize_every": 0,
                             "vis_reprojection_every": 0},
                "pose": {"learn_pose": True, "init_pose": True},
                "eval_pose": {"opt_pose_epoch": POSE_OPT_EPOCHS, "n_points": TRAIN_RAYS,
                              "type_to_eval": "eval"}}
        for k, v in extra.items():
            over.setdefault(k, {}).update(v)
        return load_config(overrides=over)

    with tempfile.TemporaryDirectory() as root:
        # ---- cli.train: 2 epochs; validate renders the 120x160 frame at it 0 and 8
        cfg = cfg_for(os.path.join(root, "a"))
        (state_a, _, _), _ = counted(
            lambda: train(cfg, synthetic=True, max_epochs=CLI_EPOCHS, device=dev),
            {"render_train": steps, "chamfer_bidir": steps, "render_fwd": steps // 8,
             "dw_sm90": steps},
            f"cli.train, {CLI_EPOCHS} epochs of 8 steps")
        if state_a.it != steps - 1 or not os.path.exists(os.path.join(root, "a", "model.ckpt")):
            raise RuntimeError("cli.train: wrong iteration counter or no checkpoint")
        for group, d in state_a.params.items():
            if not all(bool(torch.isfinite(v).all()) for v in d.values()):
                raise RuntimeError(f"cli.train: non-finite parameter in group {group}")

        # ---- resume: 1 epoch, checkpoint, resume 1 epoch = 2 epochs straight
        cfg_b = cfg_for(os.path.join(root, "b"))
        train(cfg_b, synthetic=True, max_epochs=1, device=dev)
        state_b, _, _ = train(cfg_b, synthetic=True, max_epochs=CLI_EPOCHS, device=dev)
        equal = states_bit_equal(torch, state_a, state_b)
        print(f"resume: 1 epoch + checkpoint + 1 epoch against {CLI_EPOCHS} epochs straight: "
              f"parameters, Adam state and generator bit-equal: {equal}")
        if not equal:
            raise RuntimeError("a resumed run differs from the same epochs run straight")

        # ---- cli.train with the visualize (rgb, depth, phong geometry) and
        # reprojection hooks: PNGs through the port's own writer, no imageio or cv2
        cfg_v = cfg_for(os.path.join(root, "v"), training={
            "visualize_every": 4, "vis_reprojection_every": 4, "vis_geo": True,
            "validate_every": 0})
        counted(lambda: train(cfg_v, synthetic=True, max_epochs=1, device=dev),
                {"render_train": 8, "chamfer_bidir": 8, "render_fwd": 2, "dw_sm90": 8},
                "cli.train with the visualize and reprojection hooks every 4 steps, 1 epoch")
        rendering = os.path.join(root, "v", "rendering")
        pngs = sorted(os.path.join(d, f) for d, _, files in os.walk(rendering) for f in files
                      if f.endswith(".png"))
        shapes = {os.path.relpath(p, rendering): read_png(p).shape for p in pngs}
        print(f"cli.train hooks wrote {len(pngs)} PNGs: " + ", ".join(
            f"{k} {v}" for k, v in shapes.items()))
        if len(pngs) != 2 * 3 + 2 * 2:
            raise RuntimeError(f"cli.train hooks: expected 10 PNGs, got {sorted(shapes)}")

        # ---- step 1 of the pose optimisation, kernels against the plain versions
        mc = ModelConfigs.from_cfg(cfg, num_cams=7)
        _, eval_scene, _ = split_synthetic_scene()
        nerf = {k: v.detach() for k, v in state_a.params["nerf"].items()}
        img = torch.as_tensor(eval_scene.imgs[0]).to(dev)
        cam = torch.as_tensor(eval_scene.K).to(dev)
        pcfg = PoseConfig(num_cams=1, use_init_c2w=True)
        ray_idx = torch.randperm(img.shape[0] * img.shape[1],
                                 generator=torch.Generator(device=dev).manual_seed(SEED + 4),
                                 device=dev)[:TRAIN_RAYS]

        def pose_grads():
            pose = init_pose_params(pcfg, torch.as_tensor(eval_scene.c2ws_gt), device=dev)
            leaves = {k: v.requires_grad_(k != "init_c2w") for k, v in pose.items()}
            loss = pose_opt_loss(leaves, nerf, None, img, 0, cam, ray_idx, pcfg, None, mc.nerf,
                                 mc.render)
            g_r, g_t = torch.autograd.grad(loss, [leaves["r"], leaves["t"]])
            return float(loss.detach()), {"r": g_r, "t": g_t}

        (loss_k, g_k), _ = counted(pose_grads, {"render_fwd": 1, "render_bwd": 1,
                                                "render_bwd_frozen": 1},
                                   "pose-opt step 1 through the kernels")
        with plain_versions():
            loss_p, g_p = pose_grads()
        report = []
        for k, ref in g_p.items():
            err, top = max_err(g_k[k], ref), float(ref.abs().max())
            report.append(f"pose/{k} {err:.3g} of {top:.3g}")
            if not err <= 5e-2 * top + 1e-9:
                raise RuntimeError(f"pose-opt step 1: gradient pose/{k} differs from the plain "
                                   f"versions' by {err} (largest entry {top})")
        if not abs(loss_k - loss_p) <= 2e-3 * abs(loss_p):
            raise RuntimeError(f"pose-opt step 1: loss {loss_k} differs from the plain {loss_p}")
        print(f"pose-opt step 1 vs plain versions: loss {loss_k:.6g} vs {loss_p:.6g}; gradient "
              "errors " + ", ".join(report))

        # ---- cli.eval: pose optimisation on the held-out frame, then its render
        n_eval = eval_scene.n_frames
        opt_steps = n_eval * POSE_OPT_EPOCHS
        summary, eval_counts = counted(
            lambda: evaluate(cfg, synthetic=True, device=dev, save=True),
            {"render_fwd": opt_steps + n_eval, "render_bwd": opt_steps,
             "render_bwd_frozen": opt_steps},
            f"cli.eval, {POSE_OPT_EPOCHS} pose-opt epochs on {n_eval} view, then its frame")
        for k in ("mean_mse", "mean_psnr", "mean_ssim"):
            if not math.isfinite(summary[k]):
                raise RuntimeError(f"cli.eval: {k} is not finite")
        extraction = os.path.join(root, "a", cfg["extract_images"]["extraction_dir"])
        saved = [os.path.join(extraction, sub, "0000.png") for sub in ("img_out", "img_gt_out")]
        shape = tuple(eval_scene.imgs.shape[1:])
        if not all(read_png(p).shape == shape for p in saved):
            raise RuntimeError("cli.eval with save: the view's PNGs are missing or misshapen")
        print(f"cli.eval with save: {', '.join(os.path.relpath(p, extraction) for p in saved)} "
              f"read back at {shape}")
        # the same optimisation by hand: the pose must move and stay finite
        init = np.asarray(eval_scene.c2ws_gt)
        pose, c2ws = optimize_test_poses(nerf, None, eval_scene, mc.nerf, mc.render,
                                         init_c2ws=init, n_points=TRAIN_RAYS, n_epochs=5,
                                         lr=1e-3, log_every=0, device=dev)
        moved = float(np.abs(c2ws - init).max())
        print(f"cli.eval: PSNR {summary['mean_psnr']:.3f} SSIM {summary['mean_ssim']:.4f}; "
              f"5 pose-opt epochs move the pose by at most {moved:.3g}")
        if not (np.isfinite(c2ws).all() and moved > 0.0
                and bool((pose["r"].abs().max() > 0) & (pose["t"].abs().max() > 0))):
            raise RuntimeError("pose optimisation left the pose unchanged or non-finite")

        # ---- cli.eval_poses: learned poses, and the scene's own (every error 0)
        metrics = evaluate_poses(cfg, synthetic=True, device=dev)
        if not all(math.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"cli.eval_poses: non-finite metric {metrics}")
        cfg_fixed = cfg_for(os.path.join(root, "c"), pose={"learn_pose": False, "init_pose": False},
                            training={"pc_weight": [0.0, 0.0], "rgb_s_weight": [0.0, 0.0],
                                      "validate_every": 0})
        counted(lambda: train(cfg_fixed, synthetic=True, max_epochs=1, device=dev),
                {"render_train": 8, "dw_sm90": 8},
                "cli.train without learned poses, 1 epoch")
        fixed = evaluate_poses(cfg_fixed, synthetic=True, device=dev)
        if not all(abs(v) < 1e-6 for v in fixed.values()):
            raise RuntimeError(f"cli.eval_poses: errors {fixed} without learned poses, expected 0")
        print(f"cli.eval_poses: ATE_t {metrics['ate_trans']:.6f}, RPE_r "
              f"{metrics['rpe_rot_deg']:.4f} deg; 0 without learned poses")
    return eval_counts, (nerf, img, cam, pcfg, ray_idx, eval_scene, mc)


def run_unfused_steps(torch, np, dev):
    """Phase 5b: train steps of a config outside the fused-loss gate
    (depth_loss_type invariant) on the train path's scene: per step one
    render_fwd, one render_bwd (full variant), one chamfer_bidir and no
    render_train launch. Step 1's loss terms and gradients are held against
    the same step through the plain versions. Returns (launch counts, trainer,
    state, scene, order, refs)."""
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import (SceneData, batch_for_frame, epoch_order,
                                      make_synthetic_scene)
    from nope_nerf_torch.ops.fused_render import plain_versions
    from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
    from nope_nerf_torch.training.trainer import _sample_rays, step_gradients

    h, w = RESOLUTION
    cfg = load_config(overrides={"training": {"n_training_points": TRAIN_RAYS,
                                              "depth_loss_type": "invariant"},
                                 "pose": {"learn_pose": True, "init_pose": True}})
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    state = create_train_state(SEED, mc, init_c2w=scene.c2ws_gt, device=dev)
    trainer = Trainer(cfg, mc)
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    weights, _, rgb_loss_type = trainer._sched_at(0, 10000)

    batch = batch_for_frame(scene, int(order[0]), ref_idx=int(refs[0]))
    ray_idx = _sample_rays(torch.Generator(device=dev).manual_seed(SEED + 1), h * w, TRAIN_RAYS,
                           None, False)
    noise = torch.rand((TRAIN_RAYS, mc.render.num_points),
                       generator=torch.Generator(device=dev).manual_seed(SEED + 2), device=dev)
    g_k, ld_k = step_gradients(state.params, batch, weights, ray_idx, None, mc, rgb_loss_type,
                               noise=noise)
    with plain_versions():
        g_p, ld_p = step_gradients(state.params, batch, weights, ray_idx, None, mc,
                                   rgb_loss_type, noise=noise)
    for k in ld_p:
        err = abs(float(ld_k[k]) - float(ld_p[k]))
        if not err <= 2e-3 * abs(float(ld_p[k])) + 1e-7:
            raise RuntimeError(f"unfused train step 1: loss term {k} {float(ld_k[k])} differs "
                               f"from the plain versions' {float(ld_p[k])}")
    print(f"unfused train step 1 vs plain versions: {len(ld_p)} loss terms within 2e-3 (loss "
          f"{float(ld_k['loss']):.6g} vs {float(ld_p['loss']):.6g}, loss_depth "
          f"{float(ld_k['loss_depth']):.6g})")
    # the gradients: here the nerf blocks come from render_bwd's full variant at the train batch
    shares = {k: grad_share(g_k["nerf"][k], ref, False) for k, ref in g_p["nerf"].items()}
    k_worst = max(shares, key=shares.get)
    report = [f"worst nerf block {k_worst} at {shares[k_worst]:.3f} of its tolerance"]
    if not shares[k_worst] <= 1.0:
        raise RuntimeError(f"unfused train step 1: gradient nerf/{k_worst} at "
                           f"{shares[k_worst]:.2f} of its tolerance against the plain versions'")
    for group in ("pose", "distortion"):
        for k, ref in g_p[group].items():
            err, top = max_err(g_k[group][k], ref), float(ref.abs().max())
            report.append(f"{group}/{k} {err:.3g} of {top:.3g}")
            if not err <= 5e-2 * top + 1e-9:
                raise RuntimeError(f"unfused train step 1: gradient {group}/{k} differs from the "
                                   f"plain versions' by {err} (largest entry {top})")
    print(f"unfused train step 1 vs plain versions, gradients: {len(shares)} nerf blocks within "
          "5e-3 of each block's largest entry, pose and distortion within 5e-2: "
          + ", ".join(report))

    (state, lds), counts = counted(
        lambda: trainer.run_steps(state, scene, order, refs, epoch=0, scheduling_start=10000),
        {"chamfer_bidir": UNFUSED_STEPS, "render_fwd": UNFUSED_STEPS,
         "render_bwd": UNFUSED_STEPS, "dw_sm90": UNFUSED_STEPS},
        f"unfused train path (depth_loss_type invariant), {UNFUSED_STEPS} steps")
    for k, v in lds.items():
        if v.shape[0] != UNFUSED_STEPS or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"unfused train path: loss term {k} is not finite over the steps")
    return counts, trainer, state, scene, order, refs


def hier_config(**extra):
    """The bench workload (bench.py: default config, learned poses on top of
    the scene's, 1024 rays) with hierarchical sampling on."""
    from nope_nerf_torch.config import load_config
    over = {"training": {"n_training_points": TRAIN_RAYS},
            "rendering": {"n_importance": N_IMPORTANCE},
            "pose": {"learn_pose": True, "init_pose": True}}
    for k, v in extra.items():
        over.setdefault(k, {}).update(v)
    return load_config(overrides=over)


def run_hier_train_path(torch, np, dev):
    """Phase 6a: the train path with hierarchical sampling (rendering.n_importance
    64) on the 188x621 4-frame scene: per step K5 twice (the coarse pass of
    128 samples per ray, the fine pass of 192) and K6 once (the fine pass's
    backward), Chamfer once, no fused render kernel. Step 1 through the
    kernels against the same step through their plain versions, then the
    counted steps. Returns (counts, trainer, state, scene, order, refs, mc)."""
    from nope_nerf_torch.data import (SceneData, batch_for_frame, epoch_order,
                                      make_synthetic_scene)
    from nope_nerf_torch.ops.fused_render import plain_versions
    from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
    from nope_nerf_torch.training.trainer import _sample_rays, step_gradients

    h, w = RESOLUTION
    cfg = hier_config()
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    state = create_train_state(SEED, mc, init_c2w=scene.c2ws_gt, device=dev)
    trainer = Trainer(cfg, mc)
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    weights, _, rgb_loss_type = trainer._sched_at(0, 10000)

    batch = batch_for_frame(scene, int(order[0]), ref_idx=int(refs[0]))
    ray_idx = _sample_rays(torch.Generator(device=dev).manual_seed(SEED + 1), h * w, TRAIN_RAYS,
                           None, False)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    noise = torch.rand((TRAIN_RAYS, mc.render.num_points), generator=gen, device=dev)
    fine_u = torch.rand((TRAIN_RAYS, N_IMPORTANCE), generator=gen, device=dev) * (1.0 - 1e-5)
    (g_k, ld_k), _ = counted(
        lambda: step_gradients(state.params, batch, weights, ray_idx, None, mc, rgb_loss_type,
                               noise=noise, fine_u=fine_u),
        {"point_mlp_fwd": 2, "point_mlp_bwd": 1, "dw_sm90": 1, "chamfer_bidir": 1},
        "hierarchical train step 1 through the kernels")
    with plain_versions():
        g_p, ld_p = step_gradients(state.params, batch, weights, ray_idx, None, mc,
                                   rgb_loss_type, noise=noise, fine_u=fine_u)
    for k in ld_p:
        err = abs(float(ld_k[k]) - float(ld_p[k]))
        if not err <= 2e-3 * abs(float(ld_p[k])) + 1e-7:
            raise RuntimeError(f"hierarchical train step 1: loss term {k} {float(ld_k[k])} "
                               f"differs from the plain versions' {float(ld_p[k])}")
    shares = {k: grad_share(g_k["nerf"][k], ref, False) for k, ref in g_p["nerf"].items()}
    k_worst = max(shares, key=shares.get)
    report = [f"worst nerf block {k_worst} at {shares[k_worst]:.3f} of its tolerance"]
    if not shares[k_worst] <= 1.0:
        raise RuntimeError(f"hierarchical train step 1: gradient nerf/{k_worst} at "
                           f"{shares[k_worst]:.2f} of its tolerance against the plain versions'")
    for group in ("pose", "distortion"):
        for k, ref in g_p[group].items():
            err, top = max_err(g_k[group][k], ref), float(ref.abs().max())
            report.append(f"{group}/{k} {err:.3g} of {top:.3g}")
            if not err <= 5e-2 * top + 1e-9:
                raise RuntimeError(f"hierarchical train step 1: gradient {group}/{k} differs "
                                   f"from the plain versions' by {err} (largest entry {top})")
    print(f"hierarchical train step 1 vs plain versions: {len(ld_p)} loss terms within 2e-3 "
          f"(loss {float(ld_k['loss']):.6g} vs {float(ld_p['loss']):.6g}); gradients: "
          f"{len(shares)} nerf blocks within 5e-3 of each block's largest entry, pose and "
          "distortion within 5e-2: " + ", ".join(report))

    order, refs = np.resize(order, HIER_STEPS), np.resize(refs, HIER_STEPS)
    (state, lds), counts = counted(
        lambda: trainer.run_steps(state, scene, order, refs, epoch=0, scheduling_start=10000),
        {"point_mlp_fwd": 2 * HIER_STEPS, "point_mlp_bwd": HIER_STEPS, "dw_sm90": HIER_STEPS,
         "chamfer_bidir": HIER_STEPS},
        f"hierarchical train path (n_importance {N_IMPORTANCE}), {HIER_STEPS} steps of "
        f"{TRAIN_RAYS} rays at {h}x{w}")
    for k, v in lds.items():
        if v.shape[0] != HIER_STEPS or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"hierarchical train path: loss term {k} is not finite")
    print("hierarchical train path: loss per step "
          + " ".join(f"{v:.4f}" for v in lds["loss"].tolist()))
    return counts, trainer, state, scene, order, refs, mc


def run_hier_eval(torch, np, dev, trainer, state, scene, eval_inputs):
    """Phase 6b: Trainer.render_frame at 188x621 with hierarchical sampling (K5
    twice per chunk, the deterministic fine draw), a slab of it against the
    plain versions, and pose-optimisation steps with n_importance 64 (K5 twice
    and K6's frozen-network variant once per step). Returns the frame's counts
    and the pose-opt steps'."""
    import dataclasses
    from nope_nerf_torch.data import batch_for_frame
    from nope_nerf_torch.evaluation.pose_opt import pose_opt_step
    from nope_nerf_torch.models.poses import init_pose_params
    from nope_nerf_torch.ops.fused_render import plain_versions
    from nope_nerf_torch.training.state import init_adam

    h, w = RESOLUTION
    chunks = math.ceil(h * w / 131072)
    batch = batch_for_frame(scene, 1)
    frame, frame_counts = counted(lambda: trainer.render_frame(state, batch, RESOLUTION),
                                  {"point_mlp_fwd": 2 * chunks},
                                  f"hierarchical render_frame {h}x{w}, {chunks} chunk")
    if frame["rgb"].shape != (h, w, 3) or not (np.isfinite(frame["rgb"]).all()
                                               and np.isfinite(frame["depth"]).all()):
        raise RuntimeError("hierarchical render_frame: bad shape or non-finite values")
    with plain_versions():
        slab = trainer.render_frame(state, batch, RESOLUTION, rows=(0, 8))
    for name in ("rgb", "depth"):
        g = torch.as_tensor(frame[name][:8])
        r = torch.as_tensor(slab[name])
        err, tol = max_err(g, r), tolerance(r)
        print(f"hierarchical frame rows 0-7 vs plain versions: {name} err {err:.3g} "
              f"(tol {tol:.3g})")
        if not err <= tol:
            raise RuntimeError(f"hierarchical render_frame disagrees with the plain versions: "
                               f"{name}")
    print(f"hierarchical frame: rgb mean {frame['rgb'].mean():.4f}, depth mean "
          f"{frame['depth'].mean():.4f}")

    enerf, eimg, ecam, epcfg, eray_idx, eval_scene, emc = eval_inputs
    rcfg = dataclasses.replace(emc.render, n_importance=N_IMPORTANCE)
    pose = init_pose_params(epcfg, torch.as_tensor(eval_scene.c2ws_gt), device=dev)
    adam = init_adam(pose)

    def steps():
        return [float(pose_opt_step(pose, adam, enerf, None, eimg, 0, ecam, eray_idx, 1e-3, epcfg,
                                    None, emc.nerf, rcfg)) for _ in range(HIER_STEPS)]
    # the network is frozen: K6 runs as its frozen-network variant (counted in both)
    losses, pose_counts = counted(steps, {"point_mlp_fwd": 2 * HIER_STEPS,
                                          "point_mlp_bwd": HIER_STEPS,
                                          "point_mlp_bwd_frozen": HIER_STEPS},
                                  f"hierarchical pose-opt, {HIER_STEPS} steps")
    if not all(math.isfinite(v) for v in losses) or not bool(pose["t"].abs().max() > 0):
        raise RuntimeError("hierarchical pose optimisation: non-finite loss or a pose that "
                           "did not move")
    print("hierarchical pose-opt: loss per step " + " ".join(f"{v:.5f}" for v in losses))
    return frame_counts, pose_counts, (pose, adam, enerf, eimg, ecam, eray_idx, epcfg, emc, rcfg)


def run_slice_rest(torch, np, dev):
    """Phase 6c: the rest of the slice. Train steps with normal_loss (the fused
    render's K3 + K4 per step, the normal output through plain nerf_gradient);
    cli.train for 2 epochs with the occupancy grid (created, updated each
    epoch, checkpointed; a resume ends bit-equal to the straight run, grid
    included); Trainer.render_geo at 120x160 (plain density queries)."""
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import (SceneData, batch_for_frame, epoch_order,
                                      make_synthetic_scene)
    from nope_nerf_torch.ops.render import render_nope_nerf
    from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
    from nope_nerf_torch.training.checkpoints import load_params

    # ---- normal_loss: the fused render's forward and backward kernels, and the normals
    cfg = load_config(overrides={"training": {"n_training_points": TRAIN_RAYS},
                                 "rendering": {"normal_loss": True},
                                 "pose": {"learn_pose": True, "init_pose": True}})
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=120, w=160)).to_device(dev)
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    state = create_train_state(SEED, mc, init_c2w=scene.c2ws_gt, device=dev)
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    (state, lds), _ = counted(
        lambda: Trainer(cfg, mc).run_steps(state, scene, order[:2], refs[:2], epoch=0,
                                           scheduling_start=10000),
        {"render_fwd": 2, "render_bwd": 2, "chamfer_bidir": 2, "dw_sm90": 2},
        "normal_loss train path, 2 steps")
    if not all(bool(torch.isfinite(v).all()) for v in lds.values()):
        raise RuntimeError("normal_loss train path: non-finite loss term")
    batch = batch_for_frame(scene, 0)
    pixels = torch.rand((TRAIN_RAYS, 2), device=dev) * 2.0 - 1.0
    out = render_nope_nerf(state.params["nerf"], pixels,
                           torch.full((TRAIN_RAYS, 1), 3.0, device=dev), batch["camera_mat"],
                           torch.eye(4, device=dev), None, torch.Generator(device=dev).manual_seed(1),
                           mc.render, mc.nerf)
    if out["normal"].shape != (TRAIN_RAYS,) or not bool(torch.isfinite(out["normal"]).all()):
        raise RuntimeError("the normal output is missing or not finite")
    print(f"normal_loss: 'normal' finite, mean {float(out['normal'].mean()):.4g}")

    # ---- cli.train with the occupancy grid, and its resume
    def occ_cfg(out_dir):
        return load_config(overrides={
            "training": {"out_dir": out_dir, "n_training_points": TRAIN_RAYS, "vis_geo": False,
                         "print_every": 0, "validate_every": 0, "checkpoint_every": 0,
                         "visualize_every": 0, "vis_reprojection_every": 0},
            "rendering": {"occupancy_grid": True},
            "pose": {"learn_pose": True, "init_pose": True}})

    with tempfile.TemporaryDirectory() as root:
        (state_a, trainer_a, cscene), _ = counted(
            lambda: train(occ_cfg(os.path.join(root, "a")), synthetic=True,
                          max_epochs=CLI_EPOCHS, device=dev),
            {"render_train": 8 * CLI_EPOCHS, "chamfer_bidir": 8 * CLI_EPOCHS,
             "dw_sm90": 8 * CLI_EPOCHS},
            f"cli.train with the occupancy grid, {CLI_EPOCHS} epochs of 8 steps")
        grid = trainer_a.occ_grid
        _, scalars = load_params(os.path.join(root, "a"), "model.ckpt", device=dev)
        if grid is None or tuple(grid.shape) != (64, 64, 64) or bool((grid == 1.0).all()):
            raise RuntimeError("cli.train: the occupancy grid was not created or not updated")
        if not np.array_equal(scalars.get("occ_grid"), grid.cpu().numpy()):
            raise RuntimeError("cli.train: the checkpoint does not hold the occupancy grid")
        cfg_b = occ_cfg(os.path.join(root, "b"))
        train(cfg_b, synthetic=True, max_epochs=1, device=dev)
        state_b, trainer_b, _ = train(cfg_b, synthetic=True, max_epochs=CLI_EPOCHS, device=dev)
        equal = (states_bit_equal(torch, state_a, state_b)
                 and torch.equal(trainer_a.occ_grid, trainer_b.occ_grid))
        print(f"occupancy grid {tuple(grid.shape)}: occupied share "
              f"{float((grid > 0.5).float().mean()):.4f}, checkpointed; resume (1 epoch + "
              f"checkpoint + 1 epoch) against {CLI_EPOCHS} epochs straight, state and grid "
              f"bit-equal: {equal}")
        if not equal:
            raise RuntimeError("a resumed occupancy run differs from the same epochs run straight")

    # ---- the phong geometry view
    vis = batch_for_frame(cscene, 0)
    geo = trainer_a.render_geo(state_a, vis, (120, 160))
    if geo.shape != (120, 160, 3) or not np.isfinite(geo).all():
        raise RuntimeError("render_geo: bad shape or non-finite values")
    hits = float((geo < 1.0).any(axis=-1).mean())
    print(f"render_geo 120x160: finite, surface hits on {hits:.4f} of the pixels")
    return trainer_a, state_a, vis


def disk_config(name: str, root: str):
    """DISK_CONFIGS[name] with this run's changes: the scene under `root`, fern
    read at its working size (resize_factor 1: the one cut, see the module
    docstring), the output under `root`, the hooks that write images or render
    views off (phase 5 drives them; here they would only add launches), cli.eval's pose optimisation cut to POSE_OPT_EPOCHS
    epochs, one novel view."""
    from nope_nerf_torch.config import load_config
    over = copy.deepcopy({**DISK_CONFIGS, **PREP_CONFIGS}[name])
    d = over["dataloading"]
    d["path"] = os.path.join(root, os.path.basename(d["path"]))
    if name == "fern":
        d["resize_factor"] = 1
    over.setdefault("training", {}).update(
        out_dir=os.path.join(root, "out", name), vis_geo=False, print_every=0,
        validate_every=0, checkpoint_every=0, visualize_every=0, vis_reprojection_every=0,
        backup_every=0)
    over["eval_pose"] = {"opt_pose_epoch": POSE_OPT_EPOCHS, "n_points": TRAIN_RAYS}
    over.setdefault("extract_images", {})["N_novel_imgs"] = 1
    return load_config(overrides=over)


def write_disk_scenes(np, root: str) -> None:
    """One synthetic driving scene per configuration, at its size on disk, in
    the V-KITTI/LLFF layout (images, 16-bit depth PNGs, intrinsics.npz,
    poses_gt.npy, noisy poses_bounds.npy), with dpt/depth_<frame>.npz priors
    where the configuration reads them (with_depth false)."""
    from nope_nerf_torch.data import make_driving_scene, write_vkitti_scene
    for name, (h, w) in DISK_SIZES.items():
        d = DISK_CONFIGS[name]["dataloading"]
        dest = os.path.join(root, os.path.basename(d["path"]), d["scene"][0])
        scene = make_driving_scene(n_frames=DISK_FRAMES, h=h, w=w, seed=SEED)
        write_vkitti_scene(dest, scene, pose_noise_deg=1.0, pose_noise_trans=0.05, seed=SEED)
        if not d.get("with_depth"):
            os.makedirs(os.path.join(dest, "dpt"))
            for i, depth in enumerate(scene["depths"]):
                np.savez(os.path.join(dest, "dpt", f"depth_{i:05d}.npz"),
                         pred=depth[None].astype(np.float32))


def write_jpeg_frames(np, root: str):
    """Rewrite the Ballroom scene's PNG frames as JPEG files (BALLROOM_JPEG's
    modes) and decode each: the shape (after orientation) and image_shape
    equal to the source's, its PSNR against the source over what a JPEG
    keeps above 35 dB, two reads np.array_equal. Returns (the decode times in
    ms, the source of the last frame)."""
    from nope_nerf_torch.data.image_io import image_shape, read_png, read_rgb8
    from nope_nerf_torch.tools.jpeg_writer import kept_psnr, write_jpeg
    name = "Ballroom"
    d = DISK_CONFIGS[name]["dataloading"]
    img_dir = os.path.join(root, os.path.basename(d["path"]), d["scene"][0], "images")
    times = []
    for i, png in enumerate(sorted(os.listdir(img_dir))):
        src = read_png(os.path.join(img_dir, png))
        os.remove(os.path.join(img_dir, png))
        mode = {"quality": 95, "sampling": "4:2:0", **BALLROOM_JPEG.get(i, {})}
        path = os.path.join(img_dir, os.path.splitext(png)[0] + ".jpg")
        write_jpeg(path, src, **mode)
        t0 = time.perf_counter()
        got = read_rgb8(path)
        times.append((time.perf_counter() - t0) * 1e3)
        if got.shape != src.shape or image_shape(path) != src.shape[:2]:
            raise RuntimeError(f"{name} frame {i}: decoded {got.shape}, image_shape "
                               f"{image_shape(path)}, written {src.shape}")
        psnr = kept_psnr(got, src, mode["sampling"])
        if not psnr > 35.0:
            raise RuntimeError(f"{name} frame {i} ({mode}): PSNR {psnr:.2f} dB against its "
                               "source, not above 35")
        if not np.array_equal(read_rgb8(path), got):
            raise RuntimeError(f"{name} frame {i}: two reads differ")
        print(f"  {name} {os.path.basename(path)} ({os.path.getsize(path)} bytes, "
              + ", ".join(f"{k} {v}" for k, v in mode.items()) + f"): {got.shape[0]}x"
              f"{got.shape[1]}, PSNR {psnr:.2f} dB against its source, decoded in "
              f"{times[-1]:.1f} ms, two reads equal")
    return times, src


def run_disk_scenes(torch, np, dev, root: str):
    """Phase 7: the three configurations from scenes on disk under `root`
    through the CLIs (see the module docstring). Returns (fern's launch counts,
    the fern run's trainer, state and scene for the timings)."""
    from nope_nerf_torch.cli.eval import evaluate
    from nope_nerf_torch.cli.eval_poses import evaluate_poses
    from nope_nerf_torch.cli.render import render
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.data import DataField, batch_for_frame
    from nope_nerf_torch.data.image_io import read_png
    from nope_nerf_torch.tools.decode_timing import decode_times
    from nope_nerf_torch.ops.fused_render import plain_versions
    from nope_nerf_torch.training.trainer import _sample_rays, step_gradients

    t_phase = time.perf_counter()
    steps = DISK_FRAMES - 1
    expected = {"fern": {"render_train": steps, "chamfer_nearest": 2 * steps, "dw_sm90": steps},
                "Ballroom": {"render_train": steps, "chamfer_nearest": 2 * steps,
                             "dw_sm90": steps},
                "straight_d4": {"render_train": steps, "chamfer_bidir": steps, "dw_sm90": steps}}
    runs = {}
    t0 = time.perf_counter()
    write_disk_scenes(np, root)
    print(f"on-disk scenes: {DISK_FRAMES} frames each at "
          + ", ".join(f"{n} {h}x{w}" for n, (h, w) in DISK_SIZES.items())
          + f" written in {time.perf_counter() - t0:.1f} s")
    jpeg_ms, ballroom_frame = write_jpeg_frames(np, root)
    t0 = time.perf_counter()
    DataField.from_cfg(disk_config("Ballroom", root), mode="train")
    load_s = time.perf_counter() - t0
    print(f"Ballroom: {DISK_FRAMES} JPEG frames loaded through DataField in {load_s:.2f} s")
    for name in DISK_SIZES:
        cfg = disk_config(name, root)
        t0 = time.perf_counter()
        (state, trainer, scene), counts = counted(
            lambda: train(cfg, max_epochs=1, device=dev), expected[name],
            f"cli.train on the {name} scene on disk, 1 epoch of {steps} steps")
        h, w = scene.imgs.shape[1:3]
        n_pc = (h // trainer.mc.pc_ratio) * (w // trainer.mc.pc_ratio)
        print(f"  {name}: {scene.n_frames} train frames at {h}x{w}, Chamfer clouds of "
              f"{n_pc} points, {time.perf_counter() - t0:.1f} s with the scene's loading")
        if state.it != steps - 1:
            raise RuntimeError(f"cli.train on {name}: iteration counter {state.it}")
        for group, d in state.params.items():
            if not all(bool(torch.isfinite(v).all()) for v in d.values()):
                raise RuntimeError(f"cli.train on {name}: non-finite parameter in {group}")
        runs[name] = (counts, trainer, state, scene)

    # fern's step 1 through the kernels (K1, K7 twice) and through the plain versions
    _, trainer, state, scene = runs["fern"]
    mc = trainer.mc
    h, w = scene.imgs.shape[1:3]
    weights, _, rgb_loss_type = trainer._sched_at(0, 10000)
    batch = batch_for_frame(scene, 0, ref_idx=1)
    ray_idx = _sample_rays(torch.Generator(device=dev).manual_seed(SEED + 1), h * w,
                           TRAIN_RAYS, None, False)
    noise = torch.rand((TRAIN_RAYS, mc.render.num_points),
                       generator=torch.Generator(device=dev).manual_seed(SEED + 2), device=dev)
    (g_k, ld_k), _ = counted(
        lambda: step_gradients(state.params, batch, weights, ray_idx, None, mc,
                               rgb_loss_type, noise=noise),
        {"render_train": 1, "chamfer_nearest": 2, "dw_sm90": 1},
        "fern step 1 through the kernels")
    with plain_versions():
        g_p, ld_p = step_gradients(state.params, batch, weights, ray_idx, None, mc,
                                   rgb_loss_type, noise=noise)
    torch.cuda.synchronize()
    for k in ld_p:
        if not abs(float(ld_k[k]) - float(ld_p[k])) <= 2e-3 * abs(float(ld_p[k])) + 1e-7:
            raise RuntimeError(f"fern step 1: loss term {k} {float(ld_k[k])} differs from "
                               f"the plain versions' {float(ld_p[k])}")
    report = []
    for group in ("pose", "distortion"):
        for k, ref in g_p[group].items():
            err, top = max_err(g_k[group][k], ref), float(ref.abs().max())
            report.append(f"{group}/{k} {err:.3g} of {top:.3g}")
            if not err <= 5e-2 * top + 1e-9:
                raise RuntimeError(f"fern step 1: gradient {group}/{k} differs from the "
                                   f"plain versions' by {err} (largest entry {top})")
    print(f"fern step 1 vs plain versions: {len(ld_p)} loss terms within 2e-3 (loss_pc "
          f"{float(ld_k['loss_pc']):.6g} vs {float(ld_p['loss_pc']):.6g}); gradient errors "
          + ", ".join(report))

    # the fern scene through the other CLIs
    cfg = disk_config("fern", root)
    metrics = evaluate_poses(cfg, vis=True, device=dev)
    ply = os.path.join(cfg["training"]["out_dir"], cfg["eval_pose"]["extraction_dir"],
                       "trajectory.ply")
    if not (os.path.exists(ply) and all(math.isfinite(v) for v in metrics.values())):
        raise RuntimeError(f"cli.eval_poses on fern: no PLY or a non-finite metric {metrics}")
    chunks = math.ceil(h * w / 131072)
    frames, _ = counted(lambda: render(cfg, device=dev, save=False), {"render_fwd": chunks},
                        f"cli.render on fern, 1 view at {h}x{w}")
    if frames[0]["rgb"].shape != (h, w, 3) or not np.isfinite(frames[0]["rgb"]).all():
        raise RuntimeError("cli.render on fern: bad or non-finite frame")
    opt_steps = POSE_OPT_EPOCHS      # one eval view (frame 4)
    summary, _ = counted(
        lambda: evaluate(cfg, device=dev, save=False),
        {"render_fwd": opt_steps + chunks, "render_bwd": opt_steps,
         "render_bwd_frozen": opt_steps},
        f"cli.eval on fern, {POSE_OPT_EPOCHS} pose-opt epochs on 1 view, then its frame")
    if not all(math.isfinite(summary[k]) for k in ("mean_mse", "mean_psnr", "mean_ssim")):
        raise RuntimeError(f"cli.eval on fern: non-finite summary {summary}")
    print(f"fern: eval_poses ATE_t {metrics['ate_trans']:.6f}, PLY written; eval PSNR "
          f"{summary['mean_psnr']:.3f}")

    # decoding on this machine's host: a Ballroom frame, a V-KITTI frame with every
    # row Paeth-filtered (cv2's adaptive writer picks Paeth most) and one LLFF original
    d = DISK_CONFIGS["straight_d4"]["dataloading"]
    img = read_png(os.path.join(root, os.path.basename(d["path"]), d["scene"][0], "images",
                                "00000.png"))
    times = decode_times(ballroom_frame, img, root, large=(3024, 4032))
    print(f"PNG decode of a {img.shape[0]}x{img.shape[1]} RGB frame: Paeth rows "
          f"{times['png_paeth_375x1242_ms']:.1f} ms, Up rows "
          f"{times['png_up_375x1242_ms']:.1f} ms (host)")
    print(json.dumps({"image_decode_host": {"ballroom_jpeg_frames_ms": jpeg_ms, **times,
                                            "ballroom_datafield_load_s": load_s}}))
    print(f"on-disk phase: {time.perf_counter() - t_phase:.1f} s wall")
    fern_counts, trainer, state, scene = runs["fern"]
    return fern_counts, trainer, state, scene


def write_lpips_weights(np, path: str) -> None:
    """Seeded random LPIPS weights at the full VGG16 width as an .npz in the JAX
    package's layout (OIHW convs scaled to keep activations of order 1,
    non-negative (1, C, 1, 1) lin heads)."""
    from nope_nerf_torch.evaluation.lpips import TAP_CHANNELS, VGG16_CHANNELS, VGG16_CONV_IDX
    rng = np.random.default_rng(SEED)
    params, c_in = {}, 3
    for idx, c_out in zip(VGG16_CONV_IDX, VGG16_CHANNELS):
        params[f"features.{idx}.weight"] = (
            rng.standard_normal((c_out, c_in, 3, 3)) / np.sqrt(9 * c_in)).astype(np.float32)
        params[f"features.{idx}.bias"] = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
        c_in = c_out
    for k, c in enumerate(TAP_CHANNELS):
        params[f"lin{k}.weight"] = np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32)
    np.savez(path, **params)


def write_raw_vkitti(np, raw: str, scene_dir: str) -> int:
    """A raw V-KITTI 1.3.1 tree for drive 0001 / clone: the straight scene's
    375x1242 RGB and 16-bit depth PNGs, and an extrinsics txt of a car driving
    forward while it turns slowly. Returns the number of frames."""
    import shutil
    names = sorted(os.listdir(os.path.join(scene_dir, "images")))
    for sub, kind in (("images", "rgb"), ("depth", "depthgt")):
        dest = os.path.join(raw, f"vkitti_1.3.1_{kind}", "0001", "clone")
        os.makedirs(dest)
        for name in names:
            shutil.copy(os.path.join(scene_dir, sub, name), dest)
    os.makedirs(os.path.join(raw, "vkitti_1.3.1_extrinsicsgt"))
    lines = ["frame r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3 t2 r3,1 r3,2 r3,3 t3 0 0 0 1"]
    for i in range(len(names)):
        yaw = 0.01 * i
        c2w = np.array([[np.cos(yaw), 0, np.sin(yaw), 0.05 * i], [0, 1, 0, 0],
                        [-np.sin(yaw), 0, np.cos(yaw), 0.8 * i], [0, 0, 0, 1]])
        lines.append(f"{i} " + " ".join(f"{v:.9f}" for v in np.linalg.inv(c2w).reshape(-1)))
    with open(os.path.join(raw, "vkitti_1.3.1_extrinsicsgt", "0001_clone.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(names)


def run_scene_preparation(torch, np, dev, root: str) -> dict:
    """Phase 8 on phase 7's straight scene under `root`: LPIPS and DPT-Hybrid at
    full width on the card against the same modules on this machine's CPU, the
    preprocess CLI's priors, an epoch of straight_d2 trained on them, cli.eval
    with LPIPS, cli.get_vkitti on a raw tree; times LPIPS and DPT. No
    hand-written kernel computes LPIPS or DPT: they are F.conv2d / matmul
    library calls. Returns their numbers for the JSON line."""
    from nope_nerf_torch.cli.eval import evaluate
    from nope_nerf_torch.cli.preprocess import preprocess
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import DataField
    from nope_nerf_torch.data.dpt_transforms import prepare_dpt_input
    from nope_nerf_torch.evaluation.lpips import load_lpips_params, lpips_flops, lpips_pair
    from nope_nerf_torch.models.dpt import DPTConfig, dpt_flops, init_dpt_params, make_dpt

    t_phase = time.perf_counter()
    steps = DISK_FRAMES - 1
    prep_cfg = disk_config("preprocess_straight", root)
    imgs = DataField.from_cfg(prep_cfg, mode="all").scene.imgs          # 6 x 188 x 621
    h, w = imgs.shape[1:3]

    # a. LPIPS at the full VGG16 width on a pair of consecutive frames
    weights = os.path.join(root, "lpips_vgg16.npz")
    write_lpips_weights(np, weights)
    p_dev, p_cpu = load_lpips_params(weights, dev), load_lpips_params(weights, "cpu")
    a, b = torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1])
    with torch.inference_mode():
        d_dev, d_cpu = float(lpips_pair(p_dev, a, b)), float(lpips_pair(p_cpu, a, b))
        d_same = float(lpips_pair(p_dev, a, a.clone()))
    lpips_rel = abs(d_dev - d_cpu) / abs(d_cpu)
    print(f"LPIPS (VGG16, seeded weights) {h}x{w} pair on the card {d_dev:.8f}, on the CPU "
          f"{d_cpu:.8f} (relative difference {lpips_rel:.2e}, tolerance 1e-4); identical "
          f"images {d_same}")
    if not (math.isfinite(d_cpu) and d_cpu > 0 and lpips_rel <= 1e-4 and d_same == 0.0):
        raise RuntimeError(f"LPIPS: card {d_dev}, CPU {d_cpu}, identical images {d_same}")

    # b. DPT-Hybrid at the default widths, random init, one 384x1280 frame
    dcfg = DPTConfig.from_cfg(prep_cfg)
    sd = init_dpt_params(dcfg)
    m_dev, m_cpu = make_dpt(sd, dcfg, dev), make_dpt(sd, dcfg, "cpu")
    x = torch.from_numpy(prepare_dpt_input(imgs[0])).permute(2, 0, 1)[None].contiguous()
    if tuple(x.shape[2:]) != DPT_INPUT:
        raise RuntimeError(f"DPT input {tuple(x.shape)}, expected {DPT_INPUT}")
    x_dev = x.to(dev)
    with torch.inference_mode():
        s_dev, s_cpu = m_dev.stages(x_dev), m_cpu.stages(x)
    report, dpt_worst = [], 0.0
    for k in ("l1", "l2", "l3", "l4", "path1", "inv_depth", "depth"):
        got, ref = s_dev[k].cpu(), s_cpu[k]
        err, top = max_err(got, ref), float(ref.abs().max())
        report.append(f"{k} {tuple(ref.shape[1:])} {err:.3g} of {top:.3g}")
        dpt_worst = max(dpt_worst, err / top if top > 0 else err)
        if not (bool(torch.isfinite(got).all()) and err <= 1e-3 * top):
            raise RuntimeError(f"DPT {k}: the card's differs from the CPU's by {err} "
                               f"(largest entry {top})")
    print("DPT-Hybrid 384x1280, card vs CPU (tolerance 1e-3 of each tensor's largest "
          "entry): " + ", ".join(report))
    del m_cpu, s_cpu, s_dev

    # e. times (CUDA events, after a warm-up)
    a_dev, b_dev = a.to(dev), b.to(dev)
    with torch.inference_mode():
        lpips_ms = time_ms(lambda: lpips_pair(p_dev, a_dev, b_dev), 5)
        dpt_ms = time_ms(lambda: m_dev(x_dev), 5)
    flops = dpt_flops(dcfg, *DPT_INPUT)
    n_flops = sum(flops.values())
    dpt_bytes = (sum(t.numel() for t in sd.values()) + x.numel() + DPT_INPUT[0] * DPT_INPUT[1]) * 4
    dpt_bound, dpt_by, _, _ = bound(n_flops, PEAK_F32_FLOPS, dpt_bytes)
    l_flops = lpips_flops(h, w)
    l_bytes = (sum(t.numel() for t in p_dev.values()) + 2 * h * w * 3 + 1) * 4
    l_bound, l_by, _, _ = bound(l_flops, PEAK_F32_FLOPS, l_bytes)
    print(f"DPT-Hybrid forward {DPT_INPUT[0]}x{DPT_INPUT[1]}: {dpt_ms:.2f} ms per frame; "
          f"{n_flops / 1e12:.4f} TFLOP (ResNet {flops['resnet'] / 1e12:.4f}, ViT "
          f"{flops['vit'] / 1e12:.4f}, decoder {flops['decoder'] / 1e12:.4f}) -> "
          f"{n_flops / dpt_ms / 1e9:.1f} TFLOP/s achieved, bound {dpt_bound:.2f} ms by {dpt_by} "
          f"at the f32 peak ({dpt_ms / dpt_bound:.2f} x)")
    # where the DPT forward's device time goes, and the gaps between its kernels
    from torch.profiler import ProfilerActivity, profile
    from nope_nerf_torch.tools.profile_train import _self_device_us
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        m_dev(x_dev)
        torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_self_device_us(e) for e in ka) / 1e3
    top = sorted(ka, key=_self_device_us, reverse=True)[:6]
    print(f"DPT-Hybrid device time (torch.profiler, one forward): {busy_ms:.2f} ms busy in "
          f"{sum(e.count for e in ka)} kernels against {dpt_ms:.2f} ms by CUDA events (idle "
          f"share {1 - busy_ms / dpt_ms:.1%}); largest: "
          + "; ".join(f"{e.key[:64]} x{e.count} {_self_device_us(e) / 1e3:.2f} ms" for e in top))
    print(f"LPIPS pair {h}x{w}: {lpips_ms:.2f} ms; {l_flops / 1e12:.4f} TFLOP -> "
          f"{l_flops / lpips_ms / 1e9:.1f} TFLOP/s achieved, bound {l_bound:.2f} ms by {l_by} "
          f"({lpips_ms / l_bound:.2f} x)")
    del m_dev, p_cpu

    # c. the preprocess CLI writes the priors; straight_d2 trains on them; eval with LPIPS
    t0 = time.perf_counter()
    out_dir, _ = counted(lambda: preprocess(prep_cfg, random_weights=True, device=dev), {},
                         f"cli.preprocess, DPT priors of the {DISK_FRAMES} straight frames")
    prep_s = time.perf_counter() - t0
    npz = sorted(n for n in os.listdir(out_dir) if n.endswith(".npz"))
    pngs = sorted(n for n in os.listdir(out_dir) if n.endswith(".png"))
    if len(npz) != DISK_FRAMES or len(pngs) != DISK_FRAMES:
        raise RuntimeError(f"cli.preprocess wrote {npz} and {pngs}")
    for name in npz:
        pred = np.load(os.path.join(out_dir, name))["pred"]
        if pred.shape != DPT_INPUT or pred.dtype != np.float32 or not np.isfinite(pred).all():
            raise RuntimeError(f"cli.preprocess: {name} {pred.shape} {pred.dtype} not finite")
    print(f"cli.preprocess: {len(npz)} priors of {DPT_INPUT[0]}x{DPT_INPUT[1]} and their PNGs "
          f"in {prep_s:.1f} s (random init, DataField and the host transform included)")

    train_cfg = disk_config("straight_d2", root)
    (state, trainer, scene), _ = counted(
        lambda: train(train_cfg, max_epochs=1, device=dev),
        {"render_train": steps, "chamfer_bidir": steps, "dw_sm90": steps},
        f"cli.train on straight_d2 from the DPT priors, 1 epoch of {steps} steps")
    if scene.depths.shape[1:] != DPT_INPUT or state.it != steps - 1:
        raise RuntimeError(f"straight_d2: priors {scene.depths.shape}, iteration {state.it}")
    for group, d in state.params.items():
        if not all(bool(torch.isfinite(v).all()) for v in d.values()):
            raise RuntimeError(f"cli.train on straight_d2: non-finite parameter in {group}")
    eval_cfg = copy.deepcopy(train_cfg)
    eval_cfg["extract_images"]["lpips_weights"] = weights
    chunks = math.ceil(h * w / 131072)
    summary, _ = counted(
        lambda: evaluate(eval_cfg, device=dev, save=False),
        {"render_fwd": POSE_OPT_EPOCHS + chunks, "render_bwd": POSE_OPT_EPOCHS,
         "render_bwd_frozen": POSE_OPT_EPOCHS},
        f"cli.eval on straight_d2 with LPIPS, {POSE_OPT_EPOCHS} pose-opt epochs on 1 view")
    text = open(os.path.join(eval_cfg["training"]["out_dir"],
                             eval_cfg["extract_images"]["extraction_dir"], "evaluation.txt")).read()
    if not (math.isfinite(summary.get("mean_lpips", math.nan))
            and f"LPIPS {summary['mean_lpips']:.2f}" in text):
        raise RuntimeError(f"cli.eval on straight_d2: no finite mean_lpips ({summary})")
    print(f"straight_d2: eval PSNR {summary['mean_psnr']:.3f}, mean_lpips "
          f"{summary['mean_lpips']:.6f}")

    # d. cli.get_vkitti on a raw V-KITTI tree, run as a user runs it, read back
    raw, work = os.path.join(root, "raw_vkitti"), os.path.join(root, "get_vkitti")
    n = write_raw_vkitti(np, raw, os.path.join(root, "V_KITTI", "straight"))
    os.makedirs(work)
    repo = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-m", "nope_nerf_torch.cli.get_vkitti", raw, "1.3.1", "0001",
         "straight", "interval", "--with-depth", "--customised-focal", "--customised-poses",
         "--resize-factor", "2"],
        cwd=work, env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
        timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cli.get_vkitti exited {res.returncode}: {res.stderr[-2000:]}")
    cfg = load_config(os.path.join(work, "configs", "V_KITTI", "straight.yaml"),
                      overrides={"dataloading": {"path": os.path.join(work, "data", "V_KITTI")}})
    back = DataField.from_cfg(cfg, mode="all").scene
    rows = np.load(os.path.join(work, "data", "V_KITTI", "straight", "poses_gt.npy"))
    if (back.imgs.shape != (n, h, w, 3) or rows.shape != (n, 17)
            or not (np.isfinite(back.c2ws_gt).all() and np.isfinite(back.depths).all())):
        raise RuntimeError(f"cli.get_vkitti: scene read back as {back.imgs.shape}, "
                           f"poses {rows.shape}")
    print(f"cli.get_vkitti: {n} raw frames of 375x1242 -> scene and yamls, read back through "
          f"DataField at {h}x{w} ({res.stdout.strip().splitlines()[-1]})")
    print(f"scene-preparation phase: {time.perf_counter() - t_phase:.1f} s wall")
    return {"library_calls": [
        {"name": "dpt_hybrid", "input": [1, 3, *DPT_INPUT], "ms": dpt_ms,
         "tflop": n_flops / 1e12, "bound_ms": dpt_bound, "bound_by": dpt_by,
         "max_rel_err_vs_cpu": dpt_worst},
        {"name": "lpips_vgg16", "input": [2, h, w, 3], "ms": lpips_ms,
         "tflop": l_flops / 1e12, "bound_ms": l_bound, "bound_by": l_by,
         "max_rel_err_vs_cpu": lpips_rel}],
        "preprocess_s": prep_s, "preprocess_frames": len(npz)}


# ---- phase 10: the multi-device layer ---------------------------------------------------

PARALLEL_RANKS = 2           # ranks of the gloo phases, both on cuda:0
PARALLEL_STEPS = 4           # counted sharded steps of the fused config
PARALLEL_UNFUSED_STEPS = 2   # counted sharded steps of the invariant-depth config
COLLECTIVE_TIMEOUT_S = 180   # a rank that waits longer in a collective raises
SPAWN_TIMEOUT_S = 420        # a spawn of ranks that runs longer is stopped, and the phase fails


def rank_print(mesh_rank: int, text: str) -> None:
    print(f"[rank {mesh_rank}] {text}", flush=True)


def copy_generator(torch, gen):
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def flat_state(state) -> dict:
    """Every tensor of a TrainState on the host, by name: params, Adam moments
    and counts, the iteration counter, the generator's state."""
    import torch
    out = {"generator": state.generator.get_state(), "it": torch.tensor(state.it)}
    for g, d in state.params.items():
        out[f"count/{g}"] = torch.tensor(state.opt_state[g].count)
        for k, v in d.items():
            out[f"params/{g}/{k}"] = v.detach().cpu()
            out[f"mu/{g}/{k}"] = state.opt_state[g].mu[k].cpu()
            out[f"nu/{g}/{k}"] = state.opt_state[g].nu[k].cpu()
    return out


def flat_equal(torch, a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def compare_steps(torch, what: str, got, ref, rank: int) -> None:
    """A sharded step's (gradients, loss dict) against the one-process step's
    on the same draws: loss terms within 2e-3 relative, nerf blocks within
    grad_tolerance (5e-3 of the block's largest entry), pose and distortion
    blocks within 5e-2 of theirs (sums of d(rays) and dz over the batch).
    Splitting the rays changes the order of K1's per-CTA dW partial sums."""
    (g_s, ld_s), (g_1, ld_1) = got, ref
    for k in ld_1:
        if not abs(float(ld_s[k]) - float(ld_1[k])) <= 2e-3 * abs(float(ld_1[k])) + 1e-7:
            raise RuntimeError(f"{what}: loss term {k} {float(ld_s[k])} differs from the "
                               f"one-process step's {float(ld_1[k])}")
    worst, report = 0.0, []
    for k, ref_k in g_1["nerf"].items():
        err = max_err(g_s["nerf"][k], ref_k)
        if not err <= grad_tolerance(ref_k):
            raise RuntimeError(f"{what}: nerf/{k} differs from the one-process step's by {err}")
        worst = max(worst, err / grad_tolerance(ref_k))
    for group in ("pose", "distortion"):
        for k, ref_k in g_1.get(group, {}).items():
            err, top = max_err(g_s[group][k], ref_k), float(ref_k.abs().max())
            report.append(f"{group}/{k} {err:.3g} of {top:.3g}")
            if not err <= 5e-2 * top + 1e-9:
                raise RuntimeError(f"{what}: gradient {group}/{k} differs from the one-process "
                                   f"step's by {err} (largest entry {top})")
    rank_print(rank, f"{what} vs the one-process step on the same draws: {len(ld_1)} loss "
               f"terms within 2e-3 (loss {float(ld_s['loss']):.6g} vs {float(ld_1['loss']):.6g}), "
               f"{len(g_1['nerf'])} nerf blocks at worst {worst:.3f} of grad_tolerance, "
               + ", ".join(report))


def collective_meter():
    """Count the mesh's all-reduces from now on, and the host time inside them:
    returns a function that stops counting and gives (calls, ms)."""
    from nope_nerf_torch.parallel import sharding
    real = sharding.all_reduce
    seen = [0, 0.0]

    def metered(t, mesh):
        t0 = time.perf_counter()
        out = real(t, mesh)
        seen[0] += 1
        seen[1] += (time.perf_counter() - t0) * 1e3
        return out

    sharding.all_reduce = metered

    def stop():
        sharding.all_reduce = real
        return seen[0], seen[1]
    return stop


def parallel_setup(torch, dev, **training):
    """The train workload of phase 4 (default config, learned poses, 1024 rays, the
    4-frame synthetic scene at 188x621), `training` merged into its training keys."""
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import SceneData, make_synthetic_scene
    from nope_nerf_torch.training import ModelConfigs, create_train_state
    h, w = RESOLUTION
    cfg = load_config(overrides={"training": {"n_training_points": TRAIN_RAYS, **training},
                                 "pose": {"learn_pose": True, "init_pose": True}})
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    return cfg, scene, mc, create_train_state(SEED, mc, init_c2w=scene.c2ws_gt, device=dev)


def sharded_step_check(torch, np, mesh, what: str, **training):
    """Step 1 of the workload on `mesh` against the one-process step from a copy of
    the same generator (rank 0 compares; every rank checks it drew the same ray
    indices). Returns (cfg, scene, mc, state, order, refs)."""
    from nope_nerf_torch.data import batch_for_frame, epoch_order
    from nope_nerf_torch.training import Trainer
    from nope_nerf_torch.training.trainer import _sample_rays, step_gradients
    h, w = RESOLUTION
    cfg, scene, mc, state = parallel_setup(torch, mesh.device, **training)
    weights, _, rgb_loss_type = Trainer(cfg, mc)._sched_at(0, 10000)
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    batch = batch_for_frame(scene, int(order[0]), ref_idx=int(refs[0]))
    gen = copy_generator(torch, state.generator)
    ray_idx = _sample_rays(gen, h * w, TRAIN_RAYS, None, False)
    sharded = step_gradients(state.params, batch, weights, ray_idx, gen, mc, rgb_loss_type,
                             mesh=mesh)
    gen1 = copy_generator(torch, state.generator)
    ray_idx1 = _sample_rays(gen1, h * w, TRAIN_RAYS, None, False)
    if not torch.equal(ray_idx, ray_idx1):
        raise RuntimeError(f"{what}: the ranks drew other ray indices than one process")
    if mesh.rank == 0:
        one = step_gradients(state.params, batch, weights, ray_idx1, gen1, mc, rgb_loss_type)
        if not torch.equal(gen.get_state(), gen1.get_state()):
            raise RuntimeError(f"{what}: the sharded step drew other jitter than one process")
        compare_steps(torch, what, sharded, one, mesh.rank)
    return cfg, scene, mc, state, order, refs


def parallel_gloo(torch, np, mesh, work: str) -> dict:
    """Phase 10 (a), (b) and (d) on this rank of a 2-rank gloo mesh on cuda:0."""
    from nope_nerf_torch.training import Trainer
    from nope_nerf_torch.data import batch_for_frame
    h, w = RESOLUTION
    r = mesh.rank
    out = {}
    # (a) the fused step: K1 and its dW kernel on this rank's 512 rays, K2 on every rank
    cfg, scene, mc, state, order, refs = sharded_step_check(
        torch, np, mesh, f"sharded fused step 1 ({TRAIN_RAYS} rays over {mesh.size} ranks)")
    trainer = Trainer(cfg, mc, mesh=mesh)
    if r == 0:   # the same steps in one process on a copy of the state, rank 1 waiting
        from nope_nerf_torch.cli.train import _clone_state
        alone = Trainer(cfg, mc)
        copy_ = _clone_state(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone.run_steps(copy_, scene, order[:PARALLEL_STEPS], refs[:PARALLEL_STEPS], epoch=0,
                        scheduling_start=10000)
        torch.cuda.synchronize()
        out["one_process_step_ms"] = (time.perf_counter() - t0) * 1e3 / PARALLEL_STEPS
    torch.distributed.barrier()     # both ranks start the timed steps together
    reduces = collective_meter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, lds), _ = counted(
        lambda: trainer.run_steps(state, scene, order[:PARALLEL_STEPS], refs[:PARALLEL_STEPS],
                                  epoch=0, scheduling_start=10000),
        {"render_train": PARALLEL_STEPS, "chamfer_bidir": PARALLEL_STEPS,
         "dw_sm90": PARALLEL_STEPS},
        f"[rank {r}] sharded fused train path, {PARALLEL_STEPS} steps of "
        f"{TRAIN_RAYS // mesh.size} rays on this rank")
    out["fused_step_ms"] = (time.perf_counter() - t0) * 1e3 / PARALLEL_STEPS
    calls, reduce_ms = reduces()
    out["all_reduces_per_step"] = calls / PARALLEL_STEPS
    out["all_reduce_ms_per_step"] = reduce_ms / PARALLEL_STEPS
    if not all(bool(torch.isfinite(v).all()) for v in lds.values()):
        raise RuntimeError("sharded fused train path: a non-finite loss term")
    alone_text = (f"; the same steps in one process on this card {out['one_process_step_ms']:.2f}"
                  " ms" if r == 0 else "")
    rank_print(r, f"sharded fused train path: {out['fused_step_ms']:.2f} ms per step (host "
               f"clock, synchronised; two ranks share the card), of it "
               f"{out['all_reduce_ms_per_step']:.2f} ms inside {out['all_reduces_per_step']:.0f} "
               f"gloo all-reduces a step (host clock: each waits for its operand, then stages it "
               f"through the host){alone_text}; loss {float(lds['loss'][0]):.4f} -> "
               f"{float(lds['loss'][-1]):.4f}")
    torch.save(flat_state(state), os.path.join(work, f"fused_state_{r}.pt"))

    # (d) the eval frame's rows split over the ranks, K3 once per rank
    batch = batch_for_frame(scene, 0, ref_idx=1)
    frame, _ = counted(lambda: trainer.render_frame_multihost(state, batch, RESOLUTION),
                       {"render_fwd": 1},
                       f"[rank {r}] render_frame_multihost {h}x{w}, this rank's "
                       f"{-(-h // mesh.size)}-row slab")
    np.savez(os.path.join(work, f"frame_{r}.npz"), **frame)
    if r == 0:
        ref = Trainer(cfg, mc).render_frame(state, batch, RESOLUTION)
        np.savez(os.path.join(work, "frame_ref.npz"), **ref)

    # (b) the invariant depth loss: K3 and K4 full per rank, the median over the
    # gathered batch
    cfg, scene, mc, state, order, refs = sharded_step_check(
        torch, np, mesh, "sharded invariant-depth step 1", depth_loss_type="invariant")
    trainer = Trainer(cfg, mc, mesh=mesh)
    n = PARALLEL_UNFUSED_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, lds), _ = counted(
        lambda: trainer.run_steps(state, scene, order[:n], refs[:n], epoch=0,
                                  scheduling_start=10000),
        {"render_fwd": n, "render_bwd": n, "chamfer_bidir": n, "dw_sm90": n},
        f"[rank {r}] sharded invariant-depth train path, {n} steps")
    out["invariant_step_ms"] = (time.perf_counter() - t0) * 1e3 / n
    if not all(bool(torch.isfinite(v).all()) for v in lds.values()):
        raise RuntimeError("sharded invariant-depth path: a non-finite loss term")
    torch.save(flat_state(state), os.path.join(work, f"invariant_state_{r}.pt"))
    return out


def parallel_nccl(torch, np, mesh, work: str) -> dict:
    """Phase 10 (c): the sharded step on a 1-rank NCCL mesh, bit-equal to the
    unsharded step (a psum over one rank is the identity)."""
    from nope_nerf_torch.cli.train import _clone_state
    from nope_nerf_torch.data import batch_for_frame, epoch_order
    from nope_nerf_torch.training import Trainer, train_step
    cfg, scene, mc, state = parallel_setup(torch, mesh.device)
    weights, lrs, rgb_loss_type = Trainer(cfg, mc)._sched_at(0, 10000)
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    batch = batch_for_frame(scene, int(order[0]), ref_idx=int(refs[0]))
    plain = _clone_state(state)
    (state, ld_s), _ = counted(
        lambda: train_step(state, batch, weights, lrs, mc, rgb_loss_type, mesh=mesh),
        {"render_train": 1, "chamfer_bidir": 1, "dw_sm90": 1},
        f"[rank 0] sharded fused step on a 1-rank {mesh.backend} mesh")
    plain, ld_1 = train_step(plain, batch, weights, lrs, mc, rgb_loss_type)
    same = (flat_equal(torch, flat_state(state), flat_state(plain))
            and all(torch.equal(ld_s[k], ld_1[k]) for k in ld_1))
    rank_print(0, f"sharded step on a 1-rank {mesh.backend} mesh vs the unsharded step: state "
               f"and loss terms bit-equal: {same}")
    if not same:
        raise RuntimeError("the 1-rank NCCL step differs from the unsharded step")
    return {"nccl_equal": same}


def parallel_worker(argv) -> int:
    """One rank of phase 10 (`chip_smoke.py --parallel-worker <job> <rank> <world>
    <rendezvous file> <work dir>`): job gloo ((a), (b), (d), 2 ranks on
    cuda:0 joined by the file:// rendezvous) or nccl ((c), 1 rank). Writes
    <work>/<job>_<rank>.json."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nope_nerf_torch.parallel import make_mesh
    job, rank, world, rendezvous, work = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    os.environ["LOCAL_RANK"] = str(rank)
    if job == "nccl":
        mesh = make_mesh(1, backend="nccl")        # a group of its own, in memory
        out = parallel_nccl(torch, np, mesh, work)
    else:
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = make_mesh(world, backend="gloo")
        out = parallel_gloo(torch, np, mesh, work)
    torch.cuda.synchronize()
    with open(os.path.join(work, f"{job}_{rank}.json"), "w") as f:
        json.dump({"device": str(mesh.device), "backend": mesh.backend, **out}, f)
    dist.destroy_process_group()
    return 0


def cli_worker(argv) -> int:
    """One rank of phase 10 (e), launched by `python3 -m torch.distributed.run
    --standalone --nproc_per_node 2 chip_smoke.py --cli-worker <config json> <work>`:
    cli.train with tpu.mesh_shape [2] under gloo for 2 epochs straight, then 1
    epoch and a resume to 2 in another directory, counting each run's launches
    and which ranks write a checkpoint. Writes <work>/cli_<rank>.pt."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.training import checkpoints
    cfg_path, work = argv
    with open(cfg_path) as f:
        over = json.load(f)
    rank = int(os.environ["RANK"])
    writes = []
    real_write = checkpoints._write

    def counting_write(out_dir, filename, payload):
        writes.append(filename)
        return real_write(out_dir, filename, payload)

    checkpoints._write = counting_write
    steps = DISK_FRAMES - 1
    runs = {}
    for name, out_dir, epochs in (("straight", "cli_straight", 2), ("first", "cli_resume", 1),
                                  ("resumed", "cli_resume", 2)):
        over["training"]["out_dir"] = os.path.join(work, out_dir)
        cfg = load_config(overrides=over)
        n = steps * (2 if name == "straight" else 1)
        (state, _, _), _ = counted(
            lambda: train(cfg, max_epochs=epochs, backend="gloo"),
            {"render_train": n, "chamfer_bidir": n, "dw_sm90": n},
            f"[rank {rank}] cli.train with tpu.mesh_shape [2] on straight_d4, {name} run "
            f"({n} steps of {TRAIN_RAYS // 2} rays on this rank)")
        runs[name] = flat_state(state)
    checkpoints._write = real_write
    same = flat_equal(torch, runs["resumed"], runs["straight"])
    rank_print(rank, f"cli.train resume (1 epoch, checkpoint, 1 epoch) vs 2 epochs straight: "
               f"bit-equal: {same}; checkpoints this rank wrote: {writes}")
    if not same:
        raise RuntimeError("cli.train with mesh_shape: the resumed run differs from the straight one")
    torch.save({"writes": writes, "state": runs["straight"]}, os.path.join(work, f"cli_{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def run_parallel_phase(torch, np, root: str, smi: str) -> None:
    """Phase 10: the multi-device layer, in processes of its own (see the module
    docstring); the kernels are built already, so the ranks only load them."""
    from nope_nerf_torch.parallel.multihost import run_ranks
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    me = os.path.join(here, "chip_smoke.py")
    work = os.path.join(root, "parallel")
    os.makedirs(work)
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)

    def spawn(job: str, world: int) -> None:
        rendezvous = os.path.join(work, f"{job}.rendezvous")
        outs = run_ranks([[sys.executable, me, "--parallel-worker", job, str(r), str(world),
                           rendezvous, work] for r in range(world)], SPAWN_TIMEOUT_S, env=env,
                         cwd=here)
        for out in outs:
            for line in out.splitlines():
                if line.startswith("[rank"):
                    print(line)

    # (a), (b), (d): 2 ranks under gloo on cuda:0
    spawn("gloo", PARALLEL_RANKS)
    for name in ("fused", "invariant"):
        states = [torch.load(os.path.join(work, f"{name}_state_{r}.pt"), weights_only=True)
                  for r in range(PARALLEL_RANKS)]
        same = flat_equal(torch, states[0], states[1])
        print(f"sharded {name} path: the two ranks' states (params, Adam moments, generator) "
              f"bit-equal after its steps: {same}")
        if not same:
            raise RuntimeError(f"sharded {name} path: the ranks' states differ")
    frames = [np.load(os.path.join(work, f"frame_{r}.npz")) for r in range(PARALLEL_RANKS)]
    ref = np.load(os.path.join(work, "frame_ref.npz"))
    same = all(np.array_equal(f[k], ref[k]) for f in frames for k in ("rgb", "depth"))
    print(f"render_frame_multihost {RESOLUTION[0]}x{RESOLUTION[1]} on {PARALLEL_RANKS} ranks: "
          f"rgb and depth on every rank bit-equal to render_frame's: {same}")
    if not (same and np.isfinite(ref["rgb"]).all()):
        raise RuntimeError("render_frame_multihost differs from render_frame")
    gloo = [json.load(open(os.path.join(work, f"gloo_{r}.json"))) for r in range(PARALLEL_RANKS)]

    # (c): NCCL on 1 rank
    spawn("nccl", 1)

    # (e): cli.train through torch.distributed.run on phase 7's straight_d4 scene
    over = copy.deepcopy(DISK_CONFIGS["straight_d4"])
    over["dataloading"]["path"] = os.path.join(root, "V_KITTI")
    over["training"].update(n_training_points=TRAIN_RAYS, vis_geo=False, print_every=0,
                            validate_every=0, checkpoint_every=0, visualize_every=0,
                            vis_reprojection_every=0, backup_every=0)
    over["tpu"] = {"mesh_shape": [PARALLEL_RANKS]}
    cfg_path = os.path.join(work, "straight_d4_mesh.json")
    with open(cfg_path, "w") as f:
        json.dump(over, f)
    outs = run_ranks([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc_per_node", str(PARALLEL_RANKS), me, "--cli-worker", cfg_path,
                       work]], SPAWN_TIMEOUT_S, env=env, cwd=here)
    for line in outs[0].splitlines():
        if line.startswith("[rank"):
            print(line)
    cli = [torch.load(os.path.join(work, f"cli_{r}.pt"), weights_only=True)
           for r in range(PARALLEL_RANKS)]
    ckpt = os.path.join(work, "cli_resume", "model.ckpt")
    only_rank0 = (not cli[1]["writes"] and "model.ckpt" in cli[0]["writes"]
                  and os.path.exists(ckpt))
    same = flat_equal(torch, cli[0]["state"], cli[1]["state"])
    print(f"cli.train with tpu.mesh_shape [2]: only rank 0 wrote model.ckpt: {only_rank0}; the "
          f"ranks' states bit-equal: {same}")
    if not (only_rank0 and same):
        raise RuntimeError("cli.train with mesh_shape: a checkpoint written by rank 1, or the "
                           "ranks' states differ")
    wall = time.perf_counter() - t_phase
    ms = ", ".join(f"rank {r} {g['fused_step_ms']:.2f}" for r, g in enumerate(gloo))
    print(f"parallel phase: {wall:.1f} s wall on {smi}; sharded fused step ms per step {ms} "
          f"(one process {gloo[0]['one_process_step_ms']:.2f}); invariant-depth step rank 0 "
          f"{gloo[0]['invariant_step_ms']:.2f} ms (two ranks sharing one card under gloo "
          "measure the code path, not scaling)")


# ---- phase 11: the captured step graphs ------------------------------------------------

GRAPH_STEPS = {"fused": TRAIN_STEPS, "invariant": UNFUSED_STEPS, "hierarchical": HIER_STEPS,
               "fern": DISK_FRAMES - 1}


def events_ms(torch, fn, n: int) -> float:
    """ms per step of fn() running n steps, by CUDA events around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


SURVEY = []    # ["on"] under --step-graphs: report every fault of phase 11, then fail


def sync_free(torch, what: str, fn) -> None:
    """fn() once more under torch.cuda.set_sync_debug_mode('error'): a host
    readback or a blocking copy left in a step body fails the phase (fn ran
    once before, so the constants the ops cache are on the card already).
    Under --step-graphs every synchronisation is printed with its stack."""
    torch.cuda.synchronize()
    if SURVEY:
        import traceback
        import warnings
        stacks = []
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = lambda message, *a, **k: stacks.append(
                "".join(traceback.format_stack(limit=14)[:-1])
            ) if "synchroniz" in str(message) else None
            torch.cuda.set_sync_debug_mode("warn")
            stacks.clear()          # the switch itself warns once
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        for st in stacks:
            print(f"{what}: a host synchronisation at\n{st}")
        if stacks:
            SURVEY.append(f"{what}: {len(stacks)} host synchronisations")
            return
        print(f"{what}: one eager pass under set_sync_debug_mode('warn'): none")
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as err:
        raise RuntimeError(f"{what}: the step body synchronises with the host: {err}") from err
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"{what}: one eager pass under set_sync_debug_mode('error'): no host synchronisation")


def step_body_sync_free(torch, np, dev, name: str, trainer, state, scene) -> None:
    """scene_step, the body run_steps captures, run twice eagerly on a copy of
    `state`, the second time under the sync debug mode."""
    from nope_nerf_torch.cli.train import _clone_state
    from nope_nerf_torch.training.trainer import scene_step
    probe = _clone_state(state)
    weights, lrs, rgb_loss_type = trainer._schedule(0, 10000, dev)
    stack = trainer.scene_stack(scene)
    pairs = torch.as_tensor([[0, 1]], dtype=torch.int64, device=dev)
    counter = torch.zeros((1,), dtype=torch.int64, device=dev)

    def body():
        scene_step(probe, stack, pairs, counter, weights, lrs, trainer.mc, rgb_loss_type)
    body()
    sync_free(torch, f"step graphs, {name} step body", body)


def graph_train_path(torch, np, dev, name: str, cfg, mc, scene, state, expected: dict) -> dict:
    """N eager steps (Trainer(graphs=False)) and N replayed steps
    (Trainer.run_steps) from copies of one state and generator: states, loss
    terms and generators torch.equal, launches per step the same; then N more
    of each, timed by CUDA events. Before them one eager pass of the step body
    under the sync debug mode."""
    from nope_nerf_torch.cli.train import _clone_state
    from nope_nerf_torch.data import epoch_order
    from nope_nerf_torch.training import Trainer

    n = GRAPH_STEPS[name]
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    order, refs = np.resize(order, n), np.resize(refs, n)
    eager, graph = Trainer(cfg, mc, graphs=False), Trainer(cfg, mc)
    step_body_sync_free(torch, np, dev, name, eager, state, scene)

    def run(trainer, st):
        return trainer.run_steps(st, scene, order, refs, epoch=0, scheduling_start=10000)
    a, b = _clone_state(state), _clone_state(state)
    (_, ld_a), counts_a = counted(lambda: run(eager, a), expected,
                                  f"step graphs, {name}: {n} eager steps")
    (_, ld_b), counts_b = counted(lambda: run(graph, b), expected,
                                  f"step graphs, {name}: {n} replayed steps (capture first)")
    equal = (states_bit_equal(torch, a, b) and set(ld_a) == set(ld_b)
             and all(torch.equal(ld_a[k], ld_b[k]) for k in ld_a))
    torch.cuda.reset_peak_memory_stats(dev)
    eager_ms = events_ms(torch, lambda: run(eager, a), n)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9   # a replay allocates nothing
    replay_ms = events_ms(torch, lambda: run(graph, b), n)
    equal = equal and states_bit_equal(torch, a, b)
    (captured,) = graph.captured_steps()
    print(f"step graphs, {name}: {n} replayed steps against {n} eager steps from the same "
          f"state and generator, twice: states, loss terms and generators torch.equal: {equal}; "
          f"launches per step {counts_b == counts_a}; eager {eager_ms:.3f} ms, replayed "
          f"{replay_ms:.3f} ms a step; capture {captured.capture_s:.2f} s, pool "
          f"{captured.pool_mb:.0f} MB; peak device memory of the eager steps {peak_gb:.2f} GB "
          f"(max_memory_allocated: the step's working set, which the pool holds for a replay)")
    if not equal:
        raise RuntimeError(f"step graphs, {name}: the replayed steps differ from the eager ones")
    graph.release_graphs()
    return {"path": name, "steps": n, "eager_ms": eager_ms, "replay_ms": replay_ms,
            "capture_s": captured.capture_s, "pool_mb": captured.pool_mb, "peak_gb": peak_gb,
            "launches_per_step": {k: v / n for k, v in counts_b.items() if v}}


def graph_pose_opt(torch, np, dev, name: str, rcfg, nerf, eval_scene, ncfg, per_step: dict):
    """optimize_test_poses for POSE_OPT_EPOCHS epochs eagerly and replayed:
    pose parameters and c2ws torch.equal, launches per step the same. The
    replayed step's time: CUDA events around 3 * POSE_OPT_EPOCHS replays of a
    PoseOptRun's step, captured beforehand (a difference of two runs that
    each capture once carries the captures' spread, which at 384 and 512 can
    exceed the replays' own time)."""
    from nope_nerf_torch.evaluation.pose_opt import (PoseOptRun, optimize_test_poses,
                                                     pose_opt_step)
    from nope_nerf_torch.models.poses import PoseConfig, init_pose_params
    from nope_nerf_torch.training.state import init_adam

    n_eval = eval_scene.n_frames
    init = np.asarray(eval_scene.c2ws_gt) @ np.array(
        [[1, 0, 0, 0.05], [0, 1, 0, -0.03], [0, 0, 1, 0.02], [0, 0, 0, 1]], np.float32)

    def opt(epochs, graphs):
        return optimize_test_poses(nerf, None, eval_scene, ncfg, rcfg, init_c2ws=init,
                                   n_points=TRAIN_RAYS, n_epochs=epochs, log_every=0,
                                   device=dev, graphs=graphs)

    # the step body, eagerly under the sync debug mode
    pcfg = PoseConfig(num_cams=n_eval, use_init_c2w=True)
    pose = init_pose_params(pcfg, torch.as_tensor(init), device=dev)
    adam = init_adam(pose)
    imgs = torch.as_tensor(eval_scene.imgs).to(dev)
    cam = torch.as_tensor(eval_scene.K).to(dev)
    frame = torch.zeros((1,), dtype=torch.int64, device=dev)
    rate = torch.full((), 1e-3, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hw = imgs.shape[1] * imgs.shape[2]

    def body():
        rays = torch.randperm(hw, generator=gen, device=dev)[:TRAIN_RAYS]
        pose_opt_step(pose, adam, nerf, None, imgs.index_select(0, frame)[0], frame, cam, rays,
                      rate, pcfg, None, ncfg, rcfg)
    body()
    sync_free(torch, f"step graphs, {name} pose-opt step body", body)

    steps = POSE_OPT_EPOCHS * n_eval
    expected = {k: v * steps for k, v in per_step.items()}
    (p_e, c_e), counts_e = counted(lambda: opt(POSE_OPT_EPOCHS, False), expected,
                                   f"step graphs, {name} pose-opt: {POSE_OPT_EPOCHS} epochs of "
                                   f"{n_eval} frames eagerly")
    (p_g, c_g), counts_g = counted(lambda: opt(POSE_OPT_EPOCHS, True), expected,
                                   f"step graphs, {name} pose-opt: {POSE_OPT_EPOCHS} epochs of "
                                   f"{n_eval} frames replayed")
    equal = np.array_equal(c_e, c_g) and all(torch.equal(p_e[k], p_g[k]) for k in p_e)
    eager_ms = events_ms(torch, lambda: opt(POSE_OPT_EPOCHS, False), steps)
    short = events_ms(torch, lambda: opt(POSE_OPT_EPOCHS, True), 1)
    run = PoseOptRun(nerf, None, eval_scene, ncfg, rcfg, init_c2ws=init, n_points=TRAIN_RAYS,
                     device=dev)
    run.rate.fill_(1e-3)

    def replays():
        for _ in range(3 * steps):
            run.step()
    replays()
    replay_ms = events_ms(torch, replays, 3 * steps)
    print(f"step graphs, {name} pose-opt: {POSE_OPT_EPOCHS} epochs of {n_eval} frames replayed "
          f"against eagerly: pose parameters and c2ws torch.equal: {equal}; launches per step "
          f"{counts_e == counts_g}; eager {eager_ms:.3f} ms, replayed {replay_ms:.3f} ms a step "
          f"(a replayed run of {POSE_OPT_EPOCHS} epochs, capture included, {short:.1f} ms)")
    if not equal:
        raise RuntimeError(f"step graphs, {name} pose-opt: the replayed run differs from the "
                           "eager one")
    return {"path": f"pose-opt {name}", "steps": steps, "eager_ms": eager_ms,
            "replay_ms": replay_ms, "run_with_capture_ms": short,
            "launches_per_step": per_step}


def graph_cli_runs(torch, np, dev) -> None:
    """cli.train with the occupancy grid for 2 epochs, eagerly and replayed, and
    a replayed resume (1 epoch + checkpoint + 1 epoch): states and grids
    bit-equal; then tpu.scan_steps false against true, both replayed."""
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.config import load_config

    def cfg_for(out_dir, **extra):
        over = {"training": {"out_dir": out_dir, "n_training_points": TRAIN_RAYS,
                             "vis_geo": False, "print_every": 0, "validate_every": 0,
                             "checkpoint_every": 0, "visualize_every": 0,
                             "vis_reprojection_every": 0},
                "pose": {"learn_pose": True, "init_pose": True}}
        for k, v in extra.items():
            over.setdefault(k, {}).update(v)
        return load_config(overrides=over)

    steps = 8 * CLI_EPOCHS
    expected = {"render_train": steps, "chamfer_bidir": steps, "dw_sm90": steps}
    occ = {"rendering": {"occupancy_grid": True}}
    with tempfile.TemporaryDirectory() as root:
        runs = {}
        for what, graphs in (("eager", False), ("replayed", True)):
            (state, trainer, scene), _ = counted(
                lambda: train(cfg_for(os.path.join(root, what), **occ), synthetic=True,
                              max_epochs=CLI_EPOCHS, device=dev, graphs=graphs),
                expected, f"step graphs, cli.train with the occupancy grid, {CLI_EPOCHS} "
                          f"epochs {what}")
            runs[what] = (state, trainer)
        step_body_sync_free(torch, np, dev, "cli.train with the occupancy grid", trainer,
                            state, scene)
        cfg_r = cfg_for(os.path.join(root, "resumed"), **occ)
        train(cfg_r, synthetic=True, max_epochs=1, device=dev)
        runs["resumed"] = train(cfg_r, synthetic=True, max_epochs=CLI_EPOCHS, device=dev)[:2]
        (s_e, t_e), (s_g, t_g), (s_r, t_r) = runs["eager"], runs["replayed"], runs["resumed"]
        equal = (states_bit_equal(torch, s_e, s_g) and states_bit_equal(torch, s_e, s_r)
                 and torch.equal(t_e.occ_grid, t_g.occ_grid)
                 and torch.equal(t_e.occ_grid, t_r.occ_grid))
        print(f"step graphs, cli.train with the occupancy grid: {CLI_EPOCHS} epochs replayed, "
              f"and 1 epoch + resume + 1 epoch replayed, against {CLI_EPOCHS} epochs eagerly: "
              f"states and grids bit-equal: {equal}")
        if not equal:
            raise RuntimeError("step graphs: cli.train with the occupancy grid differs between "
                               "the eager and the replayed runs")
        states = {}
        for scan in (True, False):
            (states[scan], _, _), _ = counted(
                lambda: train(cfg_for(os.path.join(root, f"scan_{scan}"),
                                      tpu={"scan_steps": scan}),
                              synthetic=True, max_epochs=CLI_EPOCHS, device=dev),
                expected, f"step graphs, cli.train with tpu.scan_steps {str(scan).lower()}, "
                          f"{CLI_EPOCHS} epochs")
        equal = states_bit_equal(torch, states[True], states[False])
        print(f"step graphs, cli.train with tpu.scan_steps false against true: states "
              f"bit-equal: {equal}")
        if not equal:
            raise RuntimeError("step graphs: tpu.scan_steps false and true give other states")


def run_step_graphs(torch, np, dev, root: str, smi: str) -> None:
    """Phase 11: the captured step graphs (training/graphs.py) on every path of
    the slice, each against the same steps run eagerly, and their times."""
    import dataclasses
    from nope_nerf_torch.cli.train import build_scene
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import SceneData, make_synthetic_scene
    from nope_nerf_torch.models.nerf import init_nerf_params
    from nope_nerf_torch.training import ModelConfigs, create_train_state

    t_phase = time.perf_counter()
    h, w = RESOLUTION
    synth = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    base = {"training": {"n_training_points": TRAIN_RAYS},
            "pose": {"learn_pose": True, "init_pose": True}}
    paths = {
        "fused": (load_config(overrides=base), synth,
                  {"render_train": 1, "chamfer_bidir": 1, "dw_sm90": 1}),
        "invariant": (load_config(overrides={**base, "training": {
            "n_training_points": TRAIN_RAYS, "depth_loss_type": "invariant"}}), synth,
            {"render_fwd": 1, "render_bwd": 1, "chamfer_bidir": 1, "dw_sm90": 1}),
        "hierarchical": (hier_config(), synth,
                         {"point_mlp_fwd": 2, "point_mlp_bwd": 1, "chamfer_bidir": 1,
                          "dw_sm90": 1}),
    }
    fern_cfg = disk_config("fern", root)
    fern = build_scene(fern_cfg, False).to_device(dev)
    paths["fern"] = (fern_cfg, fern, {"render_train": 1, "chamfer_nearest": 2, "dw_sm90": 1})
    rows, faults = [], []

    def attempt(what, fn):
        """fn()'s result; under --step-graphs a fault is printed and counted,
        and the phase goes on to the next path."""
        if not SURVEY:
            return fn()
        try:
            return fn()
        except Exception:       # the survey reports every path's fault, then fails
            import traceback
            print(f"step graphs, {what}: FAILED\n{traceback.format_exc()}")
            faults.append(what)
            return None

    for name, (cfg, scene, per_step) in paths.items():
        mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
        init = scene.c2ws_gt if cfg["pose"]["init_pose"] else None
        state = create_train_state(SEED, mc, init_c2w=init, device=dev)
        n = GRAPH_STEPS[name]
        rows.append(attempt(name, lambda: graph_train_path(
            torch, np, dev, name, cfg, mc, scene, state,
            {k: v * n for k, v in per_step.items()})))
        torch.cuda.empty_cache()

    attempt("cli.train", lambda: graph_cli_runs(torch, np, dev))

    mc = ModelConfigs.from_cfg(load_config(overrides=base), num_cams=2)
    nerf = init_nerf_params(mc.nerf, torch.Generator().manual_seed(SEED), device=dev)
    eval_scene = SceneData.from_dict(make_synthetic_scene(n_frames=2, h=120, w=160))
    rows.append(attempt("pose-opt fused", lambda: graph_pose_opt(
        torch, np, dev, "fused", mc.render, nerf, eval_scene, mc.nerf,
        {"render_fwd": 1, "render_bwd": 1, "render_bwd_frozen": 1})))
    rows.append(attempt("pose-opt hierarchical", lambda: graph_pose_opt(
        torch, np, dev, "hierarchical", dataclasses.replace(mc.render, n_importance=N_IMPORTANCE),
        nerf, eval_scene, mc.nerf,
        {"point_mlp_fwd": 2, "point_mlp_bwd": 1, "point_mlp_bwd_frozen": 1})))
    faults += SURVEY[1:]
    if faults:
        raise RuntimeError(f"step graphs: faults in {', '.join(faults)}")
    print(json.dumps({"step_graphs": rows, "card": smi}))
    print(f"step-graph phase: {time.perf_counter() - t_phase:.1f} s wall")


# ---- phase 12: every sample count the JAX package's render kernels take -------------------

MANY_S = (256, 384, 1024, 2048)   # K1, K4 full and K4 frozen, at both widths
MANY_S_FWD = (2048, 4096)         # K3; 4096 spills at both widths
MANY_S_RAYS = 133                 # no multiple of the card's 132 SMs: one CTA takes two rays
# (occupancy activation, head and renderer dist_alpha, rgb_p, white_bg)
MANY_FLAGS = (("softplus", False, 1, False), ("relu", True, 2, True))
PATH_POINTS = 512                 # rendering.num_points of the phase's path
FRAME_POINTS = 2048               # one frame (K3) and one train step (K1 in 8 chunks)
GRAPH_STEPS["fused, num_points 512"] = TRAIN_STEPS


def many_params(torch, dev, gen, D: int, occ: str, dist_alpha: bool, S: int):
    """(NerfConfig, seeded params) for a many-samples case. Occupancy without
    dist_alpha is per sample, not per unit length: its density bias drops by
    log(S / 128) beside DENSITY_SHIFT, so that transmittance lasts to the last
    sample at every S."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=dist_alpha, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device=dev)
    if occ == "softplus" and not dist_alpha:
        params["density_b"] = params["density_b"] + DENSITY_SHIFT - math.log(S / 128)
    return ncfg, params


def check_many_samples(torch, dev) -> dict:
    """Phase 12 (a): K1 and K4 (full and frozen) against their plain versions
    at every S of MANY_S, at D = 256 and 128, over both flag sets of
    MANY_FLAGS on MANY_S_RAYS rays: two launches bit-equal, the frozen
    variant's d(rays) and dz equal to the full one's; then K3 at MANY_S_FWD.
    Fails if any disagrees."""
    from nope_nerf_torch.ops.fused_render import (
        _render_bwd_cuda, _train_cuda, render_chunks, render_ray_loss_fused_plain,
        render_rays_fused, render_rays_fused_bwd_plain, render_rays_fused_plain, unpack_grads)
    gen = torch.Generator().manual_seed(SEED + 21)
    failed = []

    def hold(kernel, case, got, want, per_sample):
        _, k_worst, share, shares = held(got, want, per_sample)
        if not share <= 1.0:
            failed.append(f"{kernel}: {k_worst} at {share:.2f} of its tolerance ({case})")
        return (f"worst {k_worst} at {share:.3f} of its tolerance (rays "
                f"{shares['rays']:.3f}, z {shares['z']:.3f})")

    def flat(out):
        return [t for t in (*(out[0] or []), *(out[1] or []), out[2], out[3])]

    for D in (256, 128):
        for S in MANY_S:
            rays, z, tgt = train_inputs(torch, dev, gen, MANY_S_RAYS, S)
            n_chunks = len(render_chunks(MANY_S_RAYS, S, D))
            for occ, da, rgb_p, white in MANY_FLAGS:
                ncfg, params = many_params(torch, dev, gen, D, occ, da, S)
                case = f"D={D} S={S} occ={occ} dist_alpha={da}"
                a = _train_cuda(params, rays, z, tgt, ncfg, da, rgb_p, white)
                b = _train_cuda(params, rays, z, tgt, ncfg, da, rgb_p, white)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(
                        [a[0], *a[1], *a[2], *a[3:]], [b[0], *b[1], *b[2], *b[3:]])):
                    raise RuntimeError(f"render_train: two launches differ ({case})")
                r_total, r_sums, r_grads = render_ray_loss_fused_plain(
                    params, rays, z, tgt, ncfg, da, rgb_p, white)
                rel = float(((a[0] - r_sums).abs() / r_sums.abs().clamp_min(1e-12)).max())
                if not rel <= 2e-3:
                    failed.append(f"render_train: sums rel {rel:.3g} ({case})")
                got = dict(unpack_grads(a[1], a[2], ncfg), rays=a[3], z=a[4], tgt=a[5])
                want = dict(r_grads["params"], rays=r_grads["rays"], z=r_grads["z"],
                            tgt=r_grads["tgt"])
                text = hold("render_train", case, got, want, ("rays", "z"))
                print(f"render_train vs plain, {case}, {MANY_S_RAYS} rays in {n_chunks} "
                      f"chunk(s): sums rel {rel:.3g}, {text}; two launches bit-equal")

                cot = bwd_cotangents(torch, params, rays, z, tgt, ncfg, da, True)
                a = _render_bwd_cuda(params, rays, z, *cot, ncfg, da)
                b = _render_bwd_cuda(params, rays, z, *cot, ncfg, da)
                frozen = _render_bwd_cuda(params, rays, z, *cot, ncfg, da, want_param_grads=False)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(flat(a), flat(b))):
                    raise RuntimeError(f"render_bwd: two launches differ ({case})")
                if not (torch.equal(frozen[2], a[2]) and torch.equal(frozen[3], a[3])):
                    raise RuntimeError(f"render_bwd: the frozen-network variant's d(rays), dz "
                                       f"differ from the full variant's ({case})")
                ref = render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da)
                got = dict(unpack_grads(a[0], a[1], ncfg), rays=a[2], z=a[3])
                want = dict(unpack_grads(ref[0], ref[1], ncfg), rays=ref[2], z=ref[3])
                text = hold("render_bwd", case, got, want, ("rays", "z"))
                print(f"render_bwd vs plain, {case}, cotangents rgb,dist,weights,alpha: {text}; "
                      f"two launches bit-equal; frozen-network variant equal")

    for D in (256, 128):
        for S in MANY_S_FWD:
            rays, z, _ = train_inputs(torch, dev, gen, MANY_S_RAYS, S)
            for occ, da, _, _ in MANY_FLAGS:
                ncfg, params = many_params(torch, dev, gen, D, occ, da, S)
                case = f"D={D} S={S} occ={occ} dist_alpha={da}"
                got = render_rays_fused(params, rays, z, ncfg, da, True)
                again = render_rays_fused(params, rays, z, ncfg, da, True)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise RuntimeError(f"render_fwd: two launches differ ({case})")
                ref = render_rays_fused_plain(params, rays, z, ncfg, da, True)
                report = []
                for name, g, r in zip(("rgb", "dist", "weights", "alpha"), got, ref):
                    err, tol = max_err(g, r), tolerance(r)
                    report.append(f"{name} {err:.3g}/{tol:.3g}")
                    if not err <= tol:
                        failed.append(f"render_fwd: {name} err {err:.3g} > {tol:.3g} ({case})")
                print(f"render_fwd vs plain, {case}, {MANY_S_RAYS} rays: " + ", ".join(report)
                      + "; two launches bit-equal")
    if failed:
        raise RuntimeError("many samples: kernels disagree with their plain versions: "
                           + "; ".join(failed))


def check_chunked_train(torch, dev) -> dict:
    """Phase 12 (b): K1 at 1024 rays x FRAME_POINTS, whose dW operands (20 GB)
    go in chunks of rays within OPERAND_BUDGET_BYTES, against a second launch
    (bit-equal) and against the same call with the budget raised to one chunk:
    per-ray outputs bit-equal, sums and dW/dB within their tolerances. Prints
    each call's peak device memory."""
    from nope_nerf_torch.ops import fused_render as F
    n, S, D = TRAIN_RAYS, FRAME_POINTS, 256
    gen = torch.Generator().manual_seed(SEED + 22)
    rays, z, tgt = train_inputs(torch, dev, gen, n, S)
    ncfg, params = many_params(torch, dev, gen, D, "softplus", False, S)

    def launch():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = F._train_cuda(params, rays, z, tgt, ncfg, False, 1, False)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    chunks = F.render_chunks(n, S, D)
    (a, peak_a), launched = counted(launch, {"render_train": len(chunks), "dw_sm90": len(chunks)},
                                    f"render_train {n} rays x {S} in {len(chunks)} chunks")
    b, _ = launch()
    saved = F.OPERAND_BUDGET_BYTES
    F.OPERAND_BUDGET_BYTES = sum(F.render_operand_bytes(D, n, S))
    try:
        one, peak_one = launch()
    finally:
        F.OPERAND_BUDGET_BYTES = saved

    def parts(o):
        return [o[0], *o[1], *o[2], *o[3:]]
    twice = all(torch.equal(x, y) for x, y in zip(parts(a), parts(b)))
    per_ray = all(torch.equal(x, y) for x, y in zip(a[3:], one[3:]))
    rel = float(((a[0] - one[0]).abs() / one[0].abs().clamp_min(1e-12)).max())
    got = dict(F.unpack_grads(a[1], a[2], ncfg))
    want = dict(F.unpack_grads(one[1], one[2], ncfg))
    shares = {k: grad_share(got[k], want[k], False) for k in want}
    k_worst = max(shares, key=shares.get)
    print(f"render_train {n} rays x {S} in {len(chunks)} chunks of {chunks[0][1]} rays "
          f"(operands {sum(F.render_operand_bytes(D, chunks[0][1], S)) / 1e9:.2f} GB a chunk): "
          f"two launches bit-equal {twice}; against one chunk ({sum(F.render_operand_bytes(D, n, S)) / 1e9:.2f} GB of operands): "
          f"d(rays), dz, d(tgt) bit-equal {per_ray}, sums rel {rel:.3g}, worst dW/dB block "
          f"{k_worst} at {shares[k_worst]:.3f} of its tolerance; peak device memory "
          f"{peak_a / 1e9:.2f} GB chunked, {peak_one / 1e9:.2f} GB in one chunk")
    if not (twice and per_ray and rel <= 2e-3 and shares[k_worst] <= 1.0 and len(chunks) >= 2):
        raise RuntimeError("render_train in chunks of rays disagrees with itself or with one chunk")
    return {"chunks": len(chunks), "peak_gb_chunked": peak_a / 1e9,
            "peak_gb_one_chunk": peak_one / 1e9}


def run_many_samples_path(torch, np, dev) -> dict:
    """Phase 12 (c): the default configuration's widths with rendering.num_points
    PATH_POINTS through the main path: the 188x621 train path eager against
    replayed (K1 at 1024 x 512, the dW kernel, K2), 4 steps with
    depth_loss_type invariant (K3, K4 full), cli.train and cli.eval with its
    pose optimisation (K3, K4 frozen) on the built-in scene, cli.render at
    188x621 (K3); then Trainer.render_frame at 188x621 and one train step of
    1024 rays, both at FRAME_POINTS (K1 in chunks of rays). Returns the counts
    and the inputs of the timings."""
    from nope_nerf_torch.cli.eval import evaluate
    from nope_nerf_torch.cli.render import load_scene, render
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.config import DEFAULTS, load_config, update_recursive
    from nope_nerf_torch.data import SceneData, batch_for_frame, epoch_order, make_synthetic_scene
    from nope_nerf_torch.geometry.lie import log_so3
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import plain_versions, render_chunks
    from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
    from nope_nerf_torch.training.checkpoints import save_params

    t_phase = time.perf_counter()
    h, w = RESOLUTION
    out = {}

    def train_cfg(points, **training):
        return load_config(overrides={"training": {"n_training_points": TRAIN_RAYS, **training},
                                      "rendering": {"num_points": points},
                                      "pose": {"learn_pose": True, "init_pose": True}})

    # K1 and K4 full launch their chain and dW kernels once per chunk of rays
    k = len(render_chunks(TRAIN_RAYS, PATH_POINTS, 256))
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    cfg = train_cfg(PATH_POINTS)
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    state = create_train_state(SEED, mc, init_c2w=scene.c2ws_gt, device=dev)
    out["graph"] = graph_train_path(
        torch, np, dev, "fused, num_points 512", cfg, mc, scene, state,
        {"render_train": TRAIN_STEPS * k, "chamfer_bidir": TRAIN_STEPS,
         "dw_sm90": TRAIN_STEPS * k})
    out["fused_counts"] = out["graph"]["launches_per_step"]

    icfg = train_cfg(PATH_POINTS, depth_loss_type="invariant")
    imc = ModelConfigs.from_cfg(icfg, num_cams=scene.n_frames)
    istate = create_train_state(SEED, imc, init_c2w=scene.c2ws_gt, device=dev)
    order, refs = epoch_order(scene.n_frames, shuffle=True, seed=SEED)
    (istate, lds), out["invariant_counts"] = counted(
        lambda: Trainer(icfg, imc).run_steps(istate, scene, order, refs, epoch=0,
                                             scheduling_start=10000),
        {"chamfer_bidir": UNFUSED_STEPS, "render_fwd": UNFUSED_STEPS,
         "render_bwd": UNFUSED_STEPS * k, "dw_sm90": UNFUSED_STEPS * k},
        f"train path, num_points {PATH_POINTS}, depth_loss_type invariant, {UNFUSED_STEPS} steps")
    if not all(bool(torch.isfinite(v).all()) for v in lds.values()):
        raise RuntimeError("many samples: the invariant-depth steps' loss terms are not finite")

    with tempfile.TemporaryDirectory() as root:
        ccfg = load_config(overrides={
            "training": {"out_dir": os.path.join(root, "a"), "n_training_points": TRAIN_RAYS,
                         "vis_geo": False, "print_every": 8, "validate_every": 0,
                         "checkpoint_every": 8, "visualize_every": 0,
                         "vis_reprojection_every": 0},
            "rendering": {"num_points": PATH_POINTS},
            "pose": {"learn_pose": True, "init_pose": True},
            "eval_pose": {"opt_pose_epoch": POSE_OPT_EPOCHS, "n_points": TRAIN_RAYS,
                          "type_to_eval": "eval"}})
        (tstate, _, _), _ = counted(
            lambda: train(ccfg, synthetic=True, max_epochs=1, device=dev),
            {"render_train": 8 * k, "chamfer_bidir": 8, "dw_sm90": 8 * k},
            f"cli.train, num_points {PATH_POINTS}, 1 epoch of 8 steps")
        if not os.path.exists(os.path.join(root, "a", "model.ckpt")):
            raise RuntimeError("many samples: cli.train wrote no checkpoint")
        if not all(bool(torch.isfinite(v).all()) for v in tstate.params["nerf"].values()):
            raise RuntimeError("many samples: cli.train left a non-finite parameter")
        summary, out["eval_counts"] = counted(
            lambda: evaluate(ccfg, synthetic=True, device=dev, save=False),
            {"render_fwd": POSE_OPT_EPOCHS + 1, "render_bwd": POSE_OPT_EPOCHS,
             "render_bwd_frozen": POSE_OPT_EPOCHS},
            f"cli.eval, num_points {PATH_POINTS}, {POSE_OPT_EPOCHS} pose-opt epochs on 1 view, "
            f"then its frame")
        if not all(math.isfinite(summary[k]) for k in ("mean_mse", "mean_psnr", "mean_ssim")):
            raise RuntimeError("many samples: cli.eval's metrics are not finite")
        print(f"cli.eval, num_points {PATH_POINTS}: PSNR {summary['mean_psnr']:.3f} SSIM "
              f"{summary['mean_ssim']:.4f}")

        rcfg = copy.deepcopy(DEFAULTS)
        update_recursive(rcfg, {"training": {"out_dir": os.path.join(root, "r")},
                                "rendering": {"num_points": PATH_POINTS},
                                "extract_images": {"resolution": list(RESOLUTION),
                                                   "N_novel_imgs": N_VIEWS}})
        dscene = load_scene("driving")
        c2ws = torch.as_tensor(dscene.c2ws_gt)
        nerf = init_nerf_params(NerfConfig.from_cfg(rcfg), torch.Generator().manual_seed(SEED),
                                device=dev)
        nerf["density_b"] = nerf["density_b"] + DENSITY_SHIFT
        save_params(os.path.join(root, "r"), rcfg["extract_images"]["model_file"],
                    {"nerf": nerf, "pose": {"r": log_so3(c2ws[:, :3, :3]).to(dev),
                                            "t": c2ws[:, :3, 3].contiguous().to(dev)}})
        frames, _ = counted(lambda: render(rcfg, synthetic="driving", device=dev, save=False),
                            {"render_fwd": N_VIEWS},
                            f"cli.render, num_points {PATH_POINTS}, {N_VIEWS} views at {h}x{w}")
        for f in frames:
            if (f["rgb"].shape != (h, w, 3) or not np.isfinite(f["rgb"]).all()
                    or not np.isfinite(f["depth"]).all()):
                raise RuntimeError("many samples: cli.render gave a misshapen or non-finite frame")

    # one frame and one train step at FRAME_POINTS, from the 512-sample path's state
    fcfg = train_cfg(FRAME_POINTS)
    fmc = ModelConfigs.from_cfg(fcfg, num_cams=scene.n_frames)
    ftrainer = Trainer(fcfg, fmc)
    batch = batch_for_frame(scene, 0)
    frame, out["frame_counts"] = counted(
        lambda: ftrainer.render_frame(state, batch, RESOLUTION), {"render_fwd": 1},
        f"Trainer.render_frame {h}x{w}, num_points {FRAME_POINTS}")
    with plain_versions():
        row = ftrainer.render_frame(state, batch, RESOLUTION, rows=(0, 1))
    report = []
    for name in ("rgb", "depth"):
        got, ref = (torch.as_tensor(np.asarray(f[name][:1])) for f in (frame, row))
        err, tol = max_err(got, ref), tolerance(ref)
        report.append(f"{name} {err:.3g}/{tol:.3g}")
        if not (np.isfinite(frame[name]).all() and err <= tol):
            raise RuntimeError(f"many samples: the {FRAME_POINTS}-sample frame's {name} is not "
                               f"finite or disagrees with the plain versions' row 0")
    print(f"Trainer.render_frame {h}x{w} at {FRAME_POINTS} samples: finite; row 0 vs plain "
          "versions " + ", ".join(report))
    fstate = create_train_state(SEED, fmc, init_c2w=scene.c2ws_gt, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k = len(render_chunks(TRAIN_RAYS, FRAME_POINTS, 256))
    (fstate, flds), _ = counted(
        lambda: ftrainer.run_steps(fstate, scene, order[:1], refs[:1], epoch=0,
                                   scheduling_start=10000),
        {"render_train": k, "chamfer_bidir": 1, "dw_sm90": k},
        f"train step, {TRAIN_RAYS} rays x {FRAME_POINTS}, replayed (capture first)")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    if not all(bool(torch.isfinite(v).all()) for v in flds.values()):
        raise RuntimeError(f"many samples: the {FRAME_POINTS}-sample step's loss is not finite")
    ftrainer.release_graphs()
    out["step_peak_gb"] = peak
    print(f"train step {TRAIN_RAYS} rays x {FRAME_POINTS}: K1 in {k} chunks of rays; peak device "
          f"memory {peak:.2f} GB above the {base / 1e9:.2f} GB held before it (capture pool "
          f"included); loss {float(flds['loss'][0]):.5g}")
    print(f"many-samples path: {time.perf_counter() - t_phase:.1f} s wall")
    return out


def run_many_samples(torch, np, dev) -> dict:
    """Phase 12: (a), (b) and (c) above."""
    t_phase = time.perf_counter()
    check_many_samples(torch, dev)
    out = {"chunked": check_chunked_train(torch, dev)}
    out.update(run_many_samples_path(torch, np, dev))
    print(f"many-samples phase: {time.perf_counter() - t_phase:.1f} s wall")
    return out


# ---- phase 13: hidden_dim 384 and 512 (K3, K5, K4 and K6 frozen, K6 full, K1, K4 full) ----

WIDE_D = (384, 512)               # the widths of mlp_fwd_wide_sm90.cuh's 64-point trunk
WIDE_S = (128, 1024)              # K3 on MANY_S_RAYS rays
WIDE_M = (1, 127, POINT_CHECK_M)  # K5: one point, a ragged tile, the fine pass made ragged
# (occupancy activation, head and renderer dist_alpha)
WIDE_FLAGS = (("softplus", False), ("relu", True))
WIDE_PATH_D = 512                 # model.hidden_dim of the phase's main path
WIDE_BWD_S = (128, 256, 1024)     # K4 frozen on WIDE_BWD_RAYS rays (one ray is 2 to 16 tiles)
WIDE_BWD_RAYS = 1024              # the pose-opt step's rays (7 or 8 a CTA on 132 SMs)
# K6 frozen: one point, a ragged 64-point tile, one, one and a point, a ragged second tile,
# the fine pass made ragged
WIDE_BWD_M = (1, 63, 64, 65, 127, POINT_CHECK_M)
# K6 full: those, and a 128-point row tile of the dW operands and a point (129)
WIDE_FULL_M = (1, 63, 64, 65, 127, 129, POINT_CHECK_M)
# K1 and K4 full: (rays, S) of each case: the train step's 1,024 rays at S = 128 and 512 (a
# ray is 2 or 8 tiles, 7 or 8 rays a CTA on 132 SMs; render_chunks splits 1,024 x 512 into
# 3 or 4 chunks: the chunked dW adds), 4,096 rays at S = 256 and 4,097 at S = 128 (a last
# chunk of another size). The issue's 1,024 x 256 and 133 x 128 went to 4,096 because the
# f32 plain version itself missed the 5e-3 rule against the f64 sum there, at 512 on the
# relu / dist_alpha flag set (PERF.md sections 2 and 6, tools/backward_noise.py
# --render-full)
WIDE_RENDER_CASES = ((1024, 128), (4096, 256), (4097, 128), (1024, 512))
# points below which a dW or dB block is held by the L2 part of the per-sample rule
# (wide_full_share): a block summed over this few points moves by one flipped bf16
# rounding of a single point's product, which 5e-3 of its largest entry does not admit
WIDE_FULL_SUM_POINTS = 1000
WIDE_TRAIN_STEPS = 4              # replayed fused steps against eager ones, at each width
for _D in WIDE_D:
    GRAPH_STEPS[f"hierarchical, hidden_dim {_D}"] = HIER_STEPS
    GRAPH_STEPS[f"fused, hidden_dim {_D}"] = WIDE_TRAIN_STEPS
    GRAPH_STEPS[f"invariant, hidden_dim {_D}"] = UNFUSED_STEPS


def per_sample_share(got, ref) -> float:
    """grad_share of a per-sample block; under 1000 entries the L2 rule alone
    (the "1 entry in 1000" outlier allowance admits no flip at all there)."""
    if ref.numel() >= 1000:
        return grad_share(got, ref, True)
    return float((got - ref).norm()) / (2e-2 * float(ref.norm()) + 1e-12)


def check_wide_frozen(torch, dev, widths=WIDE_D) -> dict:
    """Phase 13 (a'): K4's frozen-network variant at S of WIDE_BWD_S on
    WIDE_BWD_RAYS rays and K6's at the point counts of WIDE_BWD_M, at each
    width of `widths` (phase 13: 384 and 512, csrc/mlp_dx_wide_sm90.cuh's
    64-point chain; phase 14: 128 and 256, csrc/mlp_dx_sm90.cuh's 128-point
    chain), over both flag sets of WIDE_FLAGS: d(rays), dz and d(points),
    d(directions) within the per-sample rule of their plain versions
    (per_sample_share), two launches bit-equal. K4 runs on the pose-opt
    step's 1024 rays: one flipped ReLU mask or bf16 rounding at one sample
    moves up to six entries of its ray's d(rays) at once, and on 133 rays
    (1,197 entries) the rule's 1 entry in 1000 admits one, which the f32
    plain version itself misses against the f64 sum (PERF.md sections 2 and
    6). Returns the worst absolute error by kernel and width; fails if
    any case disagrees."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_mlp import _mlp_bwd_cuda, point_mlp_bwd_plain
    from nope_nerf_torch.ops.fused_render import _render_bwd_cuda, render_rays_fused_bwd_plain
    gen = torch.Generator().manual_seed(SEED + 35)
    worst, failed = {}, []

    def hold(kernel, D, case, names, got, again, ref):
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"{kernel}: two launches differ ({case})")
        report = []
        for name, g, r in zip(names, got, ref):
            worst[(kernel, D)] = max(worst.get((kernel, D), 0.0), max_err(g, r))
            share = per_sample_share(g, r)
            report.append(f"{name} at {share:.3f}")
            if not share <= 1.0:
                failed.append(f"{kernel}: {name} at {share:.2f} of its tolerance ({case})")
        return ", ".join(report) + " of its tolerance"

    for D in widths:
        for S in WIDE_BWD_S:
            rays, z, tgt = train_inputs(torch, dev, gen, WIDE_BWD_RAYS, S)
            for occ, da in WIDE_FLAGS:
                ncfg, params = many_params(torch, dev, gen, D, occ, da, S)
                case = f"D={D} S={S} occ={occ} dist_alpha={da}"
                cot = bwd_cotangents(torch, params, rays, z, tgt, ncfg, da, True)
                a = _render_bwd_cuda(params, rays, z, *cot, ncfg, da, want_param_grads=False)
                b = _render_bwd_cuda(params, rays, z, *cot, ncfg, da, want_param_grads=False)
                ref = render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da)
                text = hold("render_bwd_frozen", D, case, ("rays", "z"), a[2:], b[2:], ref[2:])
                print(f"render_bwd_frozen vs plain, {case}, {WIDE_BWD_RAYS} rays, cotangents "
                      f"rgb,dist,weights,alpha: {text}; two launches bit-equal")
        for M in WIDE_BWD_M:
            pts, dirs = point_inputs(torch, dev, gen, M)
            for occ, da in WIDE_FLAGS:
                ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=da,
                                  use_pallas=True)
                params = init_nerf_params(ncfg, gen, device=dev)
                case = f"D={D} {M} points occ={occ} head_dist_alpha={da}"
                cot = point_cotangents(torch, params, pts, dirs, ncfg)
                a = _mlp_bwd_cuda(params, pts, dirs, *cot, ncfg, want_param_grads=False)
                b = _mlp_bwd_cuda(params, pts, dirs, *cot, ncfg, want_param_grads=False)
                ref = point_mlp_bwd_plain(params, pts, dirs, *cot, ncfg, want_param_grads=False)
                text = hold("point_mlp_bwd_frozen", D, case, ("points", "directions"), a[2:],
                            b[2:], ref[2:])
                print(f"point_mlp_bwd_frozen vs plain, {case}: {text}; two launches bit-equal")
    if failed:
        raise RuntimeError(f"widths {widths}: frozen-network backward kernels disagree with "
                           "their plain versions: " + "; ".join(failed))
    return worst


def wide_full_share(got, ref, name: str, m: int) -> float:
    """K6 full's block `name` over m points as a share of its tolerance:
    d(points), d(directions) by per_sample_share; a dW or dB block by
    grad_tolerance (5e-3 of its largest entry), or under WIDE_FULL_SUM_POINTS
    points by the L2 part of the per-sample rule."""
    if name in ("points", "directions"):
        return per_sample_share(got, ref)
    if m < WIDE_FULL_SUM_POINTS:
        return float((got - ref).norm()) / (2e-2 * float(ref.norm()) + 1e-12)
    return grad_share(got, ref, False)


def check_wide_full(torch, dev, widths=WIDE_D) -> dict:
    """Phase 13 (a''): K6 full at the point counts of WIDE_FULL_M, at each
    width of `widths` (phase 13: 384 and 512, csrc/mlp_dx_wide_sm90.cuh's
    chain with mlp_dw_chain_sm90.cuh's OperandSaveW and dw_sm90.cuh's column
    pieces; phase 14: 128 and 256, csrc/mlp_dx_sm90.cuh's chain with
    OperandSave), over both flag sets of WIDE_FLAGS, on the cotangents of a
    smooth loss: every dW and dB block and d(points), d(directions) against
    the plain version (wide_full_share), two launches bit-equal, d(points)
    and d(directions) torch.equal to K6 frozen's. Returns the worst absolute
    error by width; fails if any case disagrees."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_mlp import _mlp_bwd_cuda, point_mlp_bwd_plain
    from nope_nerf_torch.ops.fused_render import unpack_grads
    gen = torch.Generator().manual_seed(SEED + 38)
    worst, failed = {}, []
    for D in widths:
        for M in WIDE_FULL_M:
            pts, dirs = point_inputs(torch, dev, gen, M)
            for occ, da in WIDE_FLAGS:
                ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=da,
                                  use_pallas=True)
                params = init_nerf_params(ncfg, gen, device=dev)
                case = f"D={D} {M} points occ={occ} head_dist_alpha={da}"
                cot = point_cotangents(torch, params, pts, dirs, ncfg)
                a = _mlp_bwd_cuda(params, pts, dirs, *cot, ncfg)
                b = _mlp_bwd_cuda(params, pts, dirs, *cot, ncfg)
                frozen = _mlp_bwd_cuda(params, pts, dirs, *cot, ncfg, want_param_grads=False)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip([*a[0], *a[1], a[2], a[3]],
                                                              [*b[0], *b[1], b[2], b[3]])):
                    raise RuntimeError(f"point_mlp_bwd: two launches differ ({case})")
                if not (torch.equal(frozen[2], a[2]) and torch.equal(frozen[3], a[3])):
                    raise RuntimeError(f"point_mlp_bwd: d(points), d(directions) differ from the "
                                       f"frozen-network variant's ({case})")
                ref = point_mlp_bwd_plain(params, pts, dirs, *cot, ncfg)
                got = dict(unpack_grads(a[0], a[1], ncfg), points=a[2], directions=a[3])
                want = dict(unpack_grads(ref[0], ref[1], ncfg), points=ref[2], directions=ref[3])
                shares = {k: wide_full_share(got[k], want[k], k, M) for k in want}
                k_worst = max(shares, key=shares.get)
                worst[D] = max(worst.get(D, 0.0), max(max_err(got[k], want[k]) for k in want))
                rule = "L2" if M < WIDE_FULL_SUM_POINTS else "5e-3"
                print(f"point_mlp_bwd vs plain, {case}: {len(shares)} gradient blocks (dW, dB by "
                      f"{rule}), worst {k_worst} at {shares[k_worst]:.3f} of its tolerance "
                      f"(points {shares['points']:.3f}, directions {shares['directions']:.3f}); "
                      f"two launches bit-equal; d(points), d(directions) equal to the "
                      f"frozen-network variant's")
                if not shares[k_worst] <= 1.0:
                    failed.append(f"{k_worst} at {shares[k_worst]:.2f} of its tolerance ({case})")
    if failed:
        raise RuntimeError(f"widths {widths}: point_mlp_bwd disagrees with its plain version: "
                           + "; ".join(failed))
    return worst


def check_wide_render_full(torch, dev, widths=WIDE_D) -> dict:
    """Phase 13 (a'''): K1 and K4 full at each width of `widths` (phase 13:
    384 and 512, render_full_sm90.cuh's wide kernel: mlp_dx_wide_sm90.cuh's
    chain with mlp_dw_chain_sm90.cuh's OperandSaveW<D, true> and
    dw_sm90.cuh's column pieces; phase 14: 128 and 256, its 128-point kernel
    on mlp_dx_sm90.cuh's chain) on the cases of WIDE_RENDER_CASES, over both
    flag sets of WIDE_FLAGS (K1 with rgb_p 1 and 2 in turn). Per case, by PERF.md
    section 2's rules: K1's loss sums within 2e-3 relative, its dW and dB
    within 5e-3 of each block's largest entry (grad_share; every case sums
    over 131,072 samples or more) and d(target) by the per-sample rule,
    against _train_plain; K4 full on the cotangents of a smooth loss
    (bwd_cotangents) with its dW and dB by the same rule against the plain
    version. The invariants fixed for these kernels: (I1) K4 full's d(rays)
    and dz torch.equal to its frozen-network variant's, so held by that
    variant's checks (check_wide_frozen); (I2) K4 full fed K1's own
    cotangents gives K1's dW, dB, d(rays) and dz bit for bit; (I3) two
    launches of each give the same bits, the chunked case included. A case
    that misses is reported, never retried or drawn anew. Returns the worst
    absolute error by kernel and width; fails if any case disagrees."""
    from nope_nerf_torch.ops.fused_render import (_render_bwd_cuda, _train_cuda, _train_plain,
                                                  render_chunks, render_rays_fused_bwd_plain,
                                                  unpack_grads)
    gen = torch.Generator().manual_seed(SEED + 39)
    worst, failed = {}, []

    def bits_equal(a, b) -> bool:
        flat = [(x, y) for u, v in zip(a, b)
                for x, y in (zip(u, v) if isinstance(u, (list, tuple)) else [(u, v)])]
        return all(torch.equal(x, y) for x, y in flat)

    def blocks(ncfg, dWs, dBs, **per_sample):
        return dict(unpack_grads(dWs, dBs, ncfg), **per_sample)

    for D in widths:
        for n, S in WIDE_RENDER_CASES:
            rays, z, tgt = train_inputs(torch, dev, gen, n, S)
            n_chunks = len(render_chunks(n, S, D))
            for (occ, da), rgb_p in zip(WIDE_FLAGS, (1, 2)):
                ncfg, params = many_params(torch, dev, gen, D, occ, da, S)
                case = (f"D={D} {n} rays x {S} ({n_chunks} chunk{'s' if n_chunks > 1 else ''}) "
                        f"occ={occ} dist_alpha={da}")
                # K1, twice; K4 full on K1's cotangents (its d(target) holds their negatives)
                k1 = _train_cuda(params, rays, z, tgt, ncfg, da, rgb_p, False)
                k1_again = _train_cuda(params, rays, z, tgt, ncfg, da, rgb_p, False)
                fed = _render_bwd_cuda(params, rays, z, (-k1[5][:, 0:3]).contiguous(),
                                       (-k1[5][:, 3]).contiguous(), None, None, ncfg, da)
                # K4 full, twice, and its frozen variant, on a smooth loss's cotangents
                cot = bwd_cotangents(torch, params, rays, z, tgt, ncfg, da, True)
                k4 = _render_bwd_cuda(params, rays, z, *cot, ncfg, da)
                k4_again = _render_bwd_cuda(params, rays, z, *cot, ncfg, da)
                frozen = _render_bwd_cuda(params, rays, z, *cot, ncfg, da,
                                          want_param_grads=False)
                torch.cuda.synchronize()
                if not bits_equal(k1, k1_again):
                    raise RuntimeError(f"render_train: two launches differ ({case})")
                if not bits_equal(k4, k4_again):
                    raise RuntimeError(f"render_bwd: two launches differ ({case})")
                if not bits_equal(fed, k1[1:5]):
                    raise RuntimeError(f"render_bwd fed render_train's cotangents: dW, dB, "
                                       f"d(rays), dz differ from render_train's ({case})")
                if not (torch.equal(frozen[2], k4[2]) and torch.equal(frozen[3], k4[3])):
                    raise RuntimeError(f"render_bwd: d(rays), dz differ from the frozen-network "
                                       f"variant's ({case})")
                ref1 = _train_plain(params, rays, z, tgt, ncfg, da, rgb_p, False)
                rel = float(((k1[0] - ref1[0]).abs() / ref1[0].abs().clamp_min(1e-12)).max())
                got1 = blocks(ncfg, k1[1], k1[2], tgt=k1[5])
                want1 = blocks(ncfg, ref1[1], ref1[2], tgt=ref1[5])
                s1 = {k: grad_share(got1[k], want1[k], k == "tgt") for k in want1}
                w1 = max((k for k in s1 if k != "tgt"), key=s1.get)
                ref4 = render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da)
                got4, want4 = blocks(ncfg, k4[0], k4[1]), blocks(ncfg, ref4[0], ref4[1])
                s4 = {k: grad_share(got4[k], want4[k], False) for k in want4}
                w4 = max(s4, key=s4.get)
                worst[("render_train", D)] = max(
                    worst.get(("render_train", D), 0.0), max_err(k1[0], ref1[0]),
                    max(max_err(got1[k], want1[k]) for k in want1))
                worst[("render_bwd", D)] = max(worst.get(("render_bwd", D), 0.0),
                                               max(max_err(got4[k], want4[k]) for k in want4))
                print(f"render_train vs plain, {case}, rgb_p={rgb_p}: sums at {rel / 2e-3:.3f} "
                      f"of 2e-3 relative, {len(s1) - 1} gradient blocks (dW, dB by 5e-3), worst "
                      f"{w1} at {s1[w1]:.3f} of its tolerance, d(target) at {s1['tgt']:.3f} "
                      f"(per sample); two launches bit-equal; render_bwd fed its cotangents "
                      f"bit-equal in dW, dB, d(rays), dz")
                print(f"render_bwd vs plain, {case}, cotangents rgb,dist,weights,alpha: "
                      f"{len(s4)} gradient blocks (dW, dB by 5e-3), worst {w4} at {s4[w4]:.3f} "
                      f"of its tolerance; two launches bit-equal; d(rays), dz equal to the "
                      f"frozen-network variant's")
                if not rel <= 2e-3:
                    failed.append(f"render_train: sums at {rel:.3g} relative ({case})")
                for kernel, shares, k in (("render_train", s1, w1), ("render_train", s1, "tgt"),
                                          ("render_bwd", s4, w4)):
                    if not shares[k] <= 1.0:
                        failed.append(f"{kernel}: {k} at {shares[k]:.2f} of its tolerance "
                                      f"({case})")
                del k1, k1_again, fed, k4, k4_again, frozen, ref1, ref4
    if failed:
        raise RuntimeError(f"widths {widths}: render_train / render_bwd disagree with their "
                           "plain versions: " + "; ".join(failed))
    return worst


def check_wide_kernels(torch, dev, widths=WIDE_D, seed=SEED + 31,
                       phase="wide widths", samples=WIDE_S) -> dict:
    """Phase 13 (a): K3 at each S of `samples` (WIDE_S: 128 and 1024) on
    MANY_S_RAYS rays and K5 at the point counts of WIDE_M, at each width of
    `widths` (phase 13: 384 and 512; phase 16: 640 to 1024, and S = 2048 as
    well), over both flag sets of WIDE_FLAGS: within
    tolerance() of the plain version, two launches bit-equal. Returns the
    worst error by kernel and width; every case reports before it fails if
    any disagrees."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_mlp import _mlp_fwd_cuda, point_mlp_fwd_plain
    from nope_nerf_torch.ops.fused_render import render_rays_fused, render_rays_fused_plain
    gen = torch.Generator().manual_seed(seed)
    worst, failed = {}, []

    def hold(kernel, D, case, names, got, again, ref):
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            failed.append(f"{kernel}: two launches differ ({case})")
        report = []
        for name, g, r in zip(names, got, ref):
            err, tol = max_err(g, r), tolerance(r)
            worst[(kernel, D)] = max(worst.get((kernel, D), 0.0), err)
            report.append(f"{name} {err:.3g}/{tol:.3g}")
            if not err <= tol:
                failed.append(f"{kernel}: {name} err {err:.3g} > {tol:.3g} ({case})")
        return ", ".join(report)

    for D in widths:
        for S in samples:
            rays, z, _ = train_inputs(torch, dev, gen, MANY_S_RAYS, S)
            for occ, da in WIDE_FLAGS:
                ncfg, params = many_params(torch, dev, gen, D, occ, da, S)
                case = f"D={D} S={S} occ={occ} dist_alpha={da}"
                got = render_rays_fused(params, rays, z, ncfg, da, True)
                again = render_rays_fused(params, rays, z, ncfg, da, True)
                ref = render_rays_fused_plain(params, rays, z, ncfg, da, True)
                text = hold("render_fwd", D, case, ("rgb", "dist", "weights", "alpha"), got,
                            again, ref)
                print(f"render_fwd vs plain, {case}, {MANY_S_RAYS} rays: {text}; two launches "
                      f"bit-equal: {all(torch.equal(x, y) for x, y in zip(got, again))}")
        for M in WIDE_M:
            pts, dirs = point_inputs(torch, dev, gen, M)
            for occ, da in WIDE_FLAGS:
                ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=da,
                                  use_pallas=True)
                params = init_nerf_params(ncfg, gen, device=dev)
                case = f"D={D} {M} points occ={occ} head_dist_alpha={da}"
                got = _mlp_fwd_cuda(params, pts, dirs, ncfg)
                again = _mlp_fwd_cuda(params, pts, dirs, ncfg)
                ref = point_mlp_fwd_plain(params, pts, dirs, ncfg)
                text = hold("point_mlp_fwd", D, case, ("rgb", "density"), got, again, ref)
                print(f"point_mlp_fwd vs plain, {case}: {text}; two launches bit-equal: "
                      f"{all(torch.equal(x, y) for x, y in zip(got, again))}")
    if failed:
        raise RuntimeError(f"{phase}: kernels disagree with their plain versions: "
                           + "; ".join(failed))
    return worst


def run_wide_eval(torch, np, dev, D: int, nerf) -> dict:
    """Phase 13 (b'): test-time pose optimisation at model.hidden_dim D from
    phase 13's seeded weights, written as a checkpoint of the built-in 8-frame
    120x160 scene's train split: cli.eval with POSE_OPT_EPOCHS pose-opt
    epochs on its held-out view (K3 and K4's frozen variant once a step, K3
    once more for the frame; its metrics finite); optimize_test_poses
    replayed from its captured step against eager runs (graph_pose_opt:
    torch.equal), fused and with n_importance N_IMPORTANCE; HIER_STEPS
    hierarchical pose-opt steps (K5 twice and K6's frozen variant once a
    step). Returns the counts and the replay timings."""
    from nope_nerf_torch.cli.eval import evaluate, split_synthetic_scene
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.evaluation.pose_opt import pose_opt_step
    from nope_nerf_torch.models.poses import PoseConfig, init_pose_params
    from nope_nerf_torch.training import ModelConfigs, create_train_state
    from nope_nerf_torch.training.checkpoints import save_params
    from nope_nerf_torch.training.state import init_adam

    out = {}
    train_scene, eval_scene, _ = split_synthetic_scene()
    n_eval = eval_scene.n_frames
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = load_config(overrides={
            "model": {"hidden_dim": D}, "training": {"out_dir": out_dir},
            "pose": {"learn_pose": True, "init_pose": True},
            "eval_pose": {"opt_pose_epoch": POSE_OPT_EPOCHS, "n_points": TRAIN_RAYS,
                          "type_to_eval": "eval"}})
        mc = ModelConfigs.from_cfg(cfg, num_cams=train_scene.n_frames)
        state = create_train_state(SEED, mc, init_c2w=torch.as_tensor(train_scene.c2ws_gt),
                                   device=dev)
        state.params["nerf"] = {k: v.detach().clone() for k, v in nerf.items()}
        save_params(out_dir, cfg["training"]["load_dir"], state.params)
        steps = n_eval * POSE_OPT_EPOCHS
        summary, out["eval_counts"] = counted(
            lambda: evaluate(cfg, synthetic=True, device=dev, save=False),
            {"render_fwd": steps + n_eval, "render_bwd": steps, "render_bwd_frozen": steps},
            f"cli.eval, hidden_dim {D}, {POSE_OPT_EPOCHS} pose-opt epochs on {n_eval} view, "
            "then its frame")
    for k in ("mean_mse", "mean_psnr", "mean_ssim"):
        if not math.isfinite(summary[k]):
            raise RuntimeError(f"cli.eval at hidden_dim {D}: {k} is not finite")
    print(f"cli.eval, hidden_dim {D}: PSNR {summary['mean_psnr']:.3f} SSIM "
          f"{summary['mean_ssim']:.4f} (finite)")
    nerf = {k: v.detach() for k, v in nerf.items()}
    hcfg = dataclasses.replace(mc.render, n_importance=N_IMPORTANCE)
    out["graph_fused"] = graph_pose_opt(
        torch, np, dev, f"fused, hidden_dim {D}", mc.render, nerf, eval_scene, mc.nerf,
        {"render_fwd": 1, "render_bwd": 1, "render_bwd_frozen": 1})
    out["graph_hier"] = graph_pose_opt(
        torch, np, dev, f"hierarchical, hidden_dim {D}", hcfg, nerf, eval_scene, mc.nerf,
        {"point_mlp_fwd": 2, "point_mlp_bwd": 1, "point_mlp_bwd_frozen": 1})

    img = torch.as_tensor(eval_scene.imgs[0]).to(dev)
    cam = torch.as_tensor(eval_scene.K).to(dev)
    pcfg = PoseConfig(num_cams=1, use_init_c2w=True)
    ray_idx = torch.randperm(img.shape[0] * img.shape[1],
                             generator=torch.Generator(device=dev).manual_seed(SEED + 36),
                             device=dev)[:TRAIN_RAYS]
    pose = init_pose_params(pcfg, torch.as_tensor(eval_scene.c2ws_gt), device=dev)
    adam = init_adam(pose)

    def hier_steps():
        return [float(pose_opt_step(pose, adam, nerf, None, img, 0, cam, ray_idx, 1e-3, pcfg,
                                    None, mc.nerf, hcfg)) for _ in range(HIER_STEPS)]
    losses, out["hier_pose_counts"] = counted(
        hier_steps, {"point_mlp_fwd": 2 * HIER_STEPS, "point_mlp_bwd": HIER_STEPS,
                     "point_mlp_bwd_frozen": HIER_STEPS},
        f"hierarchical pose-opt, hidden_dim {D}, {HIER_STEPS} steps")
    if not all(math.isfinite(v) for v in losses) or not bool(pose["t"].abs().max() > 0):
        raise RuntimeError(f"hierarchical pose optimisation at hidden_dim {D}: non-finite loss "
                           "or a pose that did not move")
    print(f"hierarchical pose-opt, hidden_dim {D}: loss per step "
          + " ".join(f"{v:.5f}" for v in losses))
    return out


def run_wide_train(torch, np, dev, D: int, nerf) -> dict:
    """Phase 13 (c): hierarchical training (rendering.n_importance
    N_IMPORTANCE) at model.hidden_dim D from phase 13's seeded weights,
    written as a checkpoint that cli.train loads (training.
    load_ckpt_model_only): one epoch of the built-in 8-frame 120x160 scene
    through cli.train (its replayed step graph), per step K5 twice, K6 full
    and the dW kernel once, Chamfer once, K1 and K4 full never, the loss
    finite; then HIER_STEPS steps of Trainer.run_steps replayed against the
    same steps eager on the 188x621 4-frame scene (graph_train_path: states
    torch.equal), with the replayed steps' peak device memory. Returns the
    counts and the step-graph result."""
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.data import SceneData, make_synthetic_scene
    from nope_nerf_torch.training import ModelConfigs, create_train_state
    from nope_nerf_torch.training.checkpoints import save_params

    out = {}
    steps = 8   # one epoch of the built-in scene
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = hier_config(model={"hidden_dim": D},
                          training={"out_dir": out_dir, "load_ckpt_model_only": True,
                                    "vis_geo": False, "print_every": steps,
                                    "validate_every": 0, "checkpoint_every": steps,
                                    "visualize_every": 0, "vis_reprojection_every": 0})
        scene = SceneData.from_dict(make_synthetic_scene(n_frames=steps, h=120, w=160))
        mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
        seeded = create_train_state(SEED, mc, init_c2w=torch.as_tensor(scene.c2ws_gt),
                                    device=dev)
        seeded.params["nerf"] = {k: v.detach().clone() for k, v in nerf.items()}
        save_params(out_dir, cfg["training"]["load_dir"], seeded.params)
        (state, _, _), out["train_counts"] = counted(
            lambda: train(cfg, synthetic=True, max_epochs=1, device=dev),
            {"point_mlp_fwd": 2 * steps, "point_mlp_bwd": steps, "dw_sm90": steps,
             "chamfer_bidir": steps},
            f"cli.train, hidden_dim {D}, n_importance {N_IMPORTANCE}, 1 epoch of {steps} steps "
            "from the seeded checkpoint")
    moved = any(not torch.equal(state.params["nerf"][k], v) for k, v in nerf.items())
    finite = all(bool(torch.isfinite(v).all()) for d in state.params.values() for v in d.values())
    if not (moved and finite):
        raise RuntimeError(f"cli.train at hidden_dim {D}: the nerf parameters did not move or are "
                           "not finite")
    print(f"cli.train, hidden_dim {D}: parameters finite and moved from the checkpoint's")

    h, w = RESOLUTION
    hcfg = hier_config(model={"hidden_dim": D})
    tscene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    hmc = ModelConfigs.from_cfg(hcfg, num_cams=tscene.n_frames)
    hstate = create_train_state(SEED, hmc, init_c2w=tscene.c2ws_gt, device=dev)
    hstate.params["nerf"] = {k: v.detach().clone() for k, v in nerf.items()}
    out["graph"] = graph_train_path(
        torch, np, dev, f"hierarchical, hidden_dim {D}", hcfg, hmc, tscene, hstate,
        {"point_mlp_fwd": 2 * HIER_STEPS, "point_mlp_bwd": HIER_STEPS, "dw_sm90": HIER_STEPS,
         "chamfer_bidir": HIER_STEPS})
    return out


def run_wide_fused_train(torch, np, dev, D: int, nerf) -> dict:
    """Phase 13 (c'): the default config's training at model.hidden_dim D from
    phase 13's seeded weights, through K1 and K4 full's wide kernel: cli.train,
    one epoch of the fused config on the built-in 8-frame 120x160 scene from
    the seeded checkpoint (K1, K2 and the dW kernel once a step, the nerf
    parameters finite and moved); then on the 188x621 4-frame scene
    WIDE_TRAIN_STEPS fused steps (K1, the dW kernel, K2) and UNFUSED_STEPS
    depth_loss_type invariant steps (K3, K4 full, the dW kernel, K2) of
    Trainer.run_steps replayed from their captured graphs against the same
    steps eager (graph_train_path: states torch.equal), with their times,
    pool and peak device memory. Returns the counts and both step-graph
    results."""
    from nope_nerf_torch.cli.train import train
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import SceneData, make_synthetic_scene
    from nope_nerf_torch.training import ModelConfigs, create_train_state
    from nope_nerf_torch.training.checkpoints import save_params

    out = {}
    steps = 8   # one epoch of the built-in scene
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = load_config(overrides={
            "model": {"hidden_dim": D},
            "training": {"out_dir": out_dir, "n_training_points": TRAIN_RAYS,
                         "load_ckpt_model_only": True, "vis_geo": False, "print_every": steps,
                         "validate_every": 0, "checkpoint_every": steps, "visualize_every": 0,
                         "vis_reprojection_every": 0},
            "pose": {"learn_pose": True, "init_pose": True}})
        scene = SceneData.from_dict(make_synthetic_scene(n_frames=steps, h=120, w=160))
        mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
        seeded = create_train_state(SEED, mc, init_c2w=torch.as_tensor(scene.c2ws_gt),
                                    device=dev)
        seeded.params["nerf"] = {k: v.detach().clone() for k, v in nerf.items()}
        save_params(out_dir, cfg["training"]["load_dir"], seeded.params)
        (state, _, _), out["fused_train_counts"] = counted(
            lambda: train(cfg, synthetic=True, max_epochs=1, device=dev),
            {"render_train": steps, "chamfer_bidir": steps, "dw_sm90": steps},
            f"cli.train, hidden_dim {D}, the default fused config, 1 epoch of {steps} steps from "
            "the seeded checkpoint")
    moved = any(not torch.equal(state.params["nerf"][k], v) for k, v in nerf.items())
    finite = all(bool(torch.isfinite(v).all()) for d in state.params.values() for v in d.values())
    if not (moved and finite):
        raise RuntimeError(f"cli.train (fused) at hidden_dim {D}: the nerf parameters did not "
                           "move or are not finite")
    print(f"cli.train (fused), hidden_dim {D}: parameters finite and moved from the "
          "checkpoint's")

    h, w = RESOLUTION
    tscene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    base = {"model": {"hidden_dim": D}, "pose": {"learn_pose": True, "init_pose": True}}
    for name, training, per_step in (
            ("fused", {}, {"render_train": 1, "chamfer_bidir": 1, "dw_sm90": 1}),
            ("invariant", {"depth_loss_type": "invariant"},
             {"render_fwd": 1, "render_bwd": 1, "chamfer_bidir": 1, "dw_sm90": 1})):
        gcfg = load_config(overrides={**base, "training": {"n_training_points": TRAIN_RAYS,
                                                           **training}})
        gmc = ModelConfigs.from_cfg(gcfg, num_cams=tscene.n_frames)
        gstate = create_train_state(SEED, gmc, init_c2w=tscene.c2ws_gt, device=dev)
        gstate.params["nerf"] = {k: v.detach().clone() for k, v in nerf.items()}
        key = f"{name}, hidden_dim {D}"
        n = GRAPH_STEPS[key]
        out[f"graph_{name}"] = graph_train_path(torch, np, dev, key, gcfg, gmc, tscene, gstate,
                                                {k: v * n for k, v in per_step.items()})
        torch.cuda.empty_cache()
    return out


def run_wide_render(torch, np, dev, D: int) -> dict:
    """Phase 13 (b) and phase 16 (b) at model.hidden_dim D: cli.render over
    N_VIEWS novel views at 188x621 from a checkpoint of seeded random weights
    written by the port (K3 once a frame; frames finite; rows 0-7 of view 0
    against the plain version), Trainer.render_frame at 188x621 (K3 once) and
    with rendering.n_importance N_IMPORTANCE (K5 twice a chunk), each with
    rows 0-7 against the plain versions. Returns what the timings need."""
    from nope_nerf_torch.cli.render import load_scene, render
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import SceneData, batch_for_frame, make_synthetic_scene
    from nope_nerf_torch.geometry.lie import log_so3
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import plain_versions, render_rays_fused_plain
    from nope_nerf_torch.ops.render import RenderConfig
    from nope_nerf_torch.training import ModelConfigs, Trainer, create_train_state
    from nope_nerf_torch.training.checkpoints import load_params, save_params

    h, w = RESOLUTION
    out = {}
    scene = load_scene("driving")
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = load_config(overrides={"model": {"hidden_dim": D},
                                     "training": {"out_dir": out_dir},
                                     "extract_images": {"resolution": list(RESOLUTION),
                                                        "N_novel_imgs": N_VIEWS}})
        ncfg, rcfg = NerfConfig.from_cfg(cfg), RenderConfig.from_cfg(cfg)
        if not ncfg.use_pallas:
            raise RuntimeError(f"hidden_dim {D}: the config does not take the fused route")
        c2ws = torch.as_tensor(scene.c2ws_gt)
        nerf = init_nerf_params(ncfg, torch.Generator().manual_seed(SEED + 32), device=dev)
        nerf["density_b"] = nerf["density_b"] + DENSITY_SHIFT
        save_params(out_dir, cfg["extract_images"]["model_file"],
                    {"nerf": nerf, "pose": {"r": log_so3(c2ws[:, :3, :3]).to(dev),
                                            "t": c2ws[:, :3, 3].contiguous().to(dev)}})
        frames, out["render_counts"] = counted(
            lambda: render(cfg, synthetic="driving", device=dev, save=False),
            {"render_fwd": N_VIEWS}, f"cli.render, hidden_dim {D}, {N_VIEWS} views at {h}x{w}")
        params, _ = load_params(out_dir, cfg["extract_images"]["model_file"], device=dev)
    for f in frames:
        if (f["rgb"].shape != (h, w, 3) or f["depth"].shape != (h, w)
                or not (np.isfinite(f["rgb"]).all() and np.isfinite(f["depth"]).all())):
            raise RuntimeError(f"hidden_dim {D}: cli.render gave a misshapen or non-finite frame")
    traj, view0_inputs = novel_view0(torch, dev, cfg, rcfg, scene, params)
    table, z, ray_norm = view0_inputs(8)
    ref = render_rays_fused_plain(params["nerf"], table, z, ncfg, rcfg.dist_alpha,
                                  want_aux=False)
    report = []
    for name, g, r in (("rgb", frames[0]["rgb"][:8].reshape(-1, 3), ref[0]),
                       ("depth", frames[0]["depth"][:8].reshape(-1), ref[1] / ray_norm)):
        err, tol = max_err(torch.as_tensor(g, device=dev), r), tolerance(r)
        report.append(f"{name} {err:.3g}/{tol:.3g}")
        if not err <= tol:
            raise RuntimeError(f"hidden_dim {D}: cli.render's view 0 disagrees with the plain "
                               f"version: {name}")
    print(f"cli.render, hidden_dim {D}: frames finite; view 0 rgb mean "
          f"{frames[0]['rgb'].mean():.4f}, depth mean {frames[0]['depth'].mean():.4f}; rows 0-7 "
          "vs plain " + ", ".join(report))
    out.update(params=params, traj=traj, scene=scene, ncfg=ncfg, rcfg=rcfg,
               view0_inputs=view0_inputs)

    # Trainer.render_frame, fused (K3) and hierarchical (K5 twice a chunk), from one state
    tscene = SceneData.from_dict(make_synthetic_scene(n_frames=4, h=h, w=w)).to_device(dev)
    fcfg = load_config(overrides={"model": {"hidden_dim": D},
                                  "training": {"n_training_points": TRAIN_RAYS},
                                  "pose": {"learn_pose": True, "init_pose": True}})
    fmc = ModelConfigs.from_cfg(fcfg, num_cams=tscene.n_frames)
    hcfg = hier_config(model={"hidden_dim": D})
    hmc = ModelConfigs.from_cfg(hcfg, num_cams=tscene.n_frames)
    state = create_train_state(SEED, fmc, init_c2w=tscene.c2ws_gt, device=dev)
    state.params["nerf"]["density_b"] += DENSITY_SHIFT
    batch = batch_for_frame(tscene, 1)
    chunks = math.ceil(h * w / 131072)
    hier_trainer = Trainer(hcfg, hmc)
    for name, trainer, expected in (
            ("fused", Trainer(fcfg, fmc), {"render_fwd": chunks}),
            (f"hierarchical (n_importance {N_IMPORTANCE})", hier_trainer,
             {"point_mlp_fwd": 2 * chunks})):
        frame, counts = counted(lambda: trainer.render_frame(state, batch, RESOLUTION), expected,
                                f"Trainer.render_frame {h}x{w}, hidden_dim {D}, {name}, "
                                f"{chunks} chunk")
        with plain_versions():
            slab = trainer.render_frame(state, batch, RESOLUTION, rows=(0, 8))
        report = []
        for key in ("rgb", "depth"):
            g, r = torch.as_tensor(frame[key][:8]), torch.as_tensor(slab[key])
            err, tol = max_err(g, r), tolerance(r)
            report.append(f"{key} {err:.3g}/{tol:.3g}")
            if not (np.isfinite(frame[key]).all() and err <= tol):
                raise RuntimeError(f"hidden_dim {D}: the {name} frame is not finite or its rows "
                                   f"0-7 disagree with the plain versions: {key}")
        print(f"Trainer.render_frame, hidden_dim {D}, {name}: finite; rgb mean "
              f"{frame['rgb'].mean():.4f}; rows 0-7 vs plain versions " + ", ".join(report))
        out["fused_frame_counts" if name == "fused" else "hier_frame_counts"] = counts
    out.update(state=state, batch=batch, hier_trainer=hier_trainer)
    return out


def run_wide_path(torch, np, dev, D: int) -> dict:
    """Phase 13 (b) at model.hidden_dim D: the render path (run_wide_render);
    cli.eval's pose optimisation and the pose-opt steps from the same weights
    (run_wide_eval); hierarchical training from them (K6 full;
    run_wide_train); the default config's fused and invariant-depth training
    from them (K1, K4 full; run_wide_fused_train). Returns what the timings
    need."""
    out = run_wide_render(torch, np, dev, D)
    params = out["params"]
    out.update(run_wide_eval(torch, np, dev, D, params["nerf"]))
    out.update(run_wide_train(torch, np, dev, D, params["nerf"]))

    out.update(run_wide_fused_train(torch, np, dev, D, params["nerf"]))
    return out


def run_wide(torch, np, dev) -> dict:
    """Phase 13: (a) the kernels at both widths, forward, frozen backward, K6
    full, K1 and K4 full, (b) the path at each: render, eval, pose
    optimisation, hierarchical, fused and invariant-depth training."""
    t_phase = time.perf_counter()
    out = {"worst": check_wide_kernels(torch, dev)}
    out["worst"].update(check_wide_frozen(torch, dev))
    out["worst_full"] = check_wide_full(torch, dev)
    out["worst"].update(check_wide_render_full(torch, dev))
    for D in WIDE_D:
        out[D] = run_wide_path(torch, np, dev, D)
    print(f"wide phase: {time.perf_counter() - t_phase:.1f} s wall")
    return out


# ---- phase 14: hidden_dim 128 and 256 on phase 13's backward holds ----------------

NARROW_D = (128, 256)             # the widths of csrc/mlp_dx_sm90.cuh's 128-point chain


def run_narrow(torch, dev) -> dict:
    """Phase 14: K1 and K4 full, K4 frozen, K6 full and K6 frozen at
    NARROW_D (csrc/mlp_dx_sm90.cuh's 128-point chain, whose forward sums each
    ring slice from zero) on phase 13's cases, by its rules and with its
    invariants, none loosened: check_wide_render_full (WIDE_RENDER_CASES,
    both flag sets, (I1) to (I3)), check_wide_frozen (K4 frozen on
    WIDE_BWD_RAYS rays x WIDE_BWD_S beside phase 12's 133 rays, K6 frozen at
    WIDE_BWD_M) and check_wide_full (K6 full at WIDE_FULL_M, d(points) and
    d(directions) torch.equal to K6 frozen's). Every hold runs and reports
    before the phase fails on any that missed; a miss is never retried.
    Returns the worst absolute errors."""
    t_phase = time.perf_counter()
    out, missed = {}, []
    for name, check in (("render_full", check_wide_render_full), ("frozen", check_wide_frozen),
                        ("full", check_wide_full)):
        try:
            out[name] = check(torch, dev, NARROW_D)
        except RuntimeError as e:
            missed.append(str(e))
    print(f"narrow phase: {time.perf_counter() - t_phase:.1f} s wall")
    if missed:
        raise RuntimeError("phase 14: " + " | ".join(missed))
    return out


# ---- phase 15: one forward, K3's and K5's operands against the backward kernels' --

FORWARD_D = (128, 256, 384, 512)  # every width the kernels take
FORWARD_RENDER_CASES = ((1024, 128), (1024, 256), (133, 128))   # rays x S: (F1), (F2)


def operands_differ(torch, a, b, D: int, rows: int, de: bool) -> list:
    """The X operands (fused_mlp.x_operand_views: every row of the written
    row tiles, each operand's own columns) in which two flat buffers differ."""
    from nope_nerf_torch.ops.fused_mlp import x_operand_views
    va, vb = x_operand_views(a, D, rows, de), x_operand_views(b, D, rows, de)
    return [name for name in va if not torch.equal(va[name], vb[name])]


def differ_text(names: list) -> str:
    return "True" if not names else "False (" + ", ".join(names) + ")"


def run_one_forward(torch, dev) -> dict:
    """Phase 15: every kernel runs one forward (mlp_fwd_sm90.cuh's
    mlp_tile_masks, mlp_fwd_wide_sm90.cuh's mlp_tile_w_masks), as the JAX
    kernels run _fwd_tail. At each width of FORWARD_D and both flag sets of
    WIDE_FLAGS (many_params' weights), the check builds of K3 and K5, which
    write the X operands of the dW products (pe, x0..x7, feat; K5 also de),
    are held torch.equal to the operands the backward kernels hand their dW
    kernel from the same inputs and weights, operand by operand
    (operands_differ): (F1) K3's against K4 full's and (F2) against K1's
    (train_inputs' targets) on FORWARD_RENDER_CASES, one chunk of rays
    (render_chunks) at a time; (F3) K5's against K6 full's at WIDE_FULL_M
    points. Each also holds the check build's outputs torch.equal to the main
    build's. Every hold runs and reports before the phase fails
    on any that missed; a miss is never retried or drawn anew. Returns the
    holds' count."""
    from nope_nerf_torch.ops import fused_mlp as FM
    from nope_nerf_torch.ops import fused_render as F
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 40)
    missed, held = [], 0

    def hold(what: str, ok: bool) -> None:
        nonlocal held
        held += 1
        if not ok:
            missed.append(what)

    for D in FORWARD_D:
        for occ, da in WIDE_FLAGS:
            for n, S in FORWARD_RENDER_CASES:
                rays, z, tgt = train_inputs(torch, dev, gen, n, S)
                ncfg, params = many_params(torch, dev, gen, D, occ, da, S)
                g_rgb = (torch.randn(n, 3, generator=gen) * 1e-3).to(dev)
                g_dist = (torch.randn(n, generator=gen) * 1e-3).to(dev)
                rgb, dist, _, _ = F.render_rays_fused(params, rays, z, ncfg, da, want_aux=False)
                chunks = F.render_chunks(n, S, D)
                same = {"outputs": True, "F1": [], "F2": []}
                for a, b in chunks:
                    k3_rgb, k3_dist, k3 = F.render_fwd_operands(params, rays[a:b], z[a:b], ncfg,
                                                                da)
                    k4, k1 = [], []
                    F._render_bwd_cuda(params, rays[a:b], z[a:b], g_rgb[a:b], g_dist[a:b], None,
                                       None, ncfg, da, operands=k4)
                    F._train_cuda(params, rays[a:b], z[a:b], tgt[a:b], ncfg, da, 1, False,
                                  operands=k1)
                    torch.cuda.synchronize()
                    same["outputs"] &= torch.equal(k3_rgb, rgb[a:b]) and torch.equal(k3_dist,
                                                                                     dist[a:b])
                    for k, other in (("F1", k4[0]), ("F2", k1[0])):
                        same[k] += [name for name in operands_differ(torch, k3, other, D,
                                                                     (b - a) * S, False)
                                    if name not in same[k]]
                    del k3, k4, k1
                case = f"D={D} {n} rays x {S} occ={occ} dist_alpha={da}"
                print(f"one forward, {case} in {len(chunks)} chunk(s) of rays: (F1) K3's X "
                      f"operands torch.equal to K4 full's: {differ_text(same['F1'])}; (F2) to "
                      f"K1's: {differ_text(same['F2'])}; the check build's rgb, dist "
                      f"torch.equal to render_fwd's: {same['outputs']}")
                hold(f"F1 K3 {case}", not same["F1"])
                hold(f"F2 K3 {case}", not same["F2"])
                hold(f"outputs K3 {case}", same["outputs"])
            for M in WIDE_FULL_M:
                pts, dirs = point_inputs(torch, dev, gen, M)
                ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=da,
                                  use_pallas=True)
                params = init_nerf_params(ncfg, gen, device=dev)
                p_rgb = (torch.randn(M, 3, generator=gen) * 1e-6).to(dev)
                p_den = torch.full((M, 1), 0.1 / M, device=dev)
                with torch.no_grad():
                    rgb, density = FM.point_mlp(params, pts, dirs, ncfg)
                k5_rgb, k5_density, k5 = FM.point_mlp_fwd_operands(params, pts, dirs, ncfg)
                k6 = []
                FM._mlp_bwd_cuda(params, pts, dirs, p_rgb, p_den, ncfg, operands=k6)
                torch.cuda.synchronize()
                f3 = operands_differ(torch, k5, k6[0], D, M, True)
                outs = torch.equal(k5_rgb, rgb) and torch.equal(k5_density, density)
                case = f"D={D} {M} points occ={occ} head_dist_alpha={da}"
                print(f"one forward, {case}: (F3) K5's X operands torch.equal to K6 full's: "
                      f"{differ_text(f3)}; the check build's rgb, density torch.equal to "
                      f"point_mlp_fwd's: {outs}")
                hold(f"F3 K5 {case}", not f3)
                hold(f"outputs K5 {case}", outs)
                del k5, k6
            torch.cuda.empty_cache()
    print(f"one-forward phase: {held - len(missed)} of {held} holds, "
          f"{time.perf_counter() - t_phase:.1f} s wall")
    if missed:
        raise RuntimeError("phase 15: missed " + "; ".join(missed))
    return {"holds": held}


# ---- phase 16: hidden_dim 640 to 1024 on the forward trunk (K3, K5) --------------------

XWIDE_D = (640, 768, 896, 1024)   # the widths of mlp_fwd_xwide_sm90.cuh's trunk
# K3 on MANY_S_RAYS rays: at 2048 samples, past 1,536 at 1024 (4,480 at 640), z and the
# raw heads leave shared memory for the spill scratch, which the staging follows
XWIDE_S = WIDE_S + (2048,)
XWIDE_PATH_D = (1024, 640)        # model.hidden_dim of the phase's main path; phase 9 times both


def check_xwide_backward_raises(torch, dev, D: int) -> list:
    """Phase 16 (c): at hidden_dim D the five backward kernels stop before any
    device work, through the calls a user makes: render_ray_loss_fused (K1),
    render_rays_fused under autograd with parameters that want gradients (K4
    full) and with only the rays wanting them (K4 frozen), point_mlp the same
    way (K6 full, K6 frozen). Each raises NotImplementedError naming its entry
    of Queue 3 (c), and no kernel launches. Returns the misses."""
    from nope_nerf_torch.ops import fused_mlp as FM
    from nope_nerf_torch.ops import fused_render as F
    gen = torch.Generator().manual_seed(SEED + 42)
    rays, z, tgt = train_inputs(torch, dev, gen, MANY_S_RAYS, 128)
    ncfg, params = many_params(torch, dev, gen, D, "softplus", False, 128)
    pts, dirs = point_inputs(torch, dev, gen, 127)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    calls = {
        "render_train (K1)": ("item 4", lambda: F.render_ray_loss_fused(params, rays, z, tgt,
                                                                      ncfg, False, 1, False)),
        "render_bwd (K4 full)": ("item 4", lambda: F.render_rays_fused(leaves, rays, z, ncfg)),
        "render_bwd_frozen (K4 frozen)": ("item 2", lambda: F.render_rays_fused(
            params, rays.detach().requires_grad_(True), z, ncfg)),
        "point_mlp_bwd (K6 full)": ("item 3", lambda: FM.point_mlp(leaves, pts, dirs, ncfg)),
        "point_mlp_bwd_frozen (K6 frozen)": ("item 2", lambda: FM.point_mlp(
            params, pts.detach().requires_grad_(True), dirs, ncfg))}
    missed = []
    for name, (item, fn) in calls.items():
        def attempt(fn=fn):
            try:
                fn()
            except NotImplementedError as e:
                return str(e)
            return None
        try:
            text, _ = counted(attempt, {}, f"{name} at hidden_dim {D}")
        except RuntimeError as e:   # a launch
            missed.append(f"{name}: {e}")
            continue
        ok = text is not None and f"Queue 3 (c), {item}" in text
        print(f"{name} at hidden_dim {D}: raises before any launch: {ok} ({text})")
        if not ok:
            missed.append(f"{name} at hidden_dim {D} did not raise naming Queue 3 (c), {item}")
    return missed


def run_xwide(torch, np, dev) -> dict:
    """Phase 16: (a) K3 and K5 at every width of XWIDE_D against their plain
    versions (check_wide_kernels' cases, K3 also at 2048 samples); (b) the
    render path at each width of XWIDE_PATH_D from a checkpoint of seeded
    weights (run_wide_render:
    cli.render over N_VIEWS views, Trainer.render_frame fused and with
    n_importance N_IMPORTANCE); (c) the backward kernels stopping there
    (check_xwide_backward_raises). Every part reports before the phase fails."""
    t_phase = time.perf_counter()
    out, missed = {}, []
    for what, fn in (("kernels", lambda: check_wide_kernels(torch, dev, XWIDE_D, SEED + 41,
                                                          "past 512", XWIDE_S)),
                     *((D, lambda D=D: run_wide_render(torch, np, dev, D))
                       for D in XWIDE_PATH_D)):
        try:
            out["worst" if what == "kernels" else what] = fn()
        except Exception as e:   # every part runs and reports; the phase fails below
            missed.append(f"{what}: {type(e).__name__}: {e}")
            print(f"phase 16 ({what}) failed: {type(e).__name__}: {e}")
    missed += check_xwide_backward_raises(torch, dev, XWIDE_PATH_D[0])
    print(f"xwide phase: {time.perf_counter() - t_phase:.1f} s wall")
    if missed:
        raise RuntimeError("phase 16: " + " | ".join(missed))
    return out


def timed_once(torch, fn):
    """(fn(), its ms by CUDA events): one run, for the plain versions."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_forward(torch, dev, p: dict, worst: dict, D: int, table, z, pts, dirs, pcfg,
                 pparams):
    """At width D from a render path's state p (run_wide_render): a 188x621
    frame end to end (render_trajectory), K3 over the frame's rays (table, z)
    and K5 at the points pts, dirs (weights pparams), each beside its
    bound and its plain version (timed once, its output held against the
    kernel's), and the hierarchical frame end to end. Returns (the `kernels`
    JSON entries of K3 and K5, their times by name)."""
    from nope_nerf_torch.evaluation.extract import render_trajectory
    from nope_nerf_torch.ops.fused_mlp import _mlp_fwd_cuda, point_mlp_fwd_plain
    from nope_nerf_torch.ops.fused_render import (pack_weights, render_rays_fused,
                                                  render_rays_fused_plain)
    h, w = RESOLUTION
    n_rays, fine_m = h * w, pts.shape[0]
    entries, summary = [], {}
    ncfg, rcfg, nerf = p["ncfg"], p["rcfg"], p["params"]["nerf"]
    frame_ms = time_ms(lambda: render_trajectory(nerf, p["traj"][:1], p["scene"].K,
                                                 RESOLUTION, ncfg, rcfg, device=dev), 2)
    fwd_ms = time_ms(lambda: render_rays_fused(nerf, table, z, ncfg, rcfg.dist_alpha,
                                               want_aux=False), 3)
    got = render_rays_fused(nerf, table, z, ncfg, rcfg.dist_alpha, want_aux=False)
    ref, plain_ms = timed_once(torch, lambda: render_rays_fused_plain(nerf, table, z, ncfg,
                                                                      rcfg.dist_alpha,
                                                                      want_aux=False))
    errs = [max_err(g, r) for g, r in zip(got[:2], ref[:2])]
    tols = [tolerance(r) for r in ref[:2]]
    if not all(e <= t for e, t in zip(errs, tols)):
        raise RuntimeError(f"render_fwd over the frame at hidden_dim {D} disagrees with its "
                           f"plain version: {errs} > {tols}")
    del got, ref
    flops = mlp_flops(D, n_rays, z.shape[1])
    nbytes = (table.numel() + z.numel() + 4 * n_rays) * 4 + numel_bytes(
        sum(pack_weights(nerf, ncfg), []))
    f_bound, f_by, _, _ = bound(flops, PEAK_BF16_FLOPS, nbytes)
    print(f"hidden_dim {D}: frame {h}x{w} {frame_ms:.2f} ms end to end "
          f"({n_rays / frame_ms * 1e3:.0f} rays/s), render_fwd {fwd_ms:.2f} ms "
          f"({flops / fwd_ms / 1e9:.1f} TFLOP/s, {fwd_ms / f_bound:.2f} x the bound "
          f"{f_bound:.2f} ms by {f_by}, {flops / 1e12:.2f} TFLOP), plain version "
          f"{plain_ms:.0f} ms; against it rgb {errs[0]:.3g}/{tols[0]:.3g}, dist "
          f"{errs[1]:.3g}/{tols[1]:.3g}")
    entries.append({"name": f"render_fwd (hidden_dim {D})", "route": "cuda",
                    "source": "nope_nerf_torch/csrc/render_fwd.cu",
                    "replaces": "nope_nerf_tpu/ops/pallas_render.py:368",
                    "launches": p["render_counts"]["render_fwd"],
                    "max_abs_err": max(worst[("render_fwd", D)], *errs),
                    "ms": fwd_ms, "plain_ms": plain_ms, "bound_ms": f_bound,
                    "bound_by": f_by, "library_ms": None})
    summary[f"frame_ms_{D}"] = frame_ms
    summary[f"render_fwd_ms_{D}"] = fwd_ms

    pf_ms = time_ms(lambda: _mlp_fwd_cuda(pparams, pts, dirs, pcfg), 10)
    got = _mlp_fwd_cuda(pparams, pts, dirs, pcfg)
    ref, pplain_ms = timed_once(torch, lambda: point_mlp_fwd_plain(pparams, pts, dirs, pcfg))
    perr = max(max_err(g, r) for g, r in zip(got, ref))
    if not all(max_err(g, r) <= tolerance(r) for g, r in zip(got, ref)):
        raise RuntimeError(f"point_mlp_fwd at {fine_m} points, hidden_dim {D}, disagrees "
                           "with its plain version")
    W, B = pack_weights(pparams, pcfg)
    p_flops = mlp_flops(D, 1, 1) * fine_m
    p_bound, p_by, _, _ = bound(p_flops, PEAK_BF16_FLOPS,
                                40 * fine_m + numel_bytes(W) + numel_bytes(B))
    print(f"hidden_dim {D}: point_mlp_fwd {fine_m} points {pf_ms:.3f} ms "
          f"({p_flops / pf_ms / 1e9:.1f} TFLOP/s, {pf_ms / p_bound:.2f} x the bound "
          f"{p_bound:.3f} ms by {p_by}, {p_flops / 1e12:.3f} TFLOP), plain version "
          f"{pplain_ms:.1f} ms; max err {perr:.3g}")
    entries.append({"name": f"point_mlp_fwd (hidden_dim {D})", "route": "cuda",
                    "source": "nope_nerf_torch/csrc/point_mlp_fwd.cu",
                    "replaces": "nope_nerf_tpu/ops/pallas_mlp.py:186",
                    "launches": p["hier_frame_counts"]["point_mlp_fwd"],
                    "max_abs_err": max(worst[("point_mlp_fwd", D)], perr),
                    "ms": pf_ms, "plain_ms": pplain_ms, "bound_ms": p_bound,
                    "bound_by": p_by, "library_ms": None})
    summary[f"point_mlp_fwd_ms_{D}"] = pf_ms
    del got, ref
    hier = p["hier_trainer"]
    summary[f"hier_frame_ms_{D}"] = time_ms(
        lambda: hier.render_frame(p["state"], p["batch"], RESOLUTION), 2)
    print(f"hidden_dim {D}: hierarchical render_frame {h}x{w} "
          f"{summary[f'hier_frame_ms_{D}']:.2f} ms end to end")
    return entries, summary


def time_xwide(torch, dev, xwide: dict, table, z, smi: str) -> list:
    """Phase 9's part for phase 16: time_forward at each width of
    XWIDE_PATH_D, K5 at the fine pass's 196,608 points. Prints an `xwide`
    JSON line; returns the `kernels` JSON entries."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    gen = torch.Generator().manual_seed(SEED + 43)
    pts, dirs = point_inputs(torch, dev, gen, TRAIN_RAYS * (128 + N_IMPORTANCE))
    entries, summary = [], {"card": smi}
    for D in sorted(XWIDE_PATH_D):
        pcfg = NerfConfig(hidden_dim=D, use_pallas=True)
        e, times = time_forward(torch, dev, xwide[D], xwide["worst"], D, table, z, pts, dirs,
                                pcfg, init_nerf_params(pcfg, gen, device=dev))
        entries += e
        summary.update(times)
        torch.cuda.empty_cache()
    print(json.dumps({"xwide": summary}))
    return entries


def time_wide(torch, dev, wide: dict, table, z, smi: str) -> list:
    """Phase 9's part for phase 13: per width, a 188x621 frame end to end
    (render_trajectory), K3 over the frame's rays at 128 samples and K5 at
    the fine pass's 196,608 points, each beside its bound and its plain
    version (timed once, its output held against the kernel's); the
    hierarchical frame end to end at WIDE_PATH_D; K4's frozen variant at the
    pose-opt batch's 1024 rays x 128 and K6's at the fine pass's 196,608
    points, each beside its bound (forward + dX, 2 mlp_flops) and its plain
    version; K6 full at those points beside its bound (forward + dX + dW, 3
    mlp_flops) and its plain version, with the dW kernel's share of its device
    time (torch.profiler), the dW kernel's CTAs and the operand bytes; K1
    and K4 full at the train step's 1024 rays x 128 the same way (K1 on its
    own loss, K4 full on a colour and depth loss's cotangents); the replayed
    pose-opt steps of phase 13 (fused and hierarchical) and its hierarchical,
    fused and invariant-depth train steps (eager, replayed, pool, peak device
    memory). Returns the `kernels` JSON entries."""
    from torch.profiler import ProfilerActivity, profile
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_mlp import (POINT_MLP_BWD, _mlp_bwd_cuda, dw_chunks,
                                               point_mlp_bwd_plain)
    from nope_nerf_torch.ops.fused_render import (RENDER_TRAIN, _render_bwd_cuda, _train_cuda,
                                                  _train_plain, pack_weights,
                                                  render_rays_fused_bwd_plain, unpack_grads)
    from nope_nerf_torch.tools.profile_train import _self_device_us

    h, w = RESOLUTION
    fine_m = TRAIN_RAYS * (128 + N_IMPORTANCE)
    gen = torch.Generator().manual_seed(SEED + 34)
    pts, dirs = point_inputs(torch, dev, gen, fine_m)
    bgen = torch.Generator().manual_seed(SEED + 37)   # the frozen backward's inputs
    kgen = torch.Generator().manual_seed(SEED + 40)   # K1's and K4 full's
    entries, summary = [], {"card": smi}
    for D in WIDE_D:
        p = wide[D]
        pcfg = NerfConfig(hidden_dim=D, use_pallas=True)
        pparams = init_nerf_params(pcfg, gen, device=dev)
        e, times = time_forward(torch, dev, p, wide["worst"], D, table, z, pts, dirs, pcfg,
                                pparams)
        entries += e
        summary.update(times)

        # K4's frozen variant at the pose-opt batch, on a colour and depth loss's cotangents
        rays, tz, tgt = train_inputs(torch, dev, bgen, TRAIN_RAYS)
        bcfg, bparams = many_params(torch, dev, bgen, D, "softplus", False, 128)
        cot = bwd_cotangents(torch, bparams, rays, tz, tgt, bcfg, False, False)
        fz_ms = time_ms(lambda: _render_bwd_cuda(bparams, rays, tz, *cot, bcfg, False,
                                                 want_param_grads=False), 10)
        got = _render_bwd_cuda(bparams, rays, tz, *cot, bcfg, False, want_param_grads=False)
        ref, fz_plain_ms = timed_once(torch, lambda: render_rays_fused_bwd_plain(
            bparams, rays, tz, *cot, bcfg, False))
        fz_err, fk, fshare, _ = held(dict(rays=got[2], z=got[3]), dict(rays=ref[2], z=ref[3]),
                                     ("rays", "z"))
        if not fshare <= 1.0:
            raise RuntimeError(f"render_bwd_frozen at {TRAIN_RAYS} x 128, hidden_dim {D}: {fk} at "
                               f"{fshare:.2f} of its tolerance")
        W, B = pack_weights(bparams, bcfg)
        fz_flops = 2 * mlp_flops(D, TRAIN_RAYS, 128)
        fz_io = (numel_bytes([rays, tz, cot[0], cot[1]]) + numel_bytes([rays, tz])
                 + numel_bytes(W) + numel_bytes(B))
        fz_bound, fz_by, _, _ = bound(fz_flops, PEAK_BF16_FLOPS, fz_io)
        print(f"hidden_dim {D}: render_bwd_frozen {TRAIN_RAYS} rays x 128 {fz_ms:.3f} ms "
              f"({fz_flops / fz_ms / 1e9:.1f} TFLOP/s, {fz_ms / fz_bound:.2f} x the bound "
              f"{fz_bound:.3f} ms by {fz_by}, {fz_flops / 1e12:.3f} TFLOP), plain version "
              f"{fz_plain_ms:.1f} ms; against it {fk} at {fshare:.3f} of its tolerance")
        entries.append({"name": f"render_bwd_frozen (hidden_dim {D})", "route": "cuda",
                        "source": "nope_nerf_torch/csrc/render_bwd_frozen.cu",
                        "replaces": "nope_nerf_tpu/ops/pallas_render.py:535",
                        "launches": p["eval_counts"]["render_bwd_frozen"],
                        "max_abs_err": max(wide["worst"][("render_bwd_frozen", D)], fz_err),
                        "ms": fz_ms, "plain_ms": fz_plain_ms, "bound_ms": fz_bound,
                        "bound_by": fz_by, "library_ms": None})
        summary[f"render_bwd_frozen_ms_{D}"] = fz_ms
        del got, ref

        # K6's frozen variant at the fine pass's points, on a smooth loss's cotangents
        g_rgb, g_den = point_cotangents(torch, pparams, pts, dirs, pcfg)
        pz_ms = time_ms(lambda: _mlp_bwd_cuda(pparams, pts, dirs, g_rgb, g_den, pcfg,
                                              want_param_grads=False), 10)
        got = _mlp_bwd_cuda(pparams, pts, dirs, g_rgb, g_den, pcfg, want_param_grads=False)
        ref, pz_plain_ms = timed_once(torch, lambda: point_mlp_bwd_plain(
            pparams, pts, dirs, g_rgb, g_den, pcfg, want_param_grads=False))
        pz_err, pk, pshare, _ = held(dict(points=got[2], directions=got[3]),
                                     dict(points=ref[2], directions=ref[3]),
                                     ("points", "directions"))
        if not pshare <= 1.0:
            raise RuntimeError(f"point_mlp_bwd_frozen at {fine_m} points, hidden_dim {D}: {pk} at "
                               f"{pshare:.2f} of its tolerance")
        pz_flops = 2 * mlp_flops(D, 1, 1) * fine_m
        pz_bound, pz_by, _, _ = bound(pz_flops, PEAK_BF16_FLOPS,
                                      64 * fine_m + numel_bytes(W) + numel_bytes(B))
        print(f"hidden_dim {D}: point_mlp_bwd_frozen {fine_m} points {pz_ms:.3f} ms "
              f"({pz_flops / pz_ms / 1e9:.1f} TFLOP/s, {pz_ms / pz_bound:.2f} x the bound "
              f"{pz_bound:.3f} ms by {pz_by}, {pz_flops / 1e12:.3f} TFLOP), plain version "
              f"{pz_plain_ms:.1f} ms; against it {pk} at {pshare:.3f} of its tolerance")
        entries.append({"name": f"point_mlp_bwd_frozen (hidden_dim {D})", "route": "cuda",
                        "source": "nope_nerf_torch/csrc/point_mlp_bwd_frozen.cu",
                        "replaces": "nope_nerf_tpu/ops/pallas_mlp.py:273",
                        "launches": p["hier_pose_counts"]["point_mlp_bwd_frozen"],
                        "max_abs_err": max(wide["worst"][("point_mlp_bwd_frozen", D)], pz_err),
                        "ms": pz_ms, "plain_ms": pz_plain_ms, "bound_ms": pz_bound,
                        "bound_by": pz_by, "library_ms": None})
        summary[f"point_mlp_bwd_frozen_ms_{D}"] = pz_ms
        del got, ref

        # K6 full at the fine pass's points on the same cotangents: its chain, the in-order
        # sum of the chain's partials and the dW kernel (column pieces) in one call
        pk_ms = time_ms(lambda: _mlp_bwd_cuda(pparams, pts, dirs, g_rgb, g_den, pcfg), 10)
        got = _mlp_bwd_cuda(pparams, pts, dirs, g_rgb, g_den, pcfg)
        ref, pk_plain_ms = timed_once(torch, lambda: point_mlp_bwd_plain(
            pparams, pts, dirs, g_rgb, g_den, pcfg))
        pk_err, pkk, pkshare, _ = held(
            dict(unpack_grads(got[0], got[1], pcfg), points=got[2], directions=got[3]),
            dict(unpack_grads(ref[0], ref[1], pcfg), points=ref[2], directions=ref[3]),
            ("points", "directions"))
        if not pkshare <= 1.0:
            raise RuntimeError(f"point_mlp_bwd at {fine_m} points, hidden_dim {D}: {pkk} at "
                               f"{pkshare:.2f} of its tolerance")
        W, B = pack_weights(pparams, pcfg)
        pk_flops = 3 * mlp_flops(D, 1, 1) * fine_m
        pk_bound, pk_by, _, _ = bound(pk_flops, PEAK_BF16_FLOPS,
                                      64 * fine_m + numel_bytes(W) + numel_bytes(B)
                                      + numel_bytes(got[0] + got[1]))
        del got, ref
        sizes = (ctypes.c_longlong * 6)()
        POINT_MLP_BWD.lib().nerf_point_mlp_bwd_scratch(D, fine_m, 1, sizes)
        operand_bytes = sizes[0] + sizes[1]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        dw_ctas = sizes[4] * dw_chunks(sizes[4], fine_m, sms)
        # where K6 full's device time goes: the chain, the partials' sum, the dW kernel
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                _mlp_bwd_cuda(pparams, pts, dirs, g_rgb, g_den, pcfg)
            torch.cuda.synchronize()
        kt = {e.key: _self_device_us(e) / 3e3 for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
        dw_ms = sum(v for k, v in kt.items() if "dw_sm90_kernel" in k or "dw_reduce_kernel" in k)
        chain_ms = sum(v for k, v in kt.items() if "point_mlp_bwd_wide_kernel" in k)
        dw_text = (f"dW kernel {dw_ms:.3f} ms ({dw_ms / pk_ms:.1%} of the call; {sizes[4]} CTA "
                   f"tiles x {dw_ctas // sizes[4]} chunks = {dw_ctas} CTAs on {sms} SMs), chain "
                   f"{chain_ms:.3f} ms (torch.profiler)" if kt else
                   "dW kernel's share not measured (torch.profiler saw no device time)")
        print(f"hidden_dim {D}: point_mlp_bwd {fine_m} points {pk_ms:.3f} ms "
              f"({pk_flops / pk_ms / 1e9:.1f} TFLOP/s, {pk_ms / pk_bound:.2f} x the bound "
              f"{pk_bound:.3f} ms by {pk_by}, {pk_flops / 1e12:.3f} TFLOP), plain version "
              f"{pk_plain_ms:.1f} ms; against it {pkk} at {pkshare:.3f} of its tolerance; "
              f"{dw_text}; operands the chain hands the dW kernel {operand_bytes / 1e9:.3f} GB "
              f"({operand_bytes / fine_m:.0f} B a point, outside the bound)")
        entries.append({"name": f"point_mlp_bwd (hidden_dim {D})", "route": "cuda",
                        "source": "nope_nerf_torch/csrc/point_mlp_bwd.cu",
                        "replaces": "nope_nerf_tpu/ops/pallas_mlp.py:273",
                        "launches": p["train_counts"]["point_mlp_bwd"],
                        "max_abs_err": max(wide["worst_full"][D], pk_err),
                        "ms": pk_ms, "plain_ms": pk_plain_ms, "bound_ms": pk_bound,
                        "bound_by": pk_by, "library_ms": None})
        summary[f"point_mlp_bwd_{D}"] = {
            "ms": pk_ms, "bound_ms": pk_bound, "dw_ms": dw_ms if kt else None,
            "chain_ms": chain_ms if kt else None, "dw_ctas": dw_ctas,
            "operand_bytes": operand_bytes}
        # K1 and K4 full at the train step's 1024 rays x 128 (render_full_sm90.cuh's wide
        # kernel, the in-order sum of its partials and the dW kernel's column pieces in one
        # call): K1 on its own loss, K4 full on a colour and depth loss's cotangents
        rays, tz, tgt = train_inputs(torch, dev, kgen, TRAIN_RAYS)
        kcfg, kparams = many_params(torch, dev, kgen, D, "softplus", False, 128)
        kcot = bwd_cotangents(torch, kparams, rays, tz, tgt, kcfg, False, False)
        W, B = pack_weights(kparams, kcfg)
        r_flops = train_flops(D, TRAIN_RAYS, 128)
        r_grad_bytes = 4 * sum(v.numel() for v in kparams.values())
        sizes = (ctypes.c_longlong * 7)()
        RENDER_TRAIN.lib().nerf_render_train_scratch(D, TRAIN_RAYS, 128, sms, sizes)
        r_operand_bytes = sizes[0] + sizes[1]
        r_dw_ctas = sizes[4] * dw_chunks(sizes[4], TRAIN_RAYS * 128, sms)
        for kname, call, plain, io, launches in (
                ("render_train",
                 lambda: _train_cuda(kparams, rays, tz, tgt, kcfg, False, 1, False),
                 lambda: _train_plain(kparams, rays, tz, tgt, kcfg, False, 1, False),
                 2 * numel_bytes([rays, tz, tgt]), p["fused_train_counts"]["render_train"]),
                ("render_bwd", lambda: _render_bwd_cuda(kparams, rays, tz, *kcot, kcfg, False),
                 lambda: render_rays_fused_bwd_plain(kparams, rays, tz, *kcot, kcfg, False),
                 numel_bytes([rays, tz, kcot[0], kcot[1]]) + numel_bytes([rays, tz]),
                 round(p["graph_invariant"]["launches_per_step"]["render_bwd"]
                       * p["graph_invariant"]["steps"]))):
            k_ms = time_ms(call, 10)
            got = call()
            ref, k_plain_ms = timed_once(torch, plain)
            at = 1 if kname == "render_train" else 0   # where dWs sit in the result
            k_err, kk, kshare, _ = held(unpack_grads(got[at], got[at + 1], kcfg),
                                        unpack_grads(ref[at], ref[at + 1], kcfg), ())
            if kname == "render_train":
                rel = float(((got[0] - ref[0]).abs() / ref[0].abs().clamp_min(1e-12)).max())
                if not rel <= 2e-3:
                    raise RuntimeError(f"render_train at {TRAIN_RAYS} x 128, hidden_dim {D}: "
                                       f"loss sums at {rel:.3g} relative")
            if not kshare <= 1.0:
                raise RuntimeError(f"{kname} at {TRAIN_RAYS} x 128, hidden_dim {D}: {kk} at "
                                   f"{kshare:.2f} of its tolerance")
            del got, ref
            k_bound, k_by, _, _ = bound(r_flops, PEAK_BF16_FLOPS,
                                        io + numel_bytes(W) + numel_bytes(B) + r_grad_bytes)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
            kt = {e.key: _self_device_us(e) / 3e3 for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
            k_dw_ms = sum(v for k, v in kt.items()
                          if "dw_sm90_kernel" in k or "dw_reduce_kernel" in k)
            k_chain_ms = sum(v for k, v in kt.items() if "render_full_wide_kernel" in k)
            dw_text = (f"dW kernel {k_dw_ms:.3f} ms ({k_dw_ms / k_ms:.1%} of the call; "
                       f"{sizes[4]} CTA tiles x {r_dw_ctas // sizes[4]} chunks = {r_dw_ctas} "
                       f"CTAs on {sms} SMs), chain {k_chain_ms:.3f} ms (torch.profiler)" if kt
                       else "dW kernel's share not measured (torch.profiler saw no device time)")
            print(f"hidden_dim {D}: {kname} {TRAIN_RAYS} rays x 128 {k_ms:.3f} ms "
                  f"({r_flops / k_ms / 1e9:.1f} TFLOP/s, {k_ms / k_bound:.2f} x the bound "
                  f"{k_bound:.3f} ms by {k_by}, {r_flops / 1e12:.3f} TFLOP), plain version "
                  f"{k_plain_ms:.1f} ms; against it {kk} at {kshare:.3f} of its tolerance; "
                  f"{dw_text}; operands the chain hands the dW kernel "
                  f"{r_operand_bytes / 1e9:.3f} GB ({r_operand_bytes / (TRAIN_RAYS * 128):.0f} "
                  f"B a sample, outside the bound); launches on the main path {launches}")
            entries.append({"name": f"{kname} (hidden_dim {D})", "route": "cuda",
                            "source": f"nope_nerf_torch/csrc/{kname}.cu",
                            "replaces": "nope_nerf_tpu/ops/pallas_render.py:"
                                        + ("605" if kname == "render_train" else "535"),
                            "launches": launches,
                            "max_abs_err": max(wide["worst"][(kname, D)], k_err),
                            "ms": k_ms, "plain_ms": k_plain_ms, "bound_ms": k_bound,
                            "bound_by": k_by, "library_ms": None})
            summary[f"{kname}_{D}"] = {
                "ms": k_ms, "bound_ms": k_bound, "dw_ms": k_dw_ms if kt else None,
                "chain_ms": k_chain_ms if kt else None, "dw_ctas": r_dw_ctas,
                "operand_bytes": r_operand_bytes}
        g = p["graph"]
        summary[f"hier_step_ms_{D}"] = {"eager": g["eager_ms"], "replay": g["replay_ms"],
                                        "peak_gb": g["peak_gb"], "pool_mb": g["pool_mb"]}
        for path in ("fused", "invariant"):
            g = p[f"graph_{path}"]
            summary[f"{path}_step_ms_{D}"] = {"eager": g["eager_ms"], "replay": g["replay_ms"],
                                              "peak_gb": g["peak_gb"], "pool_mb": g["pool_mb"]}
            print(f"hidden_dim {D}: {path} train step, {TRAIN_RAYS} rays on {h}x{w} frames, "
                  f"replayed {g['replay_ms']:.3f} ms, eager {g['eager_ms']:.3f} ms a step; pool "
                  f"{g['pool_mb']:.0f} MB, peak device memory of the eager steps "
                  f"{g['peak_gb']:.2f} GB")
        for path in ("fused", "hier"):
            g = p[f"graph_{path}"]
            summary[f"pose_opt_{path}_ms_{D}"] = {"eager": g["eager_ms"], "replay": g["replay_ms"]}
    print(json.dumps({"wide": summary}))
    return entries


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
    from nope_nerf_torch.ops.chamfer import (CHAMFER_BIDIR, CHAMFER_NEAREST, _bidir_buffers,
                                             _bidir_launch, _nearest_buffers, _nearest_launch,
                                             nearest_idx, nearest_idx_bidirectional,
                                             nearest_idx_bidirectional_plain, nearest_idx_plain)
    from nope_nerf_torch.tools.chamfer_profile import sweep_instructions_per_pair
    from nope_nerf_torch.ops.fused_mlp import (DW_SM90, POINT_MLP_BWD, POINT_MLP_BWD_FROZEN,
                                               POINT_MLP_FWD, _mlp_bwd_cuda, _mlp_fwd_cuda,
                                               dw_chunks, dw_cta_tiles, dw_plain, dw_sm90,
                                               point_dw_table, point_mlp_bwd_plain,
                                               point_mlp_fwd_plain, render_dw_table)
    from nope_nerf_torch.ops.fused_render import (
        RENDER_BWD, RENDER_BWD_FROZEN, RENDER_FWD, RENDER_TRAIN, _render_bwd_cuda, _train_cuda,
        pack_weights, render_chunks, render_operand_bytes, render_ray_loss_fused,
        render_ray_loss_fused_plain, render_rays_fused, render_rays_fused_bwd_plain,
        render_rays_fused_plain, unpack_grads)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)

    # ---- 1. build -----------------------------------------------------------
    libraries = (RENDER_FWD, RENDER_TRAIN, RENDER_BWD, RENDER_BWD_FROZEN, CHAMFER_BIDIR,
                 POINT_MLP_FWD, POINT_MLP_BWD, POINT_MLP_BWD_FROZEN, CHAMFER_NEAREST, DW_SM90)
    t0 = time.perf_counter()
    build_all(libraries)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          + ", ".join(lib.source.name for lib in libraries) + " (side by side)")
    for lib in libraries:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "serialized" in line:
                print(f"  ptxas {lib.source.name}:", line.strip())

    if sys.argv[1:2] == ["--step-graphs"]:
        # phase 11 alone, for work on the graphs (the full run takes every phase)
        SURVEY.append("on")
        with tempfile.TemporaryDirectory() as disk_root:
            write_disk_scenes(np, disk_root)
            run_step_graphs(torch, np, dev, disk_root, smi)
        return 0
    if sys.argv[1:2] == ["--many-samples"]:
        # phase 12 alone, for work on the sample counts (the full run takes every phase)
        run_many_samples(torch, np, dev)
        return 0
    if sys.argv[1:2] == ["--wide"]:
        # phase 13 alone, for work on the wide trunk (the full run takes every phase)
        run_wide(torch, np, dev)
        return 0
    if sys.argv[1:2] == ["--narrow"]:
        # phase 14 alone, for work on the 128-point chain (the full run takes every phase)
        run_narrow(torch, dev)
        return 0
    if sys.argv[1:2] == ["--forward"]:
        # phase 15 alone, for work on the one forward (the full run takes every phase)
        run_one_forward(torch, dev)
        return 0
    if sys.argv[1:2] == ["--xwide"]:
        # phase 16 alone, for work on the trunk past 512 (the full run takes every phase)
        run_xwide(torch, np, dev)
        return 0

    # ---- 2. each kernel against its plain version ---------------------------
    gen = torch.Generator().manual_seed(SEED)
    fwd_err = check_render_fwd(torch, dev, gen)
    train_err, train_share = check_render_train(torch, dev, gen)
    print(f"render_train: worst gradient error over the 16 cases at {train_share:.3f} of its "
          f"tolerance (grad_share)")
    bwd_err, bwd_frozen_err, bwd_share = check_render_bwd(torch, dev, gen)
    print(f"render_bwd: worst gradient error over the 16 cases at {bwd_share:.3f} of its "
          f"tolerance (grad_share)")
    chamfer_gap = check_chamfer(torch, dev, gen)
    pfwd_err = check_point_mlp_fwd(torch, dev, gen)
    pbwd_err, pbwd_share, pbwd_frozen_err = check_point_mlp_bwd(torch, dev, gen)
    print(f"point_mlp_bwd: worst gradient error over the 4 cases at {pbwd_share:.3f} of its "
          f"tolerance (grad_share)")
    # its own generator: the phases after it draw the inputs they drew before it existed
    dw_err = check_dw(torch, dev, torch.Generator().manual_seed(SEED + 11))
    nearest_err = check_chamfer_nearest(torch, dev, gen)

    # ---- 3. the render path: novel views through the render CLI --------------
    fwd_launches, params, traj, scene, ncfg, rcfg, view0_inputs = run_render_path(
        torch, np, dev, gen)

    # ---- 4. the train path: Trainer.run_steps --------------------------------
    counts, step_ms, trainer, state, tscene, order, refs, mc = run_train_path(torch, np, dev)

    # ---- 5. the train CLI, the eval path, the unfused train steps ------------
    eval_counts, (enerf, eimg, ecam, epcfg, eray_idx, eval_scene, emc) = run_cli_path(
        torch, np, dev)
    unfused_counts, utrainer, ustate, uscene, uorder, urefs = run_unfused_steps(torch, np, dev)

    # ---- 6. hierarchical sampling through K5 / K6, and the rest of the slice --
    hier_counts, htrainer, hstate, hscene, horder, hrefs, hmc = run_hier_train_path(torch, np, dev)
    hframe_counts, hpose_counts, hpose_args = run_hier_eval(
        torch, np, dev, htrainer, hstate, hscene,
        (enerf, eimg, ecam, epcfg, eray_idx, eval_scene, emc))
    gtrainer, gstate, gbatch = run_slice_rest(torch, np, dev)

    with tempfile.TemporaryDirectory() as disk_root:
        # ---- 7. scenes on disk: the fern, Ballroom and straight_d4 configurations
        disk_counts, dtrainer, dstate, dscene = run_disk_scenes(torch, np, dev, disk_root)

        # ---- 8. scene preparation and the perceptual metric on phase 7's straight scene
        prep = run_scene_preparation(torch, np, dev, disk_root)

        # ---- 10. the multi-device layer, while phase 7's straight scene is on disk
        run_parallel_phase(torch, np, disk_root, smi)

        # ---- 11. the captured step graphs, fern read from phase 7's scene on disk
        run_step_graphs(torch, np, dev, disk_root, smi)

    # ---- 12. every sample count: the kernels at 256 to 4096 samples, the path at 512
    many = run_many_samples(torch, np, dev)

    # ---- 13. hidden_dim 384 and 512: every kernel of the MLP; render, eval, train
    wide = run_wide(torch, np, dev)

    # ---- 14. hidden_dim 128 and 256: the backward kernels on phase 13's holds
    run_narrow(torch, dev)

    # ---- 15. one forward: K3's and K5's operands against the backward kernels'
    run_one_forward(torch, dev)

    # ---- 16. hidden_dim 640 to 1024: K3 and K5 on the trunk past 512; the render path
    xwide = run_xwide(torch, np, dev)

    # ---- 9. timing at the main paths' shapes ---------------------------------
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
          f"({fwd_flops / fwd_ms / 1e9:.1f} TFLOP/s achieved, "
          f"{fwd_flops / fwd_ms * 1e3 / PEAK_BF16_FLOPS:.1%} of the bf16 peak, "
          f"{fwd_ms / fwd_bound:.2f} x the bound)")

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
    # The bounds count what each function must move: every input read once (the weights
    # once, as bf16), every output written once. The operands K1 and K4 full hand their dW
    # kernel are their own choice, not the function's, and stay out of the bound; they are
    # printed beside it.
    W, B = pack_weights(tparams, tcfg)
    weight_bytes = numel_bytes(W) + numel_bytes(B)
    grad_bytes = 4 * sum(v.numel() for v in tparams.values())
    operand_bytes = sum(render_operand_bytes(tcfg.hidden_dim, TRAIN_RAYS, S))
    operand_ms = 2 * operand_bytes / PEAK_BYTES * 1e3
    io_bytes = 2 * numel_bytes([rays, tz, tgt]) + weight_bytes + grad_bytes
    t_flops = train_flops(tcfg.hidden_dim, TRAIN_RAYS, S)
    t_bound, t_by, t_ops_ms, t_bytes_ms = bound(t_flops, PEAK_BF16_FLOPS, io_bytes)
    print(f"render_train {TRAIN_RAYS} rays x {S}: {train_ms:.3f} ms, plain version "
          f"{train_plain_ms:.1f} ms; {t_flops / 1e12:.3f} TFLOP ({t_ops_ms:.3f} ms), "
          f"{io_bytes / 1e6:.1f} MB of rays, targets, weights and gradients "
          f"({t_bytes_ms:.4f} ms) -> bound {t_bound:.3f} ms by {t_by} "
          f"({t_flops / train_ms / 1e9:.1f} TFLOP/s achieved, {train_ms / t_bound:.2f} x the "
          f"bound); outside the bound, the operands the chain writes for the dW kernel and it "
          f"reads back: {operand_bytes / 1e9:.3f} GB ({operand_bytes / (TRAIN_RAYS * S):.0f} B a "
          f"sample), {operand_ms:.3f} ms at the memory rate")

    # K4 at the pose-opt and train batch: 1024 rays x 128, both variants, on the
    # cotangents of a colour and depth loss (what pose optimisation sends)
    cot = bwd_cotangents(torch, tparams, rays, tz, tgt, tcfg, False, False)
    bwd_ms = time_ms(lambda: _render_bwd_cuda(tparams, rays, tz, *cot, tcfg, False), 10)
    bwd_frozen_ms = time_ms(lambda: _render_bwd_cuda(tparams, rays, tz, *cot, tcfg, False,
                                                     want_param_grads=False), 10)
    bwd_plain_ms = time_ms(lambda: render_rays_fused_bwd_plain(tparams, rays, tz, *cot, tcfg,
                                                               False), 2)
    # the frozen-network variant: rays, z, cotangents and weights in, d(rays) and dz out;
    # forward + dX = two thirds of the products. The full variant adds the dW/dB outputs.
    f_io = numel_bytes([rays, tz, cot[0], cot[1]]) + numel_bytes([rays, tz]) + weight_bytes
    f_flops = 2 * t_flops / 3
    f_bound, f_by, f_ops_ms, f_bytes_ms = bound(f_flops, PEAK_BF16_FLOPS, f_io)
    b_io = f_io + grad_bytes
    b_bound, b_by, b_ops_ms, b_bytes_ms = bound(t_flops, PEAK_BF16_FLOPS, b_io)
    print(f"render_bwd {TRAIN_RAYS} rays x {S}, full variant: {bwd_ms:.3f} ms, plain version "
          f"{bwd_plain_ms:.1f} ms; {t_flops / 1e12:.3f} TFLOP ({b_ops_ms:.3f} ms), "
          f"{b_io / 1e6:.1f} MB of rays, cotangents, weights and gradients ({b_bytes_ms:.4f} "
          f"ms) -> bound {b_bound:.3f} ms by {b_by} ({t_flops / bwd_ms / 1e9:.1f} TFLOP/s "
          f"achieved, {bwd_ms / b_bound:.1f} x the bound); frozen-network variant (forward + "
          f"dX, no dW/dB): {bwd_frozen_ms:.3f} ms ({bwd_ms / bwd_frozen_ms:.2f} x faster than the "
          f"full variant); {f_flops / 1e12:.3f} TFLOP ({f_ops_ms:.3f} "
          f"ms), {f_io / 1e6:.1f} MB ({f_bytes_ms:.4f} ms) -> bound {f_bound:.3f} ms by {f_by} "
          f"({f_flops / bwd_frozen_ms / 1e9:.1f} TFLOP/s achieved, "
          f"{f_flops / bwd_frozen_ms * 1e3 / PEAK_BF16_FLOPS:.1%} of the bf16 peak, "
          f"{bwd_frozen_ms / f_bound:.2f} x the bound); outside the full variant's bound, its "
          f"dW operands: {operand_ms:.3f} ms at the memory rate (the frozen variant has none)")

    # the dW kernel on its own over K1's and K4 full's 11 blocks at their 1024 x 128
    # samples, against dw_plain and one torch.matmul per block (bf16 in, bf16 out)
    m_r = TRAIN_RAYS * S
    r_shapes = [(K, N) for *_, K, N in render_dw_table(tcfg.hidden_dim)]
    rxs, rgs, rxt, rgt = dw_operands(torch, dev, torch.Generator().manual_seed(SEED + 13),
                                     r_shapes, m_r, poison=False)
    rKs = [K for K, _ in r_shapes]
    rchunks = dw_chunks(dw_cta_tiles(rKs), m_r,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    rdw_ms = time_ms(lambda: dw_sm90(rxt, rgt, rKs, m_r, rchunks), 10)
    rdw_plain_ms = time_ms(lambda: [dw_plain(x, g, rchunks) for x, g in zip(rxs, rgs)], 2)
    rdw_lib_ms = time_ms(lambda: [torch.matmul(x.t(), g) for x, g in zip(rxs, rgs)], 10)
    rdw_flops = 2 * m_r * sum(K * N for K, N in r_shapes)
    rdw_in_bytes = 2 * m_r * sum(K + N for K, N in r_shapes)
    rdw_bound, rdw_by, rdw_ops_ms, rdw_bytes_ms = bound(
        rdw_flops, PEAK_BF16_FLOPS, rdw_in_bytes + 4 * sum(K * N for K, N in r_shapes))
    del rxs, rgs, rxt, rgt
    print(f"dw_sm90 (K1's and K4 full's 11 dW blocks on their own): {m_r} samples, {rchunks} "
          f"chunks, {rdw_ms:.3f} ms ({rdw_ms / train_ms:.1%} of render_train's time, "
          f"{rdw_ms / bwd_ms:.1%} of render_bwd's), plain version {rdw_plain_ms:.2f} ms, "
          f"torch.matmul per block (bf16 out) {rdw_lib_ms:.3f} ms; {rdw_flops / 1e12:.3f} TFLOP "
          f"({rdw_ops_ms:.3f} ms), {rdw_in_bytes / 1e9:.3f} GB of operands ({rdw_bytes_ms:.3f} "
          f"ms) -> bound {rdw_bound:.3f} ms by {rdw_by} ({rdw_ms / rdw_bound:.2f} x the bound)")

    # one pose-opt step, one unfused train step and one eval frame, end to end
    from nope_nerf_torch.data import batch_for_frame, epoch_order
    from nope_nerf_torch.evaluation.pose_opt import PoseOptRun, pose_opt_step
    from nope_nerf_torch.models.poses import init_pose_params
    from nope_nerf_torch.training.state import init_adam
    pose = init_pose_params(epcfg, torch.as_tensor(eval_scene.c2ws_gt), device=dev)
    adam = init_adam(pose)
    pose_ms = time_ms(lambda: pose_opt_step(pose, adam, enerf, None, eimg, 0, ecam, eray_idx, 1e-3,
                                            epcfg, None, emc.nerf, emc.render), 20)
    # the same step as cli.eval runs it: replayed from its captured graph
    prun = PoseOptRun(enerf, None, eval_scene, emc.nerf, emc.render,
                      init_c2ws=eval_scene.c2ws_gt, n_points=TRAIN_RAYS, seed=SEED, device=dev)
    prun.rate.fill_(1e-3)
    pose_replay_ms = time_ms(prun.step, 20)

    def unfused_steps():
        utrainer.run_steps(ustate, uscene, uorder, urefs, epoch=0, scheduling_start=10000)
    unfused_ms = time_ms(unfused_steps, 2) / UNFUSED_STEPS
    fbatch = batch_for_frame(tscene, 0, ref_idx=1)
    eval_frame_ms = time_ms(lambda: trainer.render_frame(state, fbatch, RESOLUTION), N_VIEWS)
    print(f"pose-opt step, {TRAIN_RAYS} rays of a 120x160 frame: {pose_ms:.2f} ms end to end "
          f"eagerly, {pose_replay_ms:.2f} ms replayed from its captured graph as cli.eval runs "
          f"it (render_fwd + render_bwd's frozen-network variant + Adam on the pose); unfused "
          f"train step (depth_loss_type invariant) {unfused_ms:.2f} ms end to end beside the "
          f"fused step's {steps_ms:.2f} ms; Trainer.render_frame {h}x{w} {eval_frame_ms:.2f} ms "
          f"end to end")

    cx, cy = depth_lifted_clouds(torch, dev, gen, h // mc.pc_ratio, w // mc.pc_ratio)
    # the wrapper (its two device launches and the allocations), and the bare C call
    # on buffers allocated once
    chamfer_ms = time_ms(lambda: nearest_idx_bidirectional(cx, cy), 20)
    kx, ky = cx.contiguous(), cy.contiguous()
    c_bufs = _bidir_buffers(kx, ky)
    chamfer_kernel_ms = time_ms(lambda: _bidir_launch(kx, ky, *c_bufs), 20)
    chamfer_plain_ms = time_ms(lambda: nearest_idx_bidirectional_plain(cx, cy), 3)

    def library_sweep():
        d = torch.cdist(cx, cy)
        return d.min(dim=1), d.min(dim=0)
    chamfer_lib_ms = time_ms(library_sweep, 10)
    pairs = cx.shape[0] * cy.shape[0]
    c_flops = 8 * pairs            # 3 FMAs and 2 adds per pair, in f32 outside the tensor cores
    c_bytes = 20 * (cx.shape[0] + cy.shape[0])   # 12 bytes in, one int64 index out, per point
    c_bound, c_by, _, _ = bound(c_flops, PEAK_F32_FLOPS, c_bytes)
    c_sass = sweep_instructions_per_pair(CHAMFER_BIDIR, "chamfer_bidir")
    print(f"chamfer_bidir {cx.shape[0]} x {cy.shape[0]}: wrapper {chamfer_ms * 1e3:.1f} us, kernel "
          f"alone (the bare C call: sweep and finishing launch) {chamfer_kernel_ms * 1e3:.1f} us, "
          f"plain version {chamfer_plain_ms:.2f} ms, torch.cdist + two mins {chamfer_lib_ms:.3f} "
          f"ms; {pairs / 1e6:.1f} M pairs -> FLOP bound {c_bound * 1e3:.1f} us by {c_by}; "
          + issue_floor_text(c_sass, pairs, chamfer_kernel_ms))
    rest_ms = steps_ms - train_ms - chamfer_ms
    print(f"train step {h}x{w}, {TRAIN_RAYS} rays: {steps_ms:.2f} ms end to end by CUDA events "
          f"({TRAIN_RAYS / steps_ms * 1e3:.0f} rays/s; {step_ms:.2f} ms by the host clock in the "
          f"counted run), render_train {train_ms / steps_ms:.1%}, chamfer_bidir "
          f"{chamfer_ms / steps_ms:.1%}, the rest (plain torch ops, autograd, Adam, host) "
          f"{rest_ms:.2f} ms = {rest_ms / steps_ms:.1%}")

    # K5 at the coarse and fine passes' point counts, K6 at the fine pass's; the hierarchical
    # train step, frame and pose-opt step end to end; the phong view
    gen = torch.Generator().manual_seed(SEED + 5)
    pcfg = NerfConfig(hidden_dim=256, use_pallas=True)
    pparams = init_nerf_params(pcfg, gen, device=dev)
    coarse_m, fine_m = TRAIN_RAYS * mc.render.num_points, TRAIN_RAYS * (
        mc.render.num_points + N_IMPORTANCE)
    cpts, cdirs = point_inputs(torch, dev, gen, coarse_m)
    fpts, fdirs = point_inputs(torch, dev, gen, fine_m)
    g_rgb, g_den = point_cotangents(torch, pparams, fpts, fdirs, pcfg)
    pfwd_coarse_ms = time_ms(lambda: _mlp_fwd_cuda(pparams, cpts, cdirs, pcfg), 10)
    pfwd_ms = time_ms(lambda: _mlp_fwd_cuda(pparams, fpts, fdirs, pcfg), 10)
    pfwd_plain_ms = time_ms(lambda: point_mlp_fwd_plain(pparams, fpts, fdirs, pcfg), 2)
    pbwd_ms = time_ms(lambda: _mlp_bwd_cuda(pparams, fpts, fdirs, g_rgb, g_den, pcfg), 10)
    pbwd_plain_ms = time_ms(lambda: point_mlp_bwd_plain(pparams, fpts, fdirs, g_rgb, g_den,
                                                        pcfg), 2)
    pbwd_frozen_ms = time_ms(lambda: _mlp_bwd_cuda(pparams, fpts, fdirs, g_rgb, g_den, pcfg,
                                                   want_param_grads=False), 10)
    pbwd_frozen_plain_ms = time_ms(lambda: point_mlp_bwd_plain(
        pparams, fpts, fdirs, g_rgb, g_den, pcfg, want_param_grads=False), 2)
    W, B = pack_weights(pparams, pcfg)
    pweight_bytes = numel_bytes(W) + numel_bytes(B)
    pgrad_bytes = 4 * sum(v.numel() for v in pparams.values())
    # each point has its own direction: the MLP of one-sample rays, 1,186,816 FLOP a point
    p_flops = mlp_flops(pcfg.hidden_dim, 1, 1)
    pf_bound, pf_by, pf_ops_ms, pf_bytes_ms = bound(p_flops * fine_m, PEAK_BF16_FLOPS,
                                                    40 * fine_m + pweight_bytes)
    pc_bound, _, _, _ = bound(p_flops * coarse_m, PEAK_BF16_FLOPS, 40 * coarse_m + pweight_bytes)
    pb_bound, pb_by, pb_ops_ms, pb_bytes_ms = bound(3 * p_flops * fine_m, PEAK_BF16_FLOPS,
                                                    64 * fine_m + pweight_bytes + pgrad_bytes)
    # the frozen-network variant: forward + dX, points, directions and cotangents in,
    # d(points) and d(directions) out, the weights once
    pz_flops = 2 * p_flops * fine_m
    pz_bound, pz_by, pz_ops_ms, pz_bytes_ms = bound(pz_flops, PEAK_BF16_FLOPS,
                                                    64 * fine_m + pweight_bytes)
    # the operands K6 full writes for its dW kernel and reads back: outside the bound
    psizes = (ctypes.c_longlong * 6)()
    POINT_MLP_BWD.lib().nerf_point_mlp_bwd_scratch(pcfg.hidden_dim, fine_m, 1, psizes)
    poperand_bytes = psizes[0] + psizes[1]
    poperand_ms = 2 * poperand_bytes / PEAK_BYTES * 1e3
    # the dW kernel on its own over K6's 12 blocks at the fine pass's points, against
    # dw_plain and one torch.matmul per block (bf16 in, bf16 out) on the same operands
    dw_table = point_dw_table(pcfg.hidden_dim)
    dw_shapes = [(K, N) for *_, K, N in dw_table]
    dxs, dgs, dxt, dgt = dw_operands(torch, dev, torch.Generator().manual_seed(SEED + 12),
                                     dw_shapes, fine_m, poison=False)
    dKs = [K for K, _ in dw_shapes]
    dchunks = dw_chunks(dw_cta_tiles(dKs), fine_m,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    dw_ms = time_ms(lambda: dw_sm90(dxt, dgt, dKs, fine_m, dchunks), 10)
    dw_plain_ms = time_ms(lambda: [dw_plain(x, g, dchunks) for x, g in zip(dxs, dgs)], 2)
    dw_lib_ms = time_ms(lambda: [torch.matmul(x.t(), g) for x, g in zip(dxs, dgs)], 10)
    dw_flops = 2 * fine_m * sum(K * N for K, N in dw_shapes)
    dw_in_bytes = 2 * fine_m * sum(K + N for K, N in dw_shapes)
    dw_bound, dw_by, dw_ops_ms, dw_bytes_ms = bound(
        dw_flops, PEAK_BF16_FLOPS, dw_in_bytes + 4 * sum(K * N for K, N in dw_shapes))
    del dxs, dgs, dxt, dgt
    print(f"point_mlp_fwd: {coarse_m} points (coarse pass) {pfwd_coarse_ms:.3f} ms, bound "
          f"{pc_bound:.3f} ms; {fine_m} points (fine pass) {pfwd_ms:.3f} ms, plain version "
          f"{pfwd_plain_ms:.2f} ms; {p_flops * fine_m / 1e12:.3f} TFLOP ({pf_ops_ms:.3f} ms), "
          f"{(40 * fine_m + pweight_bytes) / 1e6:.1f} MB ({pf_bytes_ms:.4f} ms) -> bound "
          f"{pf_bound:.3f} ms by {pf_by} ({p_flops * fine_m / pfwd_ms / 1e9:.1f} TFLOP/s "
          f"achieved, {p_flops * fine_m / pfwd_ms * 1e3 / PEAK_BF16_FLOPS:.1%} of the bf16 "
          f"peak, {pfwd_ms / pf_bound:.2f} x the bound)")
    print(f"point_mlp_bwd: {fine_m} points {pbwd_ms:.3f} ms, plain version {pbwd_plain_ms:.2f} "
          f"ms; {3 * p_flops * fine_m / 1e12:.3f} TFLOP ({pb_ops_ms:.3f} ms), "
          f"{(64 * fine_m + pweight_bytes + pgrad_bytes) / 1e6:.1f} MB of points, cotangents, "
          f"weights and gradients ({pb_bytes_ms:.4f} ms) -> bound {pb_bound:.3f} ms by {pb_by} "
          f"({3 * p_flops * fine_m / pbwd_ms / 1e9:.1f} TFLOP/s achieved, "
          f"{pbwd_ms / pb_bound:.1f} x the bound); outside the bound, the operands the chain "
          f"writes for the dW kernel and it reads back: {poperand_bytes / 1e9:.3f} GB "
          f"({poperand_bytes / fine_m:.0f} B a point), {poperand_ms:.3f} ms at the memory rate")
    print(f"dw_sm90 (K6's 12 dW blocks on their own): {fine_m} points, {dchunks} chunks, "
          f"{dw_ms:.3f} ms, plain version {dw_plain_ms:.2f} ms, torch.matmul per block "
          f"(bf16 out) {dw_lib_ms:.3f} ms; {dw_flops / 1e12:.3f} TFLOP ({dw_ops_ms:.3f} ms), "
          f"{dw_in_bytes / 1e9:.3f} GB of operands ({dw_bytes_ms:.3f} ms) -> bound "
          f"{dw_bound:.3f} ms by {dw_by} ({dw_flops / dw_ms / 1e9:.1f} TFLOP/s achieved, "
          f"{dw_ms / dw_bound:.2f} x the bound)")
    print(f"point_mlp_bwd frozen-network variant (forward + dX, no dW/dB): {fine_m} points "
          f"{pbwd_frozen_ms:.3f} ms ({pbwd_ms / pbwd_frozen_ms:.2f} x faster than the full "
          f"variant), plain version {pbwd_frozen_plain_ms:.2f} ms; {pz_flops / 1e12:.3f} TFLOP "
          f"({pz_ops_ms:.3f} ms), {(64 * fine_m + pweight_bytes) / 1e6:.1f} MB ({pz_bytes_ms:.4f} "
          f"ms) -> bound {pz_bound:.3f} ms by {pz_by} ({pz_flops / pbwd_frozen_ms / 1e9:.1f} "
          f"TFLOP/s achieved, {pz_flops / pbwd_frozen_ms * 1e3 / PEAK_BF16_FLOPS:.1%} of the "
          f"bf16 peak, {pbwd_frozen_ms / pz_bound:.2f} x the bound)")

    def hier_steps():
        htrainer.run_steps(hstate, hscene, horder, hrefs, epoch=0, scheduling_start=10000)
    hier_step_ms = time_ms(hier_steps, 2) / HIER_STEPS
    hbatch = batch_for_frame(hscene, 1)
    hier_frame_ms = time_ms(lambda: htrainer.render_frame(hstate, hbatch, RESOLUTION), 2)
    hpose, hadam, henerf, heimg, hecam, heray_idx, hepcfg, hemc, hrcfg = hpose_args
    hier_pose_ms = time_ms(lambda: pose_opt_step(hpose, hadam, henerf, None, heimg, 0, hecam,
                                                 heray_idx, 1e-3, hepcfg, None, hemc.nerf,
                                                 hrcfg), 10)
    hrun = PoseOptRun(henerf, None, eval_scene, hemc.nerf, hrcfg, init_c2ws=eval_scene.c2ws_gt,
                      n_points=TRAIN_RAYS, seed=SEED, device=dev)
    hrun.rate.fill_(1e-3)
    hier_pose_replay_ms = time_ms(hrun.step, 10)
    geo_ms = time_ms(lambda: gtrainer.render_geo(gstate, gbatch, (120, 160)), 1)
    print(f"hierarchical train step {h}x{w}, {TRAIN_RAYS} rays x ({mc.render.num_points} + "
          f"{N_IMPORTANCE}): {hier_step_ms:.2f} ms end to end ({TRAIN_RAYS / hier_step_ms * 1e3:.0f}"
          f" rays/s), point_mlp_fwd x2 + point_mlp_bwd "
          f"{(pfwd_coarse_ms + pfwd_ms + pbwd_ms) / hier_step_ms:.1%} of it; hierarchical "
          f"Trainer.render_frame {h}x{w} {hier_frame_ms:.2f} ms end to end "
          f"({n_rays / hier_frame_ms * 1e3:.0f} rays/s); hierarchical pose-opt step "
          f"{hier_pose_ms:.2f} ms eagerly, {hier_pose_replay_ms:.2f} ms replayed; render_geo "
          f"120x160 {geo_ms:.1f} ms (plain density queries)")

    # K7 at the LLFF and Tanks Chamfer clouds, per direction; the fern train step end to end
    def library_nearest(x, y, rows=8192):
        # torch.cdist + min in row slabs (47,628^2 distances are 9 GB at once)
        return [torch.cdist(x[i:i + rows], y).min(dim=1) for i in range(0, x.shape[0], rows)]

    nearest_rows = {}
    n_sass = sweep_instructions_per_pair(CHAMFER_NEAREST, "chamfer_nearest")
    sgen = torch.Generator().manual_seed(SEED + 17)   # the draws of `gen` stay as they were
    small = ((torch.rand(5, 3, generator=sgen) * 6 - 3).to(dev),
             (torch.rand(40000, 3, generator=sgen) * 6 - 3).to(dev))
    for label, clouds in (("fern", (189, 252)), ("Tanks", (135, 240)), ("5 x 40000", small)):
        nx, ny = clouds if label == "5 x 40000" else depth_lifted_clouds(torch, dev, gen, *clouds)
        n_ms = time_ms(lambda: nearest_idx(nx, ny), 10)
        kx, ky = nx.contiguous(), ny.contiguous()
        n_bufs = _nearest_buffers(kx, ky)
        n_kernel_ms = time_ms(lambda: _nearest_launch(kx, ky, *n_bufs), 10)
        n_plain_ms = time_ms(lambda: nearest_idx_plain(nx, ny), 2)
        n_lib_ms = time_ms(lambda: library_nearest(nx, ny), 3)
        pairs = nx.shape[0] * ny.shape[0]
        # 3 products, 2 sums for the dot, 2 for d2 and the compare, in f32 outside the
        # tensor cores; 12 bytes in per point of each cloud, d2 and an int64 index out per
        # src point
        n_bound, n_by, _, _ = bound(8 * pairs, PEAK_F32_FLOPS, 12 * (nx.shape[0] + ny.shape[0])
                                    + 12 * nx.shape[0])
        nearest_rows[label] = (n_ms, n_plain_ms, n_lib_ms, n_bound, n_by)
        print(f"chamfer_nearest {nx.shape[0]} x {ny.shape[0]} ({label}), one direction: wrapper "
              f"{n_ms:.3f} ms, kernel alone (the bare C call: sweep and merge, "
              f"{n_bufs[0].blocks} blocks in {n_bufs[0].n_segs} segments) {n_kernel_ms:.3f} ms, "
              f"plain version {n_plain_ms:.2f} ms, torch.cdist + min in row slabs "
              f"{n_lib_ms:.3f} ms; {pairs / 1e9:.4f} G pairs x 8 f32 operations -> FLOP bound "
              f"{n_bound:.4f} ms by {n_by} ({n_ms / n_bound:.1f} x); "
              + issue_floor_text(n_sass, pairs, n_kernel_ms))
    dorder, drefs = epoch_order(dscene.n_frames, shuffle=True, seed=SEED)

    def disk_steps():
        dtrainer.run_steps(dstate, dscene, dorder, drefs, epoch=0, scheduling_start=10000)
    fern_step_ms = time_ms(disk_steps, 2) / len(dorder)
    k7_ms = nearest_rows["fern"][0]
    print(f"fern train step {dscene.imgs.shape[1]}x{dscene.imgs.shape[2]} from disk, "
          f"{TRAIN_RAYS} rays: {fern_step_ms:.2f} ms end to end by CUDA events, chamfer_nearest "
          f"x2 {2 * k7_ms:.2f} ms = {2 * k7_ms / fern_step_ms:.1%} of it, render_train "
          f"{train_ms / fern_step_ms:.1%}")

    # K1, K4 full and K4 frozen at the 512-sample path's 1024 x 512, K3 per 188x621 frame
    # at FRAME_POINTS: each bound counted as above, from this run's shapes
    gen = torch.Generator().manual_seed(SEED + 23)
    rays5, z5, tgt5 = train_inputs(torch, dev, gen, TRAIN_RAYS, PATH_POINTS)
    train5_ms = time_ms(lambda: render_ray_loss_fused(tparams, rays5, z5, tgt5, tcfg, False, 1,
                                                      False), 5)
    train5_plain_ms = time_ms(lambda: render_ray_loss_fused_plain(tparams, rays5, z5, tgt5, tcfg,
                                                                  False, 1, False), 1)
    t5_flops = train_flops(tcfg.hidden_dim, TRAIN_RAYS, PATH_POINTS)
    t5_bound, t5_by, t5_ops_ms, _ = bound(
        t5_flops, PEAK_BF16_FLOPS, 2 * numel_bytes([rays5, z5, tgt5]) + weight_bytes + grad_bytes)
    cot5 = bwd_cotangents(torch, tparams, rays5, z5, tgt5, tcfg, False, False)
    bwd5_ms = time_ms(lambda: _render_bwd_cuda(tparams, rays5, z5, *cot5, tcfg, False), 5)
    bwd5_frozen_ms = time_ms(lambda: _render_bwd_cuda(tparams, rays5, z5, *cot5, tcfg, False,
                                                      want_param_grads=False), 5)
    bwd5_plain_ms = time_ms(lambda: render_rays_fused_bwd_plain(tparams, rays5, z5, *cot5, tcfg,
                                                                False), 1)
    # the three kernels' outputs at this shape against their plain versions, held as
    # phase 12 holds them (2 chunks of rays for K1 and K4 full)
    a5 = _train_cuda(tparams, rays5, z5, tgt5, tcfg, False, 1, False)
    _, r5_sums, r5_grads = render_ray_loss_fused_plain(tparams, rays5, z5, tgt5, tcfg, False, 1,
                                                       False)
    rel5 = float(((a5[0] - r5_sums).abs() / r5_sums.abs().clamp_min(1e-12)).max())
    train5_err, tk5, ts5, _ = held(
        dict(unpack_grads(a5[1], a5[2], tcfg), rays=a5[3], z=a5[4], tgt=a5[5]),
        dict(r5_grads["params"], rays=r5_grads["rays"], z=r5_grads["z"], tgt=r5_grads["tgt"]),
        ("rays", "z"))
    train5_err = max(train5_err, max_err(a5[0], r5_sums))
    b5 = _render_bwd_cuda(tparams, rays5, z5, *cot5, tcfg, False)
    f5 = _render_bwd_cuda(tparams, rays5, z5, *cot5, tcfg, False, want_param_grads=False)
    ref5 = render_rays_fused_bwd_plain(tparams, rays5, z5, *cot5, tcfg, False)
    bwd5_err, bk5, bs5, _ = held(dict(unpack_grads(b5[0], b5[1], tcfg), rays=b5[2], z=b5[3]),
                                 dict(unpack_grads(ref5[0], ref5[1], tcfg), rays=ref5[2],
                                      z=ref5[3]), ("rays", "z"))
    frozen5_err, fk5, fs5, _ = held(dict(rays=f5[2], z=f5[3]), dict(rays=ref5[2], z=ref5[3]),
                                    ("rays", "z"))
    print(f"at {TRAIN_RAYS} rays x {PATH_POINTS} against the plain versions: render_train sums "
          f"rel {rel5:.3g}, worst {tk5} at {ts5:.3f} of its tolerance; render_bwd worst {bk5} at "
          f"{bs5:.3f}; frozen-network variant worst {fk5} at {fs5:.3f}")
    if not (rel5 <= 2e-3 and max(ts5, bs5, fs5) <= 1.0):
        raise RuntimeError(f"render_train or render_bwd at {TRAIN_RAYS} x {PATH_POINTS} "
                           "disagrees with its plain version")
    del a5, b5, f5, ref5, r5_grads
    f5_io = numel_bytes([rays5, z5, cot5[0], cot5[1]]) + numel_bytes([rays5, z5]) + weight_bytes
    f5_bound, f5_by, _, _ = bound(2 * t5_flops / 3, PEAK_BF16_FLOPS, f5_io)
    b5_bound, b5_by, _, _ = bound(t5_flops, PEAK_BF16_FLOPS, f5_io + grad_bytes)
    op5_gb = sum(render_operand_bytes(tcfg.hidden_dim, TRAIN_RAYS, PATH_POINTS)) / 1e9
    chunks5 = len(render_chunks(TRAIN_RAYS, PATH_POINTS, tcfg.hidden_dim))
    print(f"render_train {TRAIN_RAYS} rays x {PATH_POINTS}: {train5_ms:.3f} ms "
          f"({t5_flops / train5_ms / 1e9:.1f} TFLOP/s, {train5_ms / t5_bound:.2f} x the bound "
          f"{t5_bound:.3f} ms by {t5_by}), plain version {train5_plain_ms:.1f} ms; render_bwd "
          f"full {bwd5_ms:.3f} ms ({bwd5_ms / b5_bound:.2f} x its bound {b5_bound:.3f} ms), "
          f"frozen-network variant {bwd5_frozen_ms:.3f} ms ({bwd5_frozen_ms / f5_bound:.2f} x its "
          f"bound {f5_bound:.3f} ms), plain version {bwd5_plain_ms:.1f} ms; {op5_gb:.3f} GB of dW "
          f"operands in {chunks5} chunks of rays")
    table16, z16, _ = view0_inputs(h, FRAME_POINTS)
    fwd16_ms = time_ms(lambda: render_rays_fused(params["nerf"], table16, z16, ncfg,
                                                 rcfg.dist_alpha, want_aux=False), 2)
    # the plain version over the same frame in slices of 512 rays (its activations at
    # 2048 samples would take tens of GB at once), one timed pass after the 128-sample
    # one, whose rgb and dist the kernel's are held against
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    slices = [render_rays_fused_plain(params["nerf"], table16[i:i + 512], z16[i:i + 512], ncfg,
                                      rcfg.dist_alpha, want_aux=False)[:2]
              for i in range(0, n_rays, 512)]
    end.record()
    torch.cuda.synchronize()
    fwd16_plain_ms = start.elapsed_time(end)
    got16 = render_rays_fused(params["nerf"], table16, z16, ncfg, rcfg.dist_alpha,
                              want_aux=False)
    report, fwd16_err = [], 0.0
    for j, name in enumerate(("rgb", "dist")):
        ref = torch.cat([sl[j] for sl in slices])
        err, tol = max_err(got16[j], ref), tolerance(ref)
        fwd16_err = max(fwd16_err, err)
        report.append(f"{name} {err:.3g}/{tol:.3g}")
        if not err <= tol:
            raise RuntimeError(f"render_fwd over the {FRAME_POINTS}-sample frame: {name} err "
                               f"{err:.3g} > {tol:.3g} against the plain version")
    del slices, got16
    fwd16_flops = mlp_flops(ncfg.hidden_dim, n_rays, FRAME_POINTS)
    fwd16_bytes = (table16.numel() + z16.numel() + 4 * n_rays) * 4 + numel_bytes(
        sum(pack_weights(params["nerf"], ncfg), []))
    fwd16_bound, fwd16_by, _, _ = bound(fwd16_flops, PEAK_BF16_FLOPS, fwd16_bytes)
    print(f"render_fwd {h}x{w} frame at {FRAME_POINTS} samples: {fwd16_ms:.2f} ms "
          f"({fwd16_flops / fwd16_ms / 1e9:.1f} TFLOP/s, {fwd16_ms / fwd16_bound:.2f} x the bound "
          f"{fwd16_bound:.2f} ms by {fwd16_by}), plain version {fwd16_plain_ms:.0f} ms in slices "
          f"of 512 rays; against it " + ", ".join(report))
    wide_entries = time_wide(torch, dev, wide, table, z, smi)
    xwide_entries = time_xwide(torch, dev, xwide, table, z, smi)
    print(json.dumps({"many_samples": {
        "card": smi, "chunked_1024x2048": many["chunked"],
        "step_1024x2048_peak_gb": many["step_peak_gb"],
        "step_512": {k: many["graph"][k] for k in ("eager_ms", "replay_ms", "pool_mb")}}}))

    # DPT and LPIPS are library calls (F.conv2d, matmul), not hand-written kernels
    print(json.dumps({"card": smi, **prep}))
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
        # the full variant (dW, dB, d(rays), dz), launched by the unfused train steps
        {"name": "render_bwd", "route": "cuda",
         "source": "nope_nerf_torch/csrc/render_bwd.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_render.py:535",
         "launches": unfused_counts["render_bwd"] - unfused_counts["render_bwd_frozen"],
         "max_abs_err": bwd_err, "ms": bwd_ms,
         "plain_ms": bwd_plain_ms, "bound_ms": b_bound, "bound_by": b_by,
         "library_ms": None},
        # its frozen-network variant (d(rays), dz only), launched by cli.eval's pose
        # optimisation; the plain version it is held against computes dW and dB as well
        {"name": "render_bwd_frozen", "route": "cuda",
         "source": "nope_nerf_torch/csrc/render_bwd_frozen.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_render.py:535",
         "launches": eval_counts["render_bwd_frozen"], "max_abs_err": bwd_frozen_err,
         "ms": bwd_frozen_ms, "plain_ms": bwd_plain_ms, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": None},
        # ms: the wrapper's (both device launches and its allocations); the kernel alone
        # is printed beside it
        {"name": "chamfer_bidir", "route": "cuda",
         "source": "nope_nerf_torch/csrc/chamfer_bidir.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_chamfer.py:78",
         "launches": counts["chamfer_bidir"], "max_abs_err": chamfer_gap, "ms": chamfer_ms,
         "plain_ms": chamfer_plain_ms, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": chamfer_lib_ms},
        # at the fine pass's 196,608 points; the coarse pass's time is printed above
        {"name": "point_mlp_fwd", "route": "cuda",
         "source": "nope_nerf_torch/csrc/point_mlp_fwd.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_mlp.py:186",
         "launches": hier_counts["point_mlp_fwd"], "max_abs_err": pfwd_err, "ms": pfwd_ms,
         "plain_ms": pfwd_plain_ms, "bound_ms": pf_bound, "bound_by": pf_by,
         "library_ms": None},
        {"name": "point_mlp_bwd", "route": "cuda",
         "source": "nope_nerf_torch/csrc/point_mlp_bwd.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_mlp.py:273",
         "launches": hier_counts["point_mlp_bwd"], "max_abs_err": pbwd_err, "ms": pbwd_ms,
         "plain_ms": pbwd_plain_ms, "bound_ms": pb_bound, "bound_by": pb_by,
         "library_ms": None},
        # the weight-gradient kernel K6 full launches for its dW blocks (the TPU kernel's
        # _dmat products), timed on its own over K6's 12 blocks at the fine pass's points
        {"name": "dw_sm90", "route": "cuda",
         "source": "nope_nerf_torch/csrc/dw_sm90.cuh",
         "replaces": "nope_nerf_tpu/ops/pallas_mlp.py:197",
         "launches": hier_counts["dw_sm90"], "max_abs_err": dw_err, "ms": dw_ms,
         "plain_ms": dw_plain_ms, "bound_ms": dw_bound, "bound_by": dw_by,
         "library_ms": dw_lib_ms},
        # its frozen-network variant (d(points), d(directions) only), launched by the
        # hierarchical pose optimisation; at the fine pass's 196,608 points
        {"name": "point_mlp_bwd_frozen", "route": "cuda",
         "source": "nope_nerf_torch/csrc/point_mlp_bwd_frozen.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_mlp.py:273",
         "launches": hpose_counts["point_mlp_bwd_frozen"], "max_abs_err": pbwd_frozen_err,
         "ms": pbwd_frozen_ms, "plain_ms": pbwd_frozen_plain_ms, "bound_ms": pz_bound,
         "bound_by": pz_by, "library_ms": None},
        # one direction at the fern step's 47,628-point clouds; the step launches it twice
        {"name": "chamfer_nearest", "route": "cuda",
         "source": "nope_nerf_torch/csrc/chamfer_nearest.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_chamfer.py:150",
         "launches": disk_counts["chamfer_nearest"], "max_abs_err": nearest_err,
         "ms": nearest_rows["fern"][0], "plain_ms": nearest_rows["fern"][1],
         "bound_ms": nearest_rows["fern"][3], "bound_by": nearest_rows["fern"][4],
         "library_ms": nearest_rows["fern"][2]},
        # the kernels at more samples, at the 512-sample path's shapes (launches: that
        # path's replayed steps, its invariant-depth steps, its cli.eval) and K3 per frame at
        # 2048 samples (launches: the 2048-sample render_frame); max_abs_err against the
        # plain versions at those shapes
        {"name": "render_train (1024 x 512)", "route": "cuda",
         "source": "nope_nerf_torch/csrc/render_train.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_render.py:605",
         "launches": round(many["fused_counts"]["render_train"] * TRAIN_STEPS),
         "max_abs_err": train5_err, "ms": train5_ms,
         "plain_ms": train5_plain_ms, "bound_ms": t5_bound, "bound_by": t5_by,
         "library_ms": None},
        {"name": "render_bwd (1024 x 512)", "route": "cuda",
         "source": "nope_nerf_torch/csrc/render_bwd.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_render.py:535",
         "launches": many["invariant_counts"]["render_bwd"],
         "max_abs_err": bwd5_err, "ms": bwd5_ms, "plain_ms": bwd5_plain_ms,
         "bound_ms": b5_bound, "bound_by": b5_by, "library_ms": None},
        {"name": "render_bwd_frozen (1024 x 512)", "route": "cuda",
         "source": "nope_nerf_torch/csrc/render_bwd_frozen.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_render.py:535",
         "launches": many["eval_counts"]["render_bwd_frozen"],
         "max_abs_err": frozen5_err, "ms": bwd5_frozen_ms,
         "plain_ms": bwd5_plain_ms, "bound_ms": f5_bound, "bound_by": f5_by,
         "library_ms": None},
        {"name": "render_fwd (188x621 x 2048)", "route": "cuda",
         "source": "nope_nerf_torch/csrc/render_fwd.cu",
         "replaces": "nope_nerf_tpu/ops/pallas_render.py:368",
         "launches": many["frame_counts"]["render_fwd"],
         "max_abs_err": fwd16_err, "ms": fwd16_ms,
         "plain_ms": fwd16_plain_ms, "bound_ms": fwd16_bound, "bound_by": fwd16_by,
         "library_ms": None}] + wide_entries + xwide_entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--cli-worker"]:
        sys.exit(cli_worker(sys.argv[2:]))
    sys.exit(main())
