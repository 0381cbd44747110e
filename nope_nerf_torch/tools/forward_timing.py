"""Times the forward kernels (K3, K5), the frozen-network backward kernels
(K4's and K6's variants) or the kernels that form weight gradients (K1, K4
full, K6 full, the dW kernel) of the checkout it runs from, at each
hidden_dim asked for, and prints a digest of their outputs' bits, so that two
checkouts run one after the other on one card compare both in time and in
bits:

    python3 -m nope_nerf_torch.tools.forward_timing --widths 256 384 512
    python3 -m nope_nerf_torch.tools.forward_timing --kernels frozen --widths 256 384 512 --sass
    python3 -m nope_nerf_torch.tools.forward_timing --kernels full --widths 128 256 384 512 --sass

from the root of a checkout, on a machine with one NVIDIA GPU (each checkout
runs its own copy: "kernel alone" calls the C interface of its checkout, at
the widths that checkout takes, 128 to 1024 for the forward kernels since
they run csrc/mlp_fwd_xwide_sm90.cuh's trunk past 512). Per width, on seeded weights (softplus, no
dist_alpha) and inputs, each case by CUDA events over `--reps` calls after
one warm-up:
- `--kernels forward` (the default): K3 (render_fwd.cu) over a 188x621
  frame of rays at 128 samples (the render path's launch) and K5
  (point_mlp_fwd.cu) at 196,608 points (the fine pass of a hierarchical
  train step), through its wrapper (which packs the weights on every call,
  as the path does) and as the bare C call on weights packed once ("kernel
  alone");
- `--kernels frozen`: the frozen-network backward variants through
  `_render_bwd_cuda` and `_mlp_bwd_cuda` with want_param_grads=False: K4's
  (render_bwd_frozen.cu) at 1024 rays x 128 samples (the pose-opt step's
  launch) and 1024 x 512, on the cotangents of a colour and depth loss, and
  K6's (point_mlp_bwd_frozen.cu) at 196,608 points (the fine pass of a
  hierarchical pose-opt step), at 128 to 1024 since their chain past 512
  (csrc/mlp_dx_xwide_sm90.cuh);
- `--kernels full`: K6 full through `_mlp_bwd_cuda` at 196,608 points (the
  fine pass of a hierarchical train step: every dW, dB, d(points),
  d(directions)), 128 to 1024 since its kernel past 512 (csrc/point_mlp_bwd_xwide.cu);
  at the widths K1 and K4 full take (128 to 1024 since their kernel past 512,
  csrc/render_train_xwide.cu and csrc/render_bwd_xwide.cu; 128 to 512 in a
  checkout before it), K1 through `_train_cuda` and K4 full through
  `_render_bwd_cuda` at 1024 rays x 128 samples (the train step's launch, two
  chunks of rays past 512); and the dW kernel on its own
  (`dw_sm90`) over K6's blocks at 256 on 196,608 rows of seeded operands.
  Its SASS digests are per library (each source builds its own copy of the
  dW kernel and of the sums of the partials). Per case of K1, K4 full and
  K6 full it also gives the dW kernel's share of the call's device time
  (its launch and the sums of its partials, by torch.profiler over two
  calls).
Prints the card's name and power limit, ptxas's lines of each library's
build that name a kernel instance or give its registers and spills, then one
JSON line: ms and SHA-256 of the outputs per case, and with `--sass` the
SHA-256 of each kernel instance's SASS instructions (`cuobjdump -sass`,
function names left out), which shows whether two checkouts compiled a width
to the same code.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess

import torch

from ..models.nerf import NerfConfig, init_nerf_params
from ..ops import fused_mlp as FM
from ..ops import fused_render as F
from ..ops._build import build_all, find_nvcc
from .chamfer_profile import cuobjdump, sass_functions

SEED = 0
DENSITY_SHIFT = -4.0    # keeps transmittance alive over the ray at 128 samples
FRAME = (188, 621)
SAMPLES = 128
POINTS = 196_608
BWD_RAYS = 1024
BWD_SAMPLES = (128, 512)
# the mangled names of each set's kernel instances: kernel, template arguments
SASS_NAMES = {"forward": r"(render_fwd_kernel|point_mlp_fwd_kernel)I(Li\d+E(?:Lb\d)?)",
              "frozen": r"((?:render|point_mlp)_bwd_frozen(?:_wide|_xwide)?_kernel)I(Li\d+E(?:Lb\d)?)",
              "full": r"((?:point_mlp_bwd(?:_wide|_xwide)?|render_full(?:_wide|_xwide)?|dw_sm90|dw_reduce|"
                      r"chain_reduce)_kernel)(I(?:Li\d+E|Lb\d+E)+E|E)"}


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sass_digests(libraries, pattern: str, per_library: bool = False) -> dict:
    """{"<kernel> <template arguments>": SHA-256 of its SASS instructions} for
    every kernel template instance in the built libraries whose mangled name
    `pattern` finds (group 1 the kernel, group 2 its arguments), each key led
    by its library's source with per_library; {} without cuobjdump."""
    tool = cuobjdump()
    if tool is None:
        return {}
    out = {}
    for lib in libraries:
        sass = subprocess.run([tool, "-sass", str(lib._target(find_nvcc()))], capture_output=True,
                              text=True, check=True).stdout
        for fname, instrs in sass_functions(sass).items():
            m = re.search(pattern, fname)
            if m:
                text = "\n".join(instr for _, instr in instrs)
                key = f"{m.group(1)} {m.group(2)}"
                out[f"{lib.source.name}: {key}" if per_library else key] = hashlib.sha256(
                    text.encode()).hexdigest()[:16]
    return out


def forward_cases(dev, gen, widths, reps: int):
    """{name: (call, reps)} of K3 and K5 at each width (see the module text)."""
    n = FRAME[0] * FRAME[1]
    origin = torch.randn(n, 3, generator=gen) * 0.5
    ray_vec = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    rays = F.pack_rays(origin, ray_vec, -ray_vec).to(dev)
    z = torch.sort(0.1 + 5.9 * torch.rand(n, SAMPLES, generator=gen), dim=1).values.to(dev)
    pts = (torch.randn(POINTS, 3, generator=gen) * 1.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(POINTS, 3, generator=gen), dim=1).to(dev)
    cases = {}
    for D, ncfg, params in _width_params(dev, widths):
        tiles, biases = F.pack_tiles(params, ncfg)
        bptrs = (ctypes.c_void_p * 12)(*[b.data_ptr() for b in biases])
        rgb, density = torch.empty(POINTS, 3, device=dev), torch.empty(POINTS, 1, device=dev)
        # the staging of the trunk past 512 (none at 128 to 512)
        stage = F._spill(FM.POINT_MLP_FWD.lib().nerf_point_mlp_fwd_stage(POINTS, D), dev)

        def k5_alone(D=D, tiles=tiles, biases=biases, bptrs=bptrs, rgb=rgb, density=density,
                     stage=stage):
            err = FM.POINT_MLP_FWD.lib().nerf_point_mlp_fwd(
                pts.data_ptr(), dirs.data_ptr(), tiles.data_ptr(), bptrs, rgb.data_ptr(),
                density.data_ptr(), F._ptr(stage), POINTS, D, 1, 0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(FM.POINT_MLP_FWD.lib().nerf_error_string(err).decode())
            return rgb, density

        cases[f"render_fwd D={D} {n}x{SAMPLES}"] = (
            lambda p=params, c=ncfg: F.render_rays_fused(p, rays, z, c, False, want_aux=False)[:2],
            reps)
        cases[f"point_mlp_fwd D={D} {POINTS}"] = (
            lambda p=params, c=ncfg: FM._mlp_fwd_cuda(p, pts, dirs, c), 4 * reps)
        cases[f"point_mlp_fwd kernel alone D={D} {POINTS}"] = (k5_alone, 4 * reps)
    return cases


def frozen_cases(dev, gen, widths, reps: int):
    """{name: (call, reps)} of K4 frozen and K6 frozen at each width."""
    origin = torch.randn(BWD_RAYS, 3, generator=gen) * 0.5
    ray_vec = torch.nn.functional.normalize(torch.randn(BWD_RAYS, 3, generator=gen), dim=1)
    rays = F.pack_rays(origin, ray_vec, -ray_vec).to(dev)
    zs = {S: torch.sort(0.1 + 5.9 * torch.rand(BWD_RAYS, S, generator=gen), dim=1).values.to(dev)
          for S in BWD_SAMPLES}
    g_rgb = (torch.randn(BWD_RAYS, 3, generator=gen) * 1e-3).to(dev)
    g_dist = (torch.randn(BWD_RAYS, generator=gen) * 1e-3).to(dev)
    pts = (torch.randn(POINTS, 3, generator=gen) * 1.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(POINTS, 3, generator=gen), dim=1).to(dev)
    p_rgb = (torch.randn(POINTS, 3, generator=gen) * 1e-6).to(dev)
    p_den = torch.full((POINTS, 1), 0.1 / POINTS, device=dev)
    cases = {}
    for D, ncfg, params in _width_params(dev, widths):
        for S, z in zs.items():
            cases[f"render_bwd_frozen D={D} {BWD_RAYS}x{S}"] = (
                lambda p=params, c=ncfg, z=z: F._render_bwd_cuda(
                    p, rays, z, g_rgb, g_dist, None, None, c, False, want_param_grads=False)[2:],
                reps)
        cases[f"point_mlp_bwd_frozen D={D} {POINTS}"] = (
            lambda p=params, c=ncfg: FM._mlp_bwd_cuda(p, pts, dirs, p_rgb, p_den, c,
                                                      want_param_grads=False)[2:], reps)
    return cases


def full_cases(dev, gen, widths, reps: int):
    """{name: (call, reps)} of K6 full at each width, K1 and K4 full at the
    widths they take, and the dW kernel on its own."""
    n = BWD_RAYS
    origin = torch.randn(n, 3, generator=gen) * 0.5
    ray_vec = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    rays = F.pack_rays(origin, ray_vec, -ray_vec).to(dev)
    z = torch.sort(0.1 + 5.9 * torch.rand(n, SAMPLES, generator=gen), dim=1).values.to(dev)
    mask = (torch.arange(n) % 3 != 0).to(dev)
    tgt = F.pack_targets(torch.rand(n, 3, generator=gen).to(dev),
                         (1.0 + 4.0 * torch.rand(n, generator=gen)).to(dev), mask, 0.7 / n,
                         0.3 / float(mask.sum()))
    g_rgb = (torch.randn(n, 3, generator=gen) * 1e-3).to(dev)
    g_dist = (torch.randn(n, generator=gen) * 1e-3).to(dev)
    pts = (torch.randn(POINTS, 3, generator=gen) * 1.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(POINTS, 3, generator=gen), dim=1).to(dev)
    p_rgb = (torch.randn(POINTS, 3, generator=gen) * 1e-6).to(dev)
    p_den = torch.full((POINTS, 1), 0.1 / POINTS, device=dev)

    def flat(out):
        return [t for o in out for t in (o if isinstance(o, (list, tuple)) else [o])]

    cases = {}
    for D, ncfg, params in _width_params(dev, widths):
        cases[f"point_mlp_bwd D={D} {POINTS}"] = (
            lambda p=params, c=ncfg: flat(FM._mlp_bwd_cuda(p, pts, dirs, p_rgb, p_den, c)), reps)
        if D in F.KERNEL_WIDTHS["train"]:
            cases[f"render_train D={D} {n}x{SAMPLES}"] = (
                lambda p=params, c=ncfg: flat(F._train_cuda(p, rays, z, tgt, c, False, 1, False)),
                reps)
            cases[f"render_bwd D={D} {n}x{SAMPLES}"] = (
                lambda p=params, c=ncfg: flat(F._render_bwd_cuda(p, rays, z, g_rgb, g_dist, None,
                                                                 None, c, False)), reps)
    shapes = [(K, N) for *_, K, N in FM.point_dw_table(256)]
    xt = [FM.tile_operand(torch.randn(POINTS, K, generator=gen).to(dev)) for K, _ in shapes]
    gt = [FM.tile_operand(torch.randn(POINTS, N, generator=gen).to(dev)) for _, N in shapes]
    Ks = [K for K, _ in shapes]
    chunks = FM.dw_chunks(FM.dw_cta_tiles(Ks), POINTS,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    cases[f"dw_sm90 K6's blocks at 256, {POINTS} rows"] = (
        lambda: FM.dw_sm90(xt, gt, Ks, POINTS, chunks), reps)
    return cases


def dw_shares(cases) -> dict:
    """{case: the dW kernel's share of its device time} for the cases that
    launch it with a chain (K1, K4 full, K6 full), by torch.profiler over two
    calls each; {} where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    shares = {}
    for name, (fn, _) in cases.items():
        if name.startswith("dw_sm90"):
            continue
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
        kt = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
        dw = sum(v for k, v in kt.items() if "dw_sm90_kernel" in k or "dw_reduce_kernel" in k)
        total = sum(kt.values())
        if total > 0:
            shares[name] = dw / total
    return shares


def _width_params(dev, widths):
    """(D, NerfConfig, seeded params) per width, the density bias lowered."""
    for D in widths:
        ncfg = NerfConfig(hidden_dim=D, use_pallas=True)
        params = init_nerf_params(ncfg, torch.Generator().manual_seed(SEED + D), device=dev)
        params["density_b"] = params["density_b"] + DENSITY_SHIFT
        yield D, ncfg, params


KERNEL_SETS = {"forward": ((F.RENDER_FWD, FM.POINT_MLP_FWD), forward_cases, 5),
               "frozen": ((F.RENDER_BWD_FROZEN, FM.POINT_MLP_BWD_FROZEN), frozen_cases, 10),
               "full": ((FM.POINT_MLP_BWD, FM.POINT_MLP_BWD_XWIDE, F.RENDER_TRAIN, F.RENDER_BWD,
                         F.RENDER_TRAIN_XWIDE, F.RENDER_BWD_XWIDE, FM.DW_SM90), full_cases, 5)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", choices=sorted(KERNEL_SETS), default="forward")
    ap.add_argument("--widths", type=int, nargs="+", default=[256])
    ap.add_argument("--reps", type=int, default=None,
                    help="calls timed per case (default 5 forward and full, 10 frozen)")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("forward_timing needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libraries, make_cases, reps = KERNEL_SETS[args.kernels]
    build_all(libraries)
    for lib in libraries:
        for line in lib.build_log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "serialized")):
                print(f"ptxas {lib.source.name}: {line.strip()}")
    if args.sass:
        print(json.dumps({"sass": sass_digests(libraries, SASS_NAMES[args.kernels],
                                               per_library=args.kernels == "full")}))
    gen = torch.Generator().manual_seed(SEED + 1)
    ms, digest = {}, {}
    for name, (fn, n) in make_cases(dev, gen, args.widths, args.reps or reps).items():
        digest[name] = _digest(fn())
        ms[name] = _time(fn, n)
    out = {"ms": ms, "digest": digest}
    if args.kernels == "full":
        out["dw_share"] = dw_shares(make_cases(dev, torch.Generator().manual_seed(SEED + 1),
                                               args.widths, 1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
