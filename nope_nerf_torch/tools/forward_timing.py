"""Times the forward kernels K3 (render_fwd.cu) and K5 (point_mlp_fwd.cu) of
the checkout it runs from, at each hidden_dim asked for, and prints a digest
of their outputs' bits, so that two checkouts run one after the other on one
card compare both in time and in bits:

    python3 -m nope_nerf_torch.tools.forward_timing --widths 256 384 512

from the root of a checkout, on a machine with one NVIDIA GPU (it uses only
the wrappers `render_rays_fused` and `_mlp_fwd_cuda`, so a copy of this file
runs in a checkout that predates it, at the widths that checkout takes). Per
width, on seeded weights (softplus, no dist_alpha) and inputs: K3 over a
188x621 frame of rays at 128 samples (the render path's launch) and K5 at
196,608 points (the fine pass of a hierarchical train step), each by CUDA
events over `--reps` calls after one warm-up, through its wrapper (K5's packs
the weights on every call, as the path does); K5 also as the bare C call on
weights packed once ("kernel alone"). Prints the card's name and
power limit, then one JSON line: ms and SHA-256 of the outputs per case,
and with `--sass` the SHA-256 of each kernel instance's SASS instructions
(`cuobjdump -sass`, function names left out), which shows whether two
checkouts compiled a width to the same code.
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


def sass_digests(libraries) -> dict:
    """{"<kernel> D=<width>": SHA-256 of its SASS instructions} for every
    kernel template instance in the built libraries; {} without cuobjdump."""
    tool = cuobjdump()
    if tool is None:
        return {}
    out = {}
    for lib in libraries:
        sass = subprocess.run([tool, "-sass", str(lib._target(find_nvcc()))], capture_output=True,
                              text=True, check=True).stdout
        for fname, instrs in sass_functions(sass).items():
            m = re.search(r"(render_fwd_kernel|point_mlp_fwd_kernel)ILi(\d+)E", fname)
            if m:
                text = "\n".join(instr for _, instr in instrs)
                out[f"{m.group(1)} D={m.group(2)}"] = hashlib.sha256(text.encode()).hexdigest()[:16]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[256])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("forward_timing needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libraries = (F.RENDER_FWD, FM.POINT_MLP_FWD)
    build_all(libraries)
    if args.sass:
        print(json.dumps({"sass": sass_digests(libraries)}))
    gen = torch.Generator().manual_seed(SEED + 1)
    n = FRAME[0] * FRAME[1]
    origin = torch.randn(n, 3, generator=gen) * 0.5
    ray_vec = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    rays = F.pack_rays(origin, ray_vec, -ray_vec).to(dev)
    z = torch.sort(0.1 + 5.9 * torch.rand(n, SAMPLES, generator=gen), dim=1).values.to(dev)
    pts = (torch.randn(POINTS, 3, generator=gen) * 1.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(POINTS, 3, generator=gen), dim=1).to(dev)
    ms, digest = {}, {}
    for D in args.widths:
        ncfg = NerfConfig(hidden_dim=D, use_pallas=True)
        params = init_nerf_params(ncfg, torch.Generator().manual_seed(SEED + D), device=dev)
        params["density_b"] = params["density_b"] + DENSITY_SHIFT
        tiles, biases = F.pack_tiles(params, ncfg)
        bptrs = (ctypes.c_void_p * 12)(*[b.data_ptr() for b in biases])
        rgb, density = torch.empty(POINTS, 3, device=dev), torch.empty(POINTS, 1, device=dev)

        def k5_alone():
            err = FM.POINT_MLP_FWD.lib().nerf_point_mlp_fwd(
                pts.data_ptr(), dirs.data_ptr(), tiles.data_ptr(), bptrs, rgb.data_ptr(),
                density.data_ptr(), POINTS, D, 1, 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(FM.POINT_MLP_FWD.lib().nerf_error_string(err).decode())
            return rgb, density

        cases = {f"render_fwd D={D} {n}x{SAMPLES}":
                 (lambda: F.render_rays_fused(params, rays, z, ncfg, False, want_aux=False)[:2],
                  args.reps),
                 f"point_mlp_fwd D={D} {POINTS}":
                 (lambda: FM._mlp_fwd_cuda(params, pts, dirs, ncfg), 4 * args.reps),
                 f"point_mlp_fwd kernel alone D={D} {POINTS}": (k5_alone, 4 * args.reps)}
        for name, (fn, reps) in cases.items():
            digest[name] = _digest(fn())
            ms[name] = _time(fn, reps)
    print(json.dumps({"ms": ms, "digest": digest}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
