"""Times the render kernels of the checkout it runs from, and prints a digest
of their outputs' bits, so that two checkouts run one after the other on one
card compare both in time and in bits:

    python3 -m nope_nerf_torch.tools.render_timing

from the root of a checkout, on a machine with one NVIDIA GPU. It builds the
four render sources (K3 render_fwd.cu, K1 render_train.cu, K4 render_bwd.cu
and render_bwd_frozen.cu) and runs each through its wrapper on seeded inputs
at hidden_dim 256 (softplus, no dist_alpha): K1, K4 full and K4 frozen at 1024
rays x 128, 256 and 512 samples, K3 over a 188x621 frame at 128 samples and on
1024 rays x 1024 samples (the most K3 took before it lost its cap). Each case is timed by CUDA events over `--reps` calls after one
warm-up. 133 rays at 1024 samples (K1, K4; past shared memory's room) and at
2048 samples (K3) are run once for their digest only. Prints the card's name
and power limit, then one JSON line: ms and SHA-256 of the outputs per case.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import torch

from ..models.nerf import NerfConfig, init_nerf_params
from ..ops import fused_render as F
from ..ops._build import build_all

SEED = 0
DENSITY_SHIFT = -4.0   # keeps transmittance alive over the ray at 128 samples
FRAME = (188, 621)
TRAIN_CASES = ((1024, 128), (1024, 256), (1024, 512))
FWD_CASES = ((FRAME[0] * FRAME[1], 128), (1024, 1024))
DIGEST_ONLY = {"train": (133, 1024), "fwd": (133, 2048)}


def _inputs(gen, n: int, S: int, dev):
    origin = torch.randn(n, 3, generator=gen) * 0.5
    ray_vec = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    rays = F.pack_rays(origin, ray_vec, -ray_vec).to(dev)
    z = torch.sort(0.1 + 5.9 * torch.rand(n, S, generator=gen), dim=1).values.to(dev)
    mask = (torch.arange(n) % 3 != 0).to(dev)
    tgt = F.pack_targets(torch.rand(n, 3, generator=gen).to(dev),
                         (1.0 + 4.0 * torch.rand(n, generator=gen)).to(dev), mask, 0.7 / n,
                         0.3 / float(mask.sum()))
    g_rgb = (torch.randn(n, 3, generator=gen) / n).to(dev)
    g_dist = (torch.randn(n, generator=gen) / n).to(dev)
    return rays, z, tgt, g_rgb, g_dist


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in out:
        if isinstance(t, (list, tuple)):
            for u in t:
                h.update(u.detach().cpu().numpy().tobytes())
        elif t is not None:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("render_timing needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    build_all((F.RENDER_FWD, F.RENDER_TRAIN, F.RENDER_BWD, F.RENDER_BWD_FROZEN))
    ncfg = NerfConfig(hidden_dim=256, use_pallas=True)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(SEED), device=dev)
    params["density_b"] = params["density_b"] + DENSITY_SHIFT
    gen = torch.Generator().manual_seed(SEED + 1)
    ms, digest = {}, {}

    def case(name, fn, reps):
        digest[name] = _digest(fn())
        if reps:
            ms[name] = _time(fn, reps)

    for n, S in TRAIN_CASES + (DIGEST_ONLY["train"],):
        rays, z, tgt, g_rgb, g_dist = _inputs(gen, n, S, dev)
        reps = 0 if (n, S) == DIGEST_ONLY["train"] else args.reps
        case(f"render_train {n}x{S}",
             lambda: F._train_cuda(params, rays, z, tgt, ncfg, False, 1, False), reps)
        case(f"render_bwd {n}x{S}",
             lambda: F._render_bwd_cuda(params, rays, z, g_rgb, g_dist, None, None, ncfg, False),
             reps)
        case(f"render_bwd_frozen {n}x{S}",
             lambda: F._render_bwd_cuda(params, rays, z, g_rgb, g_dist, None, None, ncfg, False,
                                        want_param_grads=False), reps)
    for n, S in FWD_CASES + (DIGEST_ONLY["fwd"],):
        rays, z, *_ = _inputs(gen, n, S, dev)
        reps = 0 if (n, S) == DIGEST_ONLY["fwd"] else max(1, args.reps // 2)
        case(f"render_fwd {n}x{S}",
             lambda: F.render_rays_fused(params, rays, z, ncfg, False, want_aux=n <= 1024), reps)
    print(json.dumps({"ms": ms, "digest": digest}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
