"""What holds back the forward MLP trunk (csrc/mlp_fwd_sm90.cuh) of the render
kernel (K3) and the point-query forward kernel (K5):
`python3 -m nope_nerf_torch.tools.trunk_ablation` from the root of a checkout,
on a machine with one NVIDIA GPU.

It builds the two kernels as they are and in three ablated variants, each with
one part of the work taken out (their outputs are wrong; only their times
count):
- `noload`: the producer arrives on each ring stage without copying the weight
  slice, so no weight byte moves from L2 (the consumers multiply whatever the
  stage holds);
- `noepi`: the layer epilogues store no activation (bias, ReLU and rounding
  still run);
- `noenc`: the encoders write each coordinate in place of its sine and cosine.
A part whose removal leaves the time unchanged is not on the critical path; the
time a removal saves bounds what any redesign of that part can gain.

Every variant launches through the kernels' C interfaces with the weights
packed once (`pack_tiles`), at the main paths' shapes: one 188x621 frame of
128 samples (K3) and the hierarchical step's 131,072 and 196,608 points (K5),
hidden_dim 256, by CUDA events, the variants in turn, twice. It also times
`point_mlp`'s forward wrapper, which packs the weights on every call, beside
the raw call. Prints the card's name and power limit, one line per variant and
round, and a JSON summary; PERF.md quotes it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..models.nerf import NerfConfig, init_nerf_params
from ..ops import fused_mlp, fused_render
from ..ops._build import BUILD_DIR, CSRC_DIR, CudaLibrary, build_all

FRAME = (188, 621)
SAMPLES = 128
POINTS = (131_072, 196_608)

_LOAD = """      mbar_expect_tx(ring.full + 8 * stage, T::bytes(i));
      bulk_load(ring.base + stage * ring.stride, w + T::offset(i), T::bytes(i),
                ring.full + 8 * stage);"""
_STORES = ("""    *reinterpret_cast<__nv_bfloat162*>(act_wg + swz(row, col, kBlockBytes)) =
        __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(act_wg + swz(row + 8, col, kBlockBytes)) =
        __floats2bfloat162_rn(v2, v3);""",
           # kept only behind a test the values never pass, so the epilogue's
           # arithmetic is not optimised away
           """    if (v0 == 12345.f && v2 == 12345.f)
      *reinterpret_cast<__nv_bfloat162*>(act_wg) = __floats2bfloat162_rn(v1, v3);""")
_TRIG = ("sincosf(coord(p, j % 3) * static_cast<float>(1 << (j / 3)), &sn, &cs);",
         "sn = cs = coord(p, j % 3);")
VARIANTS = {
    "base": [],
    "noload": [(_LOAD, "      mbar_arrive(ring.full + 8 * stage);")],
    "noepi": [_STORES],
    "noenc": [_TRIG],
}


def _variant_libraries(name: str, patches):
    """(K3 library, K5 library) built from the header with `patches` applied,
    in a directory of its own (a source's own directory comes first in the
    include search)."""
    header = (CSRC_DIR / "mlp_fwd_sm90.cuh").read_text()
    for old, new in patches:
        if old not in header:
            raise RuntimeError(f"variant {name}: the trunk no longer has the code it ablates")
        header = header.replace(old, new)
    d = BUILD_DIR / "trunk_ablation" / name
    d.mkdir(parents=True, exist_ok=True)
    # every header beside the variant's, so that each include (the headers include
    # one another) finds the variant
    for other in CSRC_DIR.glob("*.cuh"):
        (d / other.name).write_text(other.read_text())
    (d / "mlp_fwd_sm90.cuh").write_text(header)
    libs = []
    for source, setup in (("render_fwd.cu", fused_render._setup),
                          ("point_mlp_fwd.cu", fused_mlp._setup_fwd)):
        # the variant's name in the source keeps its library apart from the others'
        (d / source).write_text(f"// trunk variant: {name}\n" + (CSRC_DIR / source).read_text())
        libs.append(CudaLibrary(str(d / source), setup))
    return libs


def _time_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("trunk_ablation: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {name: _variant_libraries(name, patches) for name, patches in VARIANTS.items()}
    build_all([lib for pair in libs.values() for lib in pair])

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cfg = NerfConfig(hidden_dim=256, use_pallas=True)
    params = init_nerf_params(cfg, gen, device=dev)
    n = FRAME[0] * FRAME[1]
    v = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    rays = fused_render.pack_rays(torch.randn(n, 3, generator=gen) * 3.0, v, -v).to(dev)
    z = torch.sort(0.01 + 9.99 * torch.rand(n, SAMPLES, generator=gen), dim=1).values.to(dev)
    tiles, biases = fused_render.pack_tiles(params, cfg)
    bptrs = (ctypes.c_void_p * 12)(*[b.data_ptr() for b in biases])
    rgb, dist = torch.empty(n, 3, device=dev), torch.empty(n, device=dev)
    points = {}
    for m in POINTS:
        pts = (torch.randn(m, 3, generator=gen) * 1.5).to(dev)
        dirs = torch.nn.functional.normalize(torch.randn(m, 3, generator=gen), dim=1).to(dev)
        points[m] = (pts, dirs, torch.empty(m, 3, device=dev), torch.empty(m, 1, device=dev))
    stream = torch.cuda.current_stream().cuda_stream

    def k3(lib):
        # no spill scratch: at SAMPLES every per-sample array fits in shared memory
        err = lib.nerf_render_fwd(rays.data_ptr(), z.data_ptr(), tiles.data_ptr(), bptrs,
                                  rgb.data_ptr(), dist.data_ptr(), None, None, None, n, SAMPLES,
                                  256, 1, 0, 0, stream)
        if err:
            raise RuntimeError(lib.nerf_error_string(err).decode())

    def k5(lib, m):
        pts, dirs, prgb, pden = points[m]
        # no staging: the trunk at 256 keeps every layer in shared memory
        err = lib.nerf_point_mlp_fwd(pts.data_ptr(), dirs.data_ptr(), tiles.data_ptr(), bptrs,
                                     prgb.data_ptr(), pden.data_ptr(), None, m, 256, 1, 0, stream)
        if err:
            raise RuntimeError(lib.nerf_error_string(err).decode())

    summary = {name: {"k3_ms": [], **{f"k5_{m}_ms": [] for m in POINTS}} for name in libs}
    for rnd in range(2):
        for name, (l3, l5) in libs.items():
            lib3, lib5 = l3.lib(), l5.lib()
            row = summary[name]
            row["k3_ms"].append(_time_ms(lambda: k3(lib3), 3))
            for m in POINTS:
                row[f"k5_{m}_ms"].append(_time_ms(lambda: k5(lib5, m), 10))
            print(f"round {rnd} {name}: K3 {row['k3_ms'][-1]:.2f} ms per frame, K5 "
                  + ", ".join(f"{row[f'k5_{m}_ms'][-1]:.3f} ms at {m}" for m in POINTS),
                  flush=True)
    wrapper = {m: _time_ms(lambda: fused_mlp._mlp_fwd_cuda(params, *points[m][:2], cfg), 10)
               for m in POINTS}
    print("point_mlp forward wrapper (packs the weights every call): "
          + ", ".join(f"{wrapper[m]:.3f} ms at {m}" for m in POINTS))
    print(json.dumps({"variants": summary, "wrapper_ms": wrapper,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
