"""Where a tile's time goes in the frozen-network backward kernels, K4's
(csrc/render_bwd_frozen.cu) and K6's (csrc/point_mlp_bwd_frozen.cu), both on
the wgmma dX chain of csrc/mlp_dx_sm90.cuh:
`python3 -m nope_nerf_torch.tools.frozen_profile` from the root of a
checkout, on a machine with one NVIDIA GPU.

It builds a copy of each kernel with clock64() markers between its phases
(the forward tile and its parts, the composite, the rgb head's backward,
each dX layer group, the g4 round trip, the encoding VJP, ...), written by
consumer thread 0 of CTA 0 for each ray or pass that CTA takes. The markers
change no value: the instrumented kernels' outputs are held bit-equal to the
kernels' own. It prints, at the main paths' shapes (K4: 1024 rays x 128
samples, K6: 196,608 points, hidden_dim 256), the mean cycles of each phase
over CTA 0's rays or passes (its first one left out: it includes the ring's
start), the cycles of a whole ray or pass, and the times of both builds by
CUDA events; then a JSON summary. PERF.md quotes it.
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

RAYS, SAMPLES, POINTS = 1024, 128, 196_608
SLOTS = 32               # markers per ray or pass
MAX_ITEMS = 1600         # rays or passes of CTA 0 kept

# Marker slots, in the order a ray (K4) or a pass (K6) reaches them.
_PRELUDE = f"""__device__ unsigned long long g_marks[{MAX_ITEMS} * {SLOTS}];
__device__ int g_item;
#define MARK(i)                                                                   \\
  do {{                                                                           \\
    if (threadIdx.x == 0 && blockIdx.x == 0 && g_item < {MAX_ITEMS})             \\
      g_marks[g_item * {SLOTS} + (i)] = clock64();                                \\
  }} while (0)
#define ITEM(k)                                                                   \\
  do {{                                                                           \\
    if (threadIdx.x == 0 && blockIdx.x == 0) g_item = static_cast<int>(k);        \\
  }} while (0)
"""
_EPILOGUE = f"""
extern "C" int marks_copy(void* dst) {{
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks), 0,
                                               cudaMemcpyDeviceToDevice));
}}
"""

# (anchor, text, before): the text goes before the anchor when `before`, else after it.
# The forward (mlp_fwd_sm90.cuh's mlp_tile_masks), then the dX chain (mlp_dx_sm90.cuh).
_FORWARD = [
    ("  mbar_wait(hand.pe_full, parity);\n  save(0, wg);\n  {", "\n    MARK(1);", False),
    ("    store_relu<D, MASKS>(acc, act_g, masks);\n    wg_sync(wg);", "\n    MARK(2);", False),
    ("      store_relu<D, MASKS>(acc, act_g, masks + l * LW);\n      wg_sync(wg);",
     "\n      if (l == 4) MARK(3);", False),
    ("    store_act<D, false>(acc, act_g);\n    wg_sync(wg);", "\n    MARK(4);", False),
    ("  head90<D / 2>(act_s, rgb_w, b[11], hout_wg, 0, 3);", "\n  MARK(5);", False),
]
_HEADER = [
    ("  dx_layer<H, D, false, false, false>(act_g, act_s, ring, nullptr, nullptr, nullptr, nullptr);",
     "\n  MARK(20);", False),
    ("#pragma unroll 1\n  for (int l = 7; l >= 1; --l) {", "  MARK(21);\n", True),
    ("  __threadfence_block();   // g4's", "  MARK(22);\n", True),
    ("  ring_products<64>(dpe, act_s, D / 64, 4, ring);   // g0 W0", "\n  MARK(23);", False),
    ("    fence_proxy_async();\n  }\n  wg_sync(wg);", "\n  MARK(24);", False),
    ("  block_sum90<6>(sums, red);\n  if (tid < 6) rsum[tid] += red[tid];", "  MARK(26);\n", True),
]
_K4 = [
    ("    consumer_sync();   // the previous ray is done with every buffer",
     "\n    ITEM((r - blockIdx.x) / gridDim.x);\n    MARK(0);", False),
    ("    // ---- forward: every tile's raw heads", "    MARK(10);\n", True),
    ("    composite_fwd90(hout, fz, alpha,", "    MARK(6);\n", True),
    ("    // ---- heads -> MLP -> encoding, tile by tile", "    MARK(11);\n", True),
    ("      rgb_head_bwd<D>(base + L.act, grgb", "      MARK(12);\n", True),
    ("      float dpe[32];", "      MARK(13);\n", True),
    ("      dx_chain<D>(dpe, base + L.act, ring, masks, gsbf, dens_head, save);", "\n      MARK(25);",
     False),
    ("    // ---- direction encoding, once per ray", "    MARK(27);\n", True),
    ("    if (tid < 9) drays[r * 9 + tid] = rsum[tid];", "    MARK(28);\n", True),
]
_K6 = [
    ("    const int n = static_cast<int>(M - p0 < kPts ? M - p0 : kPts);\n    mlp_tile_masks",
     "    ITEM((pass - blockIdx.x) / gridDim.x);\n    MARK(0);\n", True),
    ("    consumer_sync();   // both warpgroups' raw heads are in", "\n    MARK(6);", False),
    ("    rgb_head_bwd<D>(base + L.act, grgb, mask_h, rgb_head, nullptr, nullptr);",
     "    MARK(12);\n", True),
    ("    {  // d(directions)", "    MARK(13);\n", True),
    ("    float dpe[32];", "    MARK(14);\n", True),
    ("    coord_grad90<8>(dpe, pts, 10, n, p0, dpts);", "\n    MARK(26);", False),
]
_FORWARD_PHASES = [
    ("forward: layer 0", 1, 2),
    ("forward: layers 1-4 and the skip", 2, 3),
    ("forward: layers 5-7, density head, feat", 3, 4),
    ("forward: rgb hidden, rgb head", 4, 5),
    ("forward: both warpgroups in", 5, 6),
]
_CHAIN = [
    ("dX: w10 with the rank-1 term", 20, 21),
    ("dX: trunk w8..w1 (7 layers)", 21, 22),
    ("dX: g0 W0", 22, 23),
    ("dX: g4 back from L2", 23, 24),
]
# (name, first slot, last slot) of each phase of a ray (K4) or a pass (K6)
_K4_PHASES = ([("start of the ray: z, ray, w12 staged, per-ray bias", 0, 10),
               ("forward: wait for the encodings", 10, 1)] + _FORWARD_PHASES
              + [("composite forward and backward", 6, 11), ("the tile's bf16 graw", 11, 12),
                 ("rgb head backward (scalar)", 12, 13), ("dX: w11", 13, 20)] + _CHAIN
              + [("dX: g4 W5", 24, 25), ("encoding VJP to the ray and dz", 25, 26),
                 ("per-ray sums", 26, 27), ("direction's dde", 27, 28)])
_K6_PHASES = ([("forward: wait for the encodings", 0, 1)] + _FORWARD_PHASES
              + [("head VJP", 6, 12), ("rgb head backward (scalar)", 12, 13),
                 ("direction product and its encoding VJP", 13, 14), ("dX: w11", 14, 20)]
              + _CHAIN + [("dX: g4 W5, encoding VJP to the points", 24, 26)])


def _patched(text: str, patches, what: str) -> str:
    for anchor, add, before in patches:
        if anchor not in text:
            raise RuntimeError(f"{what}: the kernel no longer has the code a marker follows:\n"
                               f"{anchor}")
        text = text.replace(anchor, add + anchor if before else anchor + add, 1)
    return text


def _libraries():
    """(K4 library, K6 library) built from marked copies of the sources."""
    d = BUILD_DIR / "frozen_profile"
    d.mkdir(parents=True, exist_ok=True)
    for header in CSRC_DIR.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    (d / "mlp_fwd_sm90.cuh").write_text(
        _patched((CSRC_DIR / "mlp_fwd_sm90.cuh").read_text(), _FORWARD, "mlp_fwd_sm90.cuh"))
    (d / "mlp_dx_sm90.cuh").write_text(
        _patched((CSRC_DIR / "mlp_dx_sm90.cuh").read_text(), _HEADER, "mlp_dx_sm90.cuh"))

    def marked(source, patches, setup):
        text = _patched((CSRC_DIR / source).read_text(), patches, source)
        first = text.index('#include "')   # the markers before every header
        text = text[:first] + _PRELUDE + text[first:]
        (d / source).write_text("// phase markers\n" + text + _EPILOGUE)

        def set_up(lib):
            setup(lib)
            lib.marks_copy.argtypes = [ctypes.c_void_p]
            lib.marks_copy.restype = ctypes.c_int
        return CudaLibrary(str(d / source), set_up)

    return (marked("render_bwd_frozen.cu", _K4, fused_render._setup_bwd_frozen),
            marked("point_mlp_bwd_frozen.cu", _K6, fused_mlp._setup_bwd_frozen))


def _time_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _phases(lib, phases, items: int, dev):
    """Mean cycles of each phase over CTA 0's items 1..items-1, and of a whole
    item (from one item's start to the next's)."""
    marks = torch.zeros(MAX_ITEMS * SLOTS, dtype=torch.int64, device=dev)
    if lib.marks_copy(marks.data_ptr()) != 0:
        raise RuntimeError("could not read the markers back")
    m = marks.view(MAX_ITEMS, SLOTS)[:items].cpu().tolist()
    out = {name: sum(m[k][b] - m[k][a] for k in range(1, items)) / (items - 1)
           for name, a, b in phases}
    out["whole"] = sum(m[k + 1][0] - m[k][0] for k in range(1, items - 1)) / (items - 2)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("frozen_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    k4, k6 = _libraries()
    build_all([k4, k6, fused_render.RENDER_BWD_FROZEN, fused_mlp.POINT_MLP_BWD_FROZEN])

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    cfg = NerfConfig(hidden_dim=256, use_pallas=True)
    params = init_nerf_params(cfg, gen, device=dev)
    params["density_b"] = params["density_b"] - 4.0    # transmittance to the last sample
    v = torch.nn.functional.normalize(torch.randn(RAYS, 3, generator=gen), dim=1)
    rays = fused_render.pack_rays(torch.randn(RAYS, 3, generator=gen) * 0.5, v, -v).to(dev)
    z = torch.sort(0.1 + 5.9 * torch.rand(RAYS, SAMPLES, generator=gen), dim=1).values.to(dev)
    g_rgb = (1e-3 * torch.randn(RAYS, 3, generator=gen)).to(dev)
    g_dist = (1e-3 * torch.randn(RAYS, generator=gen)).to(dev)
    pts = (torch.randn(POINTS, 3, generator=gen) * 1.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(POINTS, 3, generator=gen), dim=1).to(dev)
    p_rgb = (1e-6 * torch.randn(POINTS, 3, generator=gen)).to(dev)
    p_den = torch.full((POINTS, 1), 0.1 / POINTS, device=dev)
    tiles, tiles_dx, _B, bptrs = fused_render._packed_tiles_on(params, cfg, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    passes = -(-POINTS // 128)
    k4_ctas, k6_ctas = min(RAYS, sms), min(passes, sms)
    scratch = torch.empty((max(k4_ctas, k6_ctas), 128, 256), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run_k4(lib):
        drays, dz = torch.empty(RAYS, 9, device=dev), torch.empty(RAYS, SAMPLES, device=dev)
        err = lib.nerf_render_bwd_frozen(
            rays.data_ptr(), z.data_ptr(), g_rgb.data_ptr(), g_dist.data_ptr(), None, None,
            tiles.data_ptr(), tiles_dx.data_ptr(), bptrs, scratch.data_ptr(), None,
            drays.data_ptr(), dz.data_ptr(), RAYS, SAMPLES, 256, k4_ctas, 1, 0, 0, stream)
        if err:
            raise RuntimeError(lib.nerf_error_string(err).decode())
        return drays, dz

    def run_k6(lib):
        dp, dd = torch.empty(POINTS, 3, device=dev), torch.empty(POINTS, 3, device=dev)
        err = lib.nerf_point_mlp_bwd_frozen(
            pts.data_ptr(), dirs.data_ptr(), p_rgb.data_ptr(), p_den.data_ptr(), tiles.data_ptr(),
            tiles_dx.data_ptr(), bptrs, scratch.data_ptr(), dp.data_ptr(), dd.data_ptr(), POINTS,
            256, k6_ctas, 1, 0, stream)
        if err:
            raise RuntimeError(lib.nerf_error_string(err).decode())
        return dp, dd

    summary = {}
    for name, run, marked, real, phase_list, items in (
            ("render_bwd_frozen", run_k4, k4, fused_render.RENDER_BWD_FROZEN, _K4_PHASES,
             -(-RAYS // k4_ctas)),
            ("point_mlp_bwd_frozen", run_k6, k6, fused_mlp.POINT_MLP_BWD_FROZEN, _K6_PHASES,
             -(-passes // k6_ctas))):
        lib, own = marked.lib(), real.lib()
        same = all(torch.equal(a, b) for a, b in zip(run(lib), run(own)))
        ms = _time_ms(lambda: run(own), 10)
        marked_ms = _time_ms(lambda: run(lib), 10)
        run(lib)
        torch.cuda.synchronize()
        phases = _phases(lib, phase_list, items, dev)
        print(f"{name}: {ms:.3f} ms as built, {marked_ms:.3f} ms with the markers; outputs "
              f"bit-equal: {same}; CTA 0's {items} {'rays' if name.startswith('render') else 'passes'}, "
              f"mean cycles per phase:")
        for phase, cycles in phases.items():
            print(f"  {phase:48s} {cycles:10.0f}")
        summary[name] = {"ms": ms, "marked_ms": marked_ms, "bit_equal": same, "cycles": phases}
        if not same:
            raise RuntimeError(f"{name}: the markers changed the outputs")
    print(json.dumps({"kernels": summary, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
