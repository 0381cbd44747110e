"""What holds back K6 full (csrc/point_mlp_bwd.cu, the point-query MLP
backward with every weight gradient):
`python3 -m nope_nerf_torch.tools.k6_ablation` from the root of a checkout,
on a machine with one NVIDIA GPU.

It builds the kernel as it is and in variants with one part of the work taken
out or changed (the outputs of all but `sync` are wrong; only their times
count):
- `sync`: the operand tiles written by the warpgroups' own 16-byte stores
  instead of bulk copies;
- `nox`: no X operand (pe, x0..x7, feat, de) leaves shared memory;
- `nog`: no G operand (g_h, g_feat, g7..g0) leaves shared memory;
- `nosum`: the dX epilogues form no bias column sums and fold none;
- `now9`: the chain does not read x7 back for dW[9];
- `bare`: `nox`, `nog`, `nosum` and `now9` together: what is left of the
  chain besides the frozen variant's work;
- `nodw`: the weight-gradient kernel is not launched (the chain and its
  partial sums only).
A part whose removal leaves the time unchanged is not on the critical path;
the time a removal saves bounds what any redesign of that part can gain.

Every variant launches through the kernel's C interface with the weights
packed once, at the hierarchical step's fine pass: 196,608 points, hidden_dim
256, by CUDA events, the variants in turn, twice; the frozen-network variant
(the same chain without any weight-gradient work) is timed beside them.
Prints the card's name and power limit, one line per variant and round, and
a JSON summary; PERF.md quotes it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..models.nerf import NerfConfig, init_nerf_params
from ..ops import fused_mlp
from ..ops._build import BUILD_DIR, CSRC_DIR, CudaLibrary, build_all
from ..ops.fused_render import _backward_ctas, _packed_tiles_on

POINTS = 196_608

_X_SAVE = """    if (i == 8)
      copy_rows(src, dst, Operands<D>::xblocks(i));
    else
      copy_rows_async(src, dst, Operands<D>::xblocks(i));"""
_G_SAVE = """  if (SYNC)
    copy_rows(act_wg, gtile_wg, N / 64);
  else
    copy_rows_async(act_wg, gtile_wg, N / 64);"""
_GH_SAVE = """    copy_rows_async(base + L.act + wg * kWgRowBytes, save.tiles.g(0) + wg * kWgRowBytes,
                    H / 64);   // g_h"""
_NOSUM = [("store_dx<N, MASK, RANK1, false, true>", "store_dx<N, MASK, RANK1, false, false>"),
          ("""  for (int c = threadIdx.x & 127; c < N; c += 128)
    bsum[c] += red_wg[c] + red_wg[N + c] + red_wg[2 * N + c] + red_wg[3 * N + c];""", "")]
_W9 = ("    density_head_dw<D>(save.tiles, gsbf, part0);\n", "")
VARIANTS = {
    "base": [],
    "sync": [(_X_SAVE, "    copy_rows(src, dst, Operands<D>::xblocks(i));"),
             (_G_SAVE, "  copy_rows(act_wg, gtile_wg, N / 64);"),
             (_GH_SAVE, _GH_SAVE.replace("copy_rows_async(", "copy_rows(").replace(
                 "\n                    H / 64", "\n              H / 64"))],
    "nox": [(_X_SAVE, "")],
    "nog": [(_G_SAVE, ""), (_GH_SAVE, "")],
    "nosum": _NOSUM,
    "now9": [_W9],
    "bare": [(_X_SAVE, ""), (_G_SAVE, ""), (_GH_SAVE, "")] + _NOSUM + [_W9],
    "nodw": [("    const cudaError_t err = dw_sm90_launch(tab, M, chunks, dw_part, stream, add);",
              "    const cudaError_t err = cudaSuccess;")],
}


def _variant_library(name: str, patches) -> CudaLibrary:
    """point_mlp_bwd.cu and the hand-off header it includes
    (mlp_dw_chain_sm90.cuh) with `patches` applied, in a directory of their
    own: the source's quoted include finds the patched header beside it."""
    files = {f: (CSRC_DIR / f).read_text() for f in ("point_mlp_bwd.cu", "mlp_dw_chain_sm90.cuh")}
    for old, new in patches:
        hits = [f for f, text in files.items() if old in text]
        if not hits:
            raise RuntimeError(f"variant {name}: the kernel no longer has the code it ablates")
        for f in hits:
            files[f] = files[f].replace(old, new)
    d = BUILD_DIR / "k6_ablation" / name
    d.mkdir(parents=True, exist_ok=True)
    # the variant's name in the source keeps its library apart from the others'
    for f, text in files.items():
        (d / f).write_text(f"// K6 variant: {name}\n" + text)
    return CudaLibrary(str(d / "point_mlp_bwd.cu"), fused_mlp._setup_bwd)


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
        print("k6_ablation: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {name: _variant_library(name, patches) for name, patches in VARIANTS.items()}
    build_all(list(libs.values()) + [fused_mlp.POINT_MLP_BWD_FROZEN])
    for name, lib in list(libs.items()) + [("frozen", fused_mlp.POINT_MLP_BWD_FROZEN)]:
        for line in lib.build_log.splitlines():
            if "spill" in line or ("registers" in line and "barriers" in line):
                print(f"  ptxas {name}:", line.strip())

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    cfg = NerfConfig(hidden_dim=256, use_pallas=True)
    D = cfg.hidden_dim
    params = init_nerf_params(cfg, gen, device=dev)
    pts = (torch.randn(POINTS, 3, generator=gen) * 1.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(POINTS, 3, generator=gen), dim=1).to(dev)
    g_rgb = (torch.randn(POINTS, 3, generator=gen) * 1e-6).to(dev)
    g_den = torch.full((POINTS, 1), 0.1 / POINTS, device=dev)
    tiles, tiles_dx, _b, bptrs = _packed_tiles_on(params, cfg, dev)
    n_ctas = _backward_ctas(-(-POINTS // fused_mlp.PTS_PER_PASS), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    base = libs["base"].lib()
    offsets = (ctypes.c_int * 26)()
    total = base.nerf_point_mlp_grad_layout(D, offsets)
    sizes = (ctypes.c_longlong * 6)()
    base.nerf_point_mlp_bwd_scratch(D, POINTS, n_ctas, sizes)
    chunks = fused_mlp.dw_chunks(sizes[4], POINTS, sms)
    xops, gops = (torch.empty(sizes[i], dtype=torch.uint8, device=dev) for i in (0, 1))
    chain_part = torch.empty(sizes[2] // 4, device=dev)
    dw_part = torch.empty(chunks * sizes[3] // 4, device=dev)
    grads = torch.empty(total, device=dev)
    dpts, ddirs = torch.empty(POINTS, 3, device=dev), torch.empty(POINTS, 3, device=dev)
    scratch = torch.empty((n_ctas, fused_mlp.PTS_PER_PASS, D), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def full(lib):
        err = lib.nerf_point_mlp_bwd(
            pts.data_ptr(), dirs.data_ptr(), g_rgb.data_ptr(), g_den.data_ptr(),
            tiles.data_ptr(), tiles_dx.data_ptr(), bptrs, xops.data_ptr(), gops.data_ptr(),
            chain_part.data_ptr(), dw_part.data_ptr(), None, grads.data_ptr(), dpts.data_ptr(),
            ddirs.data_ptr(), POINTS, D, n_ctas, chunks, 1, 0, total, (ctypes.c_int * 2)(),
            stream)
        if err:
            raise RuntimeError(lib.nerf_error_string(err).decode())

    frozen_lib = fused_mlp.POINT_MLP_BWD_FROZEN.lib()

    def frozen():
        err = frozen_lib.nerf_point_mlp_bwd_frozen(
            pts.data_ptr(), dirs.data_ptr(), g_rgb.data_ptr(), g_den.data_ptr(),
            tiles.data_ptr(), tiles_dx.data_ptr(), bptrs, scratch.data_ptr(), dpts.data_ptr(),
            ddirs.data_ptr(), POINTS, D, n_ctas, 1, 0, stream)
        if err:
            raise RuntimeError(frozen_lib.nerf_error_string(err).decode())

    summary = {name: [] for name in libs}
    summary["frozen"] = []
    for rnd in range(2):
        for name, lib in libs.items():
            loaded = lib.lib()
            summary[name].append(_time_ms(lambda: full(loaded), 10))
            print(f"round {rnd} {name}: {summary[name][-1]:.3f} ms at {POINTS} points", flush=True)
        summary["frozen"].append(_time_ms(frozen, 10))
        print(f"round {rnd} frozen-network variant: {summary['frozen'][-1]:.3f} ms", flush=True)
    print(json.dumps({"points": POINTS, "chunks": chunks, "variants_ms": summary,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
