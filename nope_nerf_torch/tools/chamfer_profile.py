"""Where the two Chamfer sweeps' time goes on the card, and their issue floors.

    python3 nope_nerf_torch/tools/chamfer_profile.py [--root CHECKOUT]

from the root of a checkout, on a machine with one NVIDIA GPU. `--root`
profiles the `nope_nerf_torch` of another checkout (another commit, unpacked
with `git archive`) with this script, so two commits are held to one
yardstick in one run; this file needs only the standard library and torch.
Run it as a file, not with -m: the package under test is imported from the
root given.

For K2 (`nearest_idx_bidirectional`, the train step's 7,285 x 7,285
depth-lifted clouds) and K7 (`nearest_idx`, one direction at the fern and
Tanks steps' 47,628- and 32,400-point clouds and at 5 x 40,000) it prints:
the wrapper's time by CUDA events; from torch.profiler, every device kernel
one wrapper call launches, with its device time per call, and the device
launches per call; the instructions per pair of the sweep's hot loop, from
`cuobjdump -sass` of the built library, and the issue floor they give at that
size; ptxas's register and spill lines. For this checkout (no `--root`, or
its own) also the bare C calls at other launch geometries than ops/chamfer.py
picks, the wrappers' host time, and K2's variants (K2_VARIANTS) in turn.

The issue floor: an H100 SXM issues at most 4 warp-instructions a clock on
each of its 132 SMs, at 1.98 GHz, so a kernel that spends n instructions on
each of P pairs, 32 pairs to a warp-instruction, takes at least
n x P / 32 / (132 x 4 x 1.98e9) seconds. The hot loop is the loop of the
sweep kernel with the most pair markers per instruction (one FSETP per pair
in K7: its compare; one FMNMX per pair in K2: the clamp of d2 at 0), so its
length over its markers counts the loop's own overhead too.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ISSUE_RATE = 132 * 4 * 1.98e9    # warp-instructions a second, H100 SXM at its boost clock
# (kernel names, old and new, in the library; the marker instruction of one pair)
SWEEPS = {"chamfer_bidir": (("chamfer_bidir_sweep", "chamfer_bidir_kernel"), "FMNMX"),
          "chamfer_nearest": (("chamfer_nearest_sweep", "chamfer_nearest_kernel"), "FSETP")}
REPS = 20

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def sass_functions(sass: str) -> Dict[str, List[Tuple[int, str]]]:
    """cuobjdump -sass text -> {mangled function name: [(address, instruction)]}."""
    out: Dict[str, List[Tuple[int, str]]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(instr: str) -> str:
    """'@!P0 FSETP.GEU.AND P0, PT, R1, R2' -> 'FSETP'."""
    words = instr.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def hot_loop(instrs: List[Tuple[int, str]], marker: str, min_markers: int = 4):
    """The loop (a backward branch and the instructions from its target to it)
    with the most `marker` instructions per instruction, among loops with at
    least `min_markers` of them: (instructions, markers, opcode counts), or
    None."""
    best = None
    addrs = [a for a, _ in instrs]
    for a, ins in instrs:
        if opcode(ins) != "BRA":
            continue
        m = _TARGET.search(ins.split("BRA", 1)[1])
        if not m or int(m.group(1), 16) >= a:
            continue
        lo = addrs.index(int(m.group(1), 16)) if int(m.group(1), 16) in addrs else None
        if lo is None:
            continue
        body = [opcode(i) for b, i in instrs[lo:] if b <= a]
        n_mark = body.count(marker)
        if n_mark < min_markers:
            continue
        key = (n_mark / len(body), n_mark)
        if best is None or key > best[0]:
            counts: Dict[str, int] = {}
            for op in body:
                counts[op] = counts.get(op, 0) + 1
            best = (key, (len(body), n_mark, counts))
    return best[1] if best else None


def cuobjdump() -> Optional[str]:
    from nope_nerf_torch.ops._build import find_nvcc
    beside = Path(find_nvcc()).parent / "cuobjdump"
    return str(beside) if beside.exists() else shutil.which("cuobjdump")


def sweep_instructions_per_pair(library, name: str):
    """(instructions per pair of the sweep's hot loop, instructions, markers,
    the loop's five commonest opcodes) for a built CudaLibrary of SWEEPS
    `name`; None where cuobjdump or the loop is not found."""
    from nope_nerf_torch.ops._build import find_nvcc
    tool = cuobjdump()
    if tool is None:
        return None
    so = library._target(find_nvcc())
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    kernels, marker = SWEEPS[name]
    for fname, instrs in sass_functions(sass).items():
        if any(k in fname for k in kernels):
            loop = hot_loop(instrs, marker)
            if loop is None:
                return None
            n, n_mark, counts = loop
            common = sorted(counts.items(), key=lambda kv: -kv[1])[:5]
            return n / n_mark, n, n_mark, common
    return None


def issue_floor_ms(per_pair: float, pairs: int) -> float:
    return per_pair * pairs / 32 / ISSUE_RATE * 1e3


def _self_device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    raise AttributeError("the profiler event carries no device time")


def profile_call(torch, fn, reps: int = REPS):
    """(wrapper ms by CUDA events, device ms per call, device launches per
    call, [(kernel, launches per call, device us per call)]) over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count / reps, _self_device_us(e) / reps) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    rows.sort(key=lambda r: -r[2])
    return (wall, sum(r[2] for r in rows) / 1e3, sum(r[1] for r in rows), rows)


def _events_ms(torch, fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def geometry_sweep(torch, C, cases) -> None:
    """The bare C call of each kernel at other launch geometries than
    nearest_geometry / bidir_geometry pick (K2: sub-tiles per segment; K7: the
    segment length), by CUDA events; and the wrappers' host time per call
    (host clock over calls that queue without waiting)."""
    import time
    for name, label, fn, (x, y) in cases:
        x, y = x.contiguous(), y.contiguous()
        s, d = x.shape[0], y.shape[0]
        if name == "chamfer_bidir":
            _, scratch, out = C._bidir_buffers(x, y)
            options = []
            for sub in range(1, C.BIDIR_SUB_MAX + 1):
                g = C.BidirGeometry(C.BIDIR_X_TILE, C.BIDIR_Y_TILE, -(-s // C.BIDIR_X_TILE), sub,
                                    -(-(-(-d // C.BIDIR_Y_TILE)) // sub))
                scr = torch.empty((g.scratch(s, d),), dtype=torch.int32, device=x.device)
                ms = _events_ms(torch, lambda: C._bidir_launch(x, y, g, scr, out))
                options.append(f"{sub} sub-tiles ({g.blocks} blocks) {ms * 1e3:.1f} us")
        else:
            geo, _, _, d2, idx = C._nearest_buffers(x, y)
            options = []
            for seg in sorted({64, 152, 256, 512, 768, 1024, 1536, 2048, geo.seg_len}):
                if seg > d:
                    continue
                g = C.NearestGeometry(geo.src_tile, geo.src_tiles, seg, -(-d // seg))
                if g.n_segs > 65535:
                    continue
                pd = torch.empty((g.scratch(s),), dtype=torch.float32, device=x.device)
                pi = torch.empty((g.scratch(s),), dtype=torch.int32, device=x.device)
                ms = _events_ms(torch, lambda: C._nearest_launch(x, y, g, pd, pi, d2, idx))
                options.append(f"seg {seg} ({g.blocks} blocks) {ms:.4f} ms")
        print(f"{name} {label}, bare C call by geometry: " + "; ".join(options))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn(x, y)
        host_us = (time.perf_counter() - t0) / REPS * 1e6
        torch.cuda.synchronize()
        print(f"  wrapper host time {host_us:.1f} us per call")


_K2_KEYS = """      const int key = __float_as_int(fmaxf(d2, 0.f)) & ~kIdxMask;
      rmin[r] = min(rmin[r], key + yi[c]);
      cmin[c] = min(cmin[c], key + xi[r]);"""
# K2 as built and in variants (source patches): other register tiles and
# occupancy and other forms of the packed key, whose indices must equal the
# build's, and `rows_only`, without the column direction (wrong output, a time
# only)
K2_VARIANTS = {
    "base": [],
    "min_blocks_1": [("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
    "r8c4": [("constexpr int kC = 8;", "constexpr int kC = 4;"),
             ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 3;")],
    "r4c8": [("constexpr int kR = 8;", "constexpr int kR = 4;"),
             ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 3;")],
    "r4c4": [("constexpr int kR = 8;", "constexpr int kR = 4;"),
             ("constexpr int kC = 8;", "constexpr int kC = 4;"),
             ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 4;")],
    "rows_only": [("  const int col = halfwarp_column_min(cmin, lane);",
                   "  (void)cmin;\n  const int col = 0;")],
    # the index ORed into the masked key: nvcc shares the mask and issues two
    # ORs, all three in the logic pipe
    "or": [(_K2_KEYS, """      const int key = __float_as_int(fmaxf(d2, 0.f));
      rmin[r] = min(rmin[r], (key & ~kIdxMask) | yi[c]);
      cmin[c] = min(cmin[c], (key & ~kIdxMask) | xi[r]);""")],
    # each direction's key in one lop3 (mask and index together)
    "lop3": [(_K2_KEYS, """      const int key = __float_as_int(fmaxf(d2, 0.f));
      int kr, kc;
      asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(kr) : "r"(key), "n"(~kIdxMask), "r"(yi[c]));
      asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(kc) : "r"(key), "n"(~kIdxMask), "r"(xi[r]));
      rmin[r] = min(rmin[r], kr);
      cmin[c] = min(cmin[c], kc);""")],
}


def k2_ablation(torch, C, x, y) -> None:
    """Each K2 variant's bare C call at its own tiles, by CUDA events, in turn
    twice, with its indices held against the build's."""
    import ctypes
    import re as _re
    from nope_nerf_torch.ops._build import BUILD_DIR, CSRC_DIR, CudaLibrary
    src = (CSRC_DIR / "chamfer_bidir.cu").read_text()
    libs = {}
    for name, patches in K2_VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        d = BUILD_DIR / "chamfer_ablation" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "chamfer_bidir.cu").write_text(f"// K2 variant: {name}\n" + text)
        kr = int(_re.search(r"constexpr int kR = (\d+);", text).group(1))
        kc = int(_re.search(r"constexpr int kC = (\d+);", text).group(1))
        libs[name] = (CudaLibrary(str(d / "chamfer_bidir.cu"), C._setup), 16 * kr, 16 * kc)
    for name, (lib, _, _) in list(libs.items()):
        try:
            lib.lib()
        except RuntimeError as e:      # a variant that does not build is reported and left out
            print(f"  {name}: build failed: {str(e)[-400:]}")
            del libs[name]
    s, d = x.shape[0], y.shape[0]
    ref = C.nearest_idx_bidirectional(x, y)
    for name, (lib, tx, ty) in libs.items():
        regs = [ln.strip() for ln in lib.build_log.splitlines() if "Used" in ln]
        print(f"  {name}: ptxas {regs}")
    for rnd in range(2):
        for name, (lib, tx, ty) in libs.items():
            xt, yt = -(-s // tx), -(-d // ty)
            sub = max(1, min(C.BIDIR_SUB_MAX, xt * yt // C.TARGET_BLOCKS))
            segs = -(-yt // sub)
            scratch = torch.empty((segs * s + xt * d,), dtype=torch.int32, device=x.device)
            out = torch.empty((s + d,), dtype=torch.int64, device=x.device)
            stream = torch.cuda.current_stream(x.device).cuda_stream

            def call():
                err = lib.lib().chamfer_bidir(x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                                              out.data_ptr(), s, d, tx, ty, sub, stream)
                if err:
                    raise RuntimeError(f"variant {name}: launch failed ({err})")
            ms = _events_ms(torch, call)
            same = torch.equal(out[:s], ref[0]) and torch.equal(out[s:], ref[1])
            print(f"chamfer_bidir variant {name} (tile {tx} x {ty}, {xt * segs} blocks), round "
                  f"{rnd}: bare C call {ms * 1e3:.1f} us, indices equal to the build's {same}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="checkout whose nope_nerf_torch and chip_smoke.py are profiled")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chamfer_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import chip_smoke
    from nope_nerf_torch.ops import chamfer as C
    from nope_nerf_torch.ops._build import build_all
    assert Path(C.__file__).resolve().is_relative_to(root), C.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"profiling {root}")
    build_all((C.CHAMFER_BIDIR, C.CHAMFER_NEAREST))
    for lib in (C.CHAMFER_BIDIR, C.CHAMFER_NEAREST):
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib.source.name}:", line.strip())
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = [("chamfer_bidir", "7285 x 7285", C.nearest_idx_bidirectional,
              chip_smoke.depth_lifted_clouds(torch, dev, gen, 47, 155))]
    for label, (h, w) in (("fern 47628 x 47628", (189, 252)), ("Tanks 32400 x 32400", (135, 240))):
        cases.append(("chamfer_nearest", label, C.nearest_idx,
                      chip_smoke.depth_lifted_clouds(torch, dev, gen, h, w)))
    cases.append(("chamfer_nearest", "5 x 40000", C.nearest_idx,
                  ((torch.rand(5, 3, generator=gen) * 6 - 3).to(dev),
                   (torch.rand(40000, 3, generator=gen) * 6 - 3).to(dev))))
    libs = {"chamfer_bidir": C.CHAMFER_BIDIR, "chamfer_nearest": C.CHAMFER_NEAREST}
    for name, label, fn, (x, y) in cases:
        wall, device_ms, launches, rows = profile_call(torch, lambda: fn(x, y))
        pairs = x.shape[0] * y.shape[0]
        sass = sweep_instructions_per_pair(libs[name], name)
        floor = (f"{sass[0]:.2f} instructions per pair in the hot loop ({sass[1]} for "
                 f"{sass[2]} pairs; " + ", ".join(f"{k} {v}" for k, v in sass[3])
                 + f") -> issue floor {issue_floor_ms(sass[0], pairs):.4f} ms"
                 if sass else "issue floor not measured (no cuobjdump or no loop found)")
        print(f"{name} {label}: wrapper {wall:.4f} ms by CUDA events; device {device_ms:.4f} ms "
              f"in {launches:.0f} launches per call: "
              + "; ".join(f"{k[:60]} x{n:.0f} {us:.1f} us" for k, n, us in rows))
        print(f"  {floor}")
    if root == str(Path(__file__).resolve().parents[2]):
        # the other launch geometries and K2's variants: this checkout's code only
        geometry_sweep(torch, C, cases)
        x, y = cases[0][3]
        k2_ablation(torch, C, x.contiguous(), y.contiguous())
    return 0


if __name__ == "__main__":
    sys.exit(main())
