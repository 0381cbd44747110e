"""Write SIMULATED non-metric monocular depth priors for the demo scene:
per-frame affine corruptions of the GT depths, saved in the DPT-npz layout
(`<scene>/<depth_net>/depth_<frame>.npz['pred']`).

Counterpart of scripts/make_nonmetric_priors.py, with its flags, its
np.random.RandomState(seed) draws and its npz layout; the 16-bit depth PNGs
are read with data/image_io.py::read_png. depth'_i = a_i*d_i + b_i with random
per-frame a_i, b_i: the regime per-frame scale/shift learning exists for.
Train with `dataloading.with_depth: false`, `dataloading.depth_net: dptsim`,
`dataloading.norm_depth: true` (configs/demo_drive_npz_{dist,nodist}.yaml).

Run after make_demo_scene:  python -m nope_nerf_torch.scripts.make_nonmetric_priors
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional

import numpy as np

from ..data.image_io import read_png


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="data/demo/drive")
    ap.add_argument("--out-name", default="dptsim")
    ap.add_argument("--depth-scale", type=float, default=0.01,
                    help="png-unit -> metres (V-KITTI cm convention)")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    out_dir = os.path.join(args.scene, args.out_name)
    os.makedirs(out_dir, exist_ok=True)
    pngs = sorted(glob.glob(os.path.join(args.scene, "depth", "*.png")))
    if not pngs:
        raise FileNotFoundError(f"no depth pngs under {args.scene}/depth")
    for p in pngs:
        frame = os.path.splitext(os.path.basename(p))[0]
        d = read_png(p).astype(np.float32) * args.depth_scale  # metres
        a = float(rng.uniform(0.6, 1.6))
        b = float(rng.uniform(-1.0, 1.0))
        pred = a * d + b
        np.savez(os.path.join(out_dir, f"depth_{frame}.npz"), pred=pred.astype(np.float32))
        print(f"{frame}: a={a:.3f} b={b:+.3f} range "
              f"[{pred.min():.2f}, {pred.max():.2f}] m")
    print(f"wrote {len(pngs)} simulated non-metric priors to {out_dir}")


if __name__ == "__main__":
    main()
