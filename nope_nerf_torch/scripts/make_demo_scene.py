"""Write the built-in synthetic driving scene to disk as a V-KITTI-format LLFF
scene directory, so the full on-disk pipeline (LLFF ingestion -> train -> eval
-> eval_poses -> render) runs without the real Virtual KITTI download.

Counterpart of scripts/make_demo_scene.py, with its flags and defaults. The
layout is what cli/get_vkitti writes from raw V-KITTI: images/*.png,
depth/*.png (uint16 cm), intrinsics.npz, poses_gt.npy, and a pose-noised
poses_bounds.npy standing in for an imperfect COLMAP reconstruction. Train it
with configs/demo_drive.yaml.

Run:  python -m nope_nerf_torch.scripts.make_demo_scene [--dest data/demo/drive] [--frames 20]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..data import make_driving_scene, write_vkitti_scene


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dest", default="data/demo/drive")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--pose-noise-deg", type=float, default=1.0,
                    help="rotation noise (deg RMS) on the COLMAP-stand-in poses")
    ap.add_argument("--pose-noise-trans", type=float, default=0.05,
                    help="translation noise (m RMS) on the COLMAP-stand-in poses")
    args = ap.parse_args(argv)

    scene = make_driving_scene(n_frames=args.frames, h=args.height, w=args.width)
    write_vkitti_scene(args.dest, scene, pose_noise_deg=args.pose_noise_deg,
                       pose_noise_trans=args.pose_noise_trans)
    print(f"wrote {args.frames}-frame scene to {args.dest} "
          f"(depth range {scene['depths'].min():.2f}-{scene['depths'].max():.1f} m)")


if __name__ == "__main__":
    main()
