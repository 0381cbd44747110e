"""Depth-prior preprocessing CLI: run the frozen DPT over every frame of a scene and
save `<scene>/<depth_net>/depth_<frame>.npz` (`pred`, float32) and a preview PNG.

Port of nope_nerf_tpu/cli/preprocess.py (reference preprocess/dpt_depth.py:13-46).
The frames come through data/fields.py::DataField (mode "all"), each resized
and normalised by data/dpt_transforms.py, and go through models/dpt.py::DPT
one frame per forward under torch.inference_mode(), on CUDA unless the caller
passes `device`. The weights are the config's `depth.path`: an .npz in the JAX
package's layout or the MiDaS torch .pt (models/dpt.py::load_dpt);
`--random-weights` runs the architecture with the JAX package's seeded random
weights, for runs without a checkpoint. The previews go through the port's PNG
writer (the card's machine has no cv2).

Usage: python -m nope_nerf_torch.cli.preprocess <config.yaml> [--random-weights]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import DeviceLike, resolve_device


def preprocess(cfg: dict, random_weights: bool = False, scene=None,
               device: DeviceLike = None) -> str:
    """Write the DPT depth prior of every frame of cfg's scene (or of an
    injected SceneData `scene`, named 0000.png, ... and written to
    dataloading.path); returns the output directory."""
    from ..data.dpt_transforms import prepare_dpt_input
    from ..data.image_io import write_png
    from ..models.dpt import DPTConfig, init_dpt_params, load_dpt, make_dpt

    dev = resolve_device(device)
    dcfg = DPTConfig.from_cfg(cfg)
    if random_weights:
        model = make_dpt(init_dpt_params(dcfg), dcfg, dev)
    else:
        model, dcfg = load_dpt(cfg["depth"]["path"], dcfg, dev)

    if scene is None:
        from ..data import DataField
        field = DataField.from_cfg(cfg, mode="all")
        scene = field.scene
        img_list = field.img_list
        out_dir = os.path.join(field.load_dir, cfg["dataloading"]["depth_net"])
    else:
        img_list = [f"{i:04d}.png" for i in range(scene.n_frames)]
        out_dir = cfg["dataloading"]["path"]
    os.makedirs(out_dir, exist_ok=True)

    with torch.inference_mode():
        for i in range(scene.n_frames):
            inp = torch.from_numpy(prepare_dpt_input(scene.imgs[i])).permute(2, 0, 1)[None]
            depth = model(inp.to(dev))[0].cpu().numpy()
            frame_id = img_list[i].split(".")[0]
            np.savez(os.path.join(out_dir, f"depth_{frame_id}.npz"),
                     pred=depth.astype(np.float32))
            vis = np.clip(255.0 / max(depth.max(), 1e-6) * (depth - depth.min()),
                          0, 255).astype(np.uint8)
            write_png(os.path.join(out_dir, f"depth_{frame_id}.png"), vis)
            print(f"  {frame_id}: depth {depth.shape} "
                  f"[{depth.min():.3f}, {depth.max():.3f}]")
    print(f"wrote {scene.n_frames} depth priors to {out_dir}")
    return out_dir


def main():
    parser = argparse.ArgumentParser(description="Precompute DPT depth priors")
    parser.add_argument("config", nargs="?", default=None)
    parser.add_argument("--random-weights", action="store_true",
                        help="run with random DPT weights (no checkpoint needed)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    args = parser.parse_args()
    from ..config import load_config
    preprocess(load_config(args.config), random_weights=args.random_weights,
               device=args.device)


if __name__ == "__main__":
    main()
