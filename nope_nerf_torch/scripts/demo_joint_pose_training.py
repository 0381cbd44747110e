"""Quality demonstration: joint NeRF + pose optimisation from identity pose
initialisation (no GT poses) with the full NoPe-NeRF loss stack, the core
capability (BASELINE.json north star). Prints PSNR and ATE over training.

Counterpart of scripts/demo_joint_pose_training.py: the same config
overrides, the synthetic scene, Trainer.step per batch of
data.frame_iterator (seeded by the epoch), ATE from pose_c2w_all and
full_pose_evaluation every 50 epochs and at the end. The script's constants
are flags with its values as defaults. Runs on the CUDA device unless given
`--device cpu`.

Run:  python -m nope_nerf_torch.scripts.demo_joint_pose_training [--epochs 400]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device


def main(argv: Optional[List[str]] = None,
         overrides: Optional[Dict] = None) -> Dict[str, Dict[str, float]]:
    """Train, printing as the root script does; returns the initial and final
    pose metrics ({"initial": ..., "final": ...}). `overrides` (Python only)
    is merged over the script's config, as for a narrower model."""
    from ..config import load_config, update_recursive
    from ..data import SceneData, frame_iterator, make_synthetic_scene
    from ..evaluation.pose_eval import full_pose_evaluation
    from ..models.poses import pose_c2w_all
    from ..training import ModelConfigs, Trainer, create_train_state
    from ..utils.metrics import mse2psnr

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config(overrides={
        "training": {"n_training_points": 1024},
        "pose": {"learn_pose": True, "init_pose": False},  # start from identity!
        "tpu": {"use_pallas_renderer": True},
    })
    update_recursive(cfg, overrides or {})
    scene = SceneData.from_dict(dict(make_synthetic_scene(
        n_frames=args.frames, h=args.height, w=args.width))).to_device(dev)
    mc = ModelConfigs.from_cfg(cfg, num_cams=args.frames)
    state = create_train_state(0, mc, device=dev)
    trainer = Trainer(cfg, mc)

    gt = np.asarray(scene.c2ws_gt.cpu())

    def ate_now():
        with torch.no_grad():
            learned = pose_c2w_all(state.params["pose"], mc.pose).cpu().numpy()
        return full_pose_evaluation(learned, gt)

    m0 = ate_now()
    print(f"initial: ATE_t {m0['ate_trans']:.4f} m, ATE_r {m0['ate_r_v2_deg']:.3f} deg",
          flush=True)

    t0 = time.time()
    last = args.epochs - 1
    for ep in range(args.epochs):
        l2s = []
        for batch in frame_iterator(scene, seed=ep):
            state, ld = trainer.step(state, batch, ep, scheduling_start=10000)
            l2s.append(ld["l2_mean"])
        if ep % 50 == 0 or ep == last:
            m = ate_now()
            psnr = float(mse2psnr(float(torch.stack(l2s).mean())))
            print(f"ep {ep:4d}: PSNR {psnr:6.2f}  "
                  f"ATE_t {m['ate_trans']:.4f}  ATE_r {m['ate_r_v2_deg']:.3f}deg  "
                  f"pc {float(ld['loss_pc']):.4f} rgb_s {float(ld['loss_rgb_s']):.4f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    m1 = ate_now()
    print(f"final: ATE_t {m1['ate_trans']:.4f} m ({m0['ate_trans']:.4f} init), "
          f"ATE_r {m1['ate_r_v2_deg']:.3f} deg ({m0['ate_r_v2_deg']:.3f} init)")
    return {"initial": m0, "final": m1}


if __name__ == "__main__":
    main()
