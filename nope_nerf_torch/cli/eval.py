"""Image/depth evaluation CLI: `python -m nope_nerf_torch.cli.eval <config.yaml> [--synthetic]`.

Port of nope_nerf_tpu/cli/eval.py (reference evaluation/eval.py:29-227): loads
the trained checkpoint (either package's), initializes the test poses
(scale|ate|pre|none), runs test-time pose optimization against the frozen
NeRF, renders each eval view at full resolution, and aggregates PSNR/SSIM and
the 7 depth metrics with the validity confusion matrix into
`extraction/evaluation.txt`; with `save` it also writes the per-view artifact
set (evaluation/artifacts.py: PNGs by the port's own writer; the INFERNO
disparity maps need cv2) and, where imageio is installed, the eval video.
LPIPS (evaluation/lpips.py) runs on the eval device when
`extract_images.lpips_weights` names a weight file, and is n/a without one.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import DeviceLike, resolve_device


def split_synthetic_scene():
    """(train scene, eval scene, sample_rate) of the built-in 8-frame synthetic
    scene: frame 4 is held out, as every 8th frame of a real sequence is."""
    from ..data import SceneData, make_synthetic_scene
    full = dict(make_synthetic_scene(n_frames=8, h=120, w=160))
    ids = np.arange(8)
    i_test = ids[4::8]
    i_train = np.array([i for i in ids if i not in i_test])

    def pick(sel):
        return SceneData.from_dict({k: (v[sel] if k != "K" else v) for k, v in full.items()})

    return pick(i_train), pick(i_test), 8


def evaluate(cfg: dict, synthetic: bool = False, device: DeviceLike = None, save: bool = True):
    """Evaluate cfg's checkpoint on `device` (CUDA unless told otherwise), on
    cfg's scene on disk (its train and eval splits) or with `synthetic` on the
    built-in scene; returns the summary dict. `save=False` writes
    evaluation.txt only."""
    from ..evaluation.image_eval import aggregate_depth_errors, eval_image
    from ..evaluation.lpips import set_lpips_weights
    from ..evaluation.pose_opt import init_test_poses, optimize_test_poses
    from ..models.poses import pose_c2w_all
    from ..training import ModelConfigs, Trainer, create_train_state
    from ..training.checkpoints import load_checkpoint

    dev = resolve_device(device)
    set_lpips_weights(cfg["extract_images"].get("lpips_weights"), dev)
    out_dir = cfg["training"]["out_dir"]
    extraction_dir = os.path.join(out_dir, cfg["extract_images"]["extraction_dir"])
    os.makedirs(extraction_dir, exist_ok=True)

    if synthetic:
        train_scene, eval_scene, sample_rate = split_synthetic_scene()
    else:
        from ..data import DataField
        train_scene = DataField.from_cfg(cfg, mode="train").scene
        eval_scene = DataField.from_cfg(cfg, mode="eval").scene
        sample_rate = cfg["dataloading"]["sample_rate"]
    mc = ModelConfigs.from_cfg(cfg, num_cams=train_scene.n_frames)
    state = create_train_state(
        0, mc, init_c2w=torch.as_tensor(train_scene.c2ws_gt) if cfg["pose"]["init_pose"] else None,
        device=dev)
    loaded = load_checkpoint(out_dir, cfg["training"]["load_dir"], state, load_model_only=True)
    if loaded is None:
        raise FileNotFoundError(f"no checkpoint in {out_dir}")
    state, _ = loaded

    if mc.pose is not None:
        with torch.no_grad():
            learned_train = pose_c2w_all(state.params["pose"], mc.pose).cpu().numpy()
    else:
        learned_train = np.asarray(train_scene.c2ws_gt)

    if cfg["eval_pose"]["type_to_eval"] == "train":
        # evaluate on the train views with the learned poses directly
        # (reference evaluation/eval.py:98-101): no test-pose optimization
        eval_scene = train_scene
        eval_c2ws = learned_train
    else:
        # test views: init and optimize fresh poses against the frozen NeRF
        def init_or_gt(scene):
            return scene.c2ws_init if scene.c2ws_init is not None else scene.c2ws_gt

        init_c2ws = init_test_poses(cfg["eval_pose"]["init_method"], init_or_gt(eval_scene),
                                    learned_train, init_or_gt(train_scene), sample_rate,
                                    eval_scene.n_frames)
        _, eval_c2ws = optimize_test_poses(
            state.params["nerf"], state.params.get("focal"), eval_scene, mc.nerf, mc.render,
            init_c2ws=init_c2ws, fcfg=mc.focal, n_points=cfg["eval_pose"]["n_points"],
            n_epochs=cfg["eval_pose"]["opt_pose_epoch"], lr=cfg["eval_pose"]["opt_eval_lr"],
            device=dev)

    # render and evaluate each view
    trainer = Trainer(cfg, mc)
    h, w = eval_scene.imgs.shape[1:3]
    sc = 1.0
    if eval_scene.reverse is not None:
        # depth -> metric scale ratio (evaluation/eval.py:171-175)
        sc = 1.0 / eval_scene.reverse["sc"]
        if eval_scene.reverse.get("sc_spherify") is not None:
            sc /= eval_scene.reverse["sc_spherify"]

    results = []
    video_frames = []
    min_d, max_d = cfg["eval_pose"]["depth_range"]

    def eval_view(i, out):
        gt_depth = eval_scene.gt_depths[i] if eval_scene.gt_depths is not None else None
        r = eval_image(out["rgb"], eval_scene.imgs[i], out["depth"], gt_depth, sc=sc,
                       min_depth=min_d, max_depth=max_d)
        results.append(r)
        print(f"{i:4d} img: PSNR {r['psnr']:.2f} SSIM {r['ssim']:.3f} "
              f"LPIPS {r['lpips'] if r['lpips'] is not None else 'n/a'}")
        if save:
            # per-view artifact set (model/eval_images.py:109-198); the depth-error
            # scatter only for the first view, as eval.py:179 show_errors=first
            from ..evaluation.artifacts import write_view_artifacts
            video_frames.append(write_view_artifacts(
                extraction_dir, i, out["rgb"], eval_scene.imgs[i],
                depth_out=r.get("depth_out_full"), depth_gt=gt_depth, min_depth=min_d,
                max_depth=max_d, show_errors=(i == 0)))

    # frame i+1's render is queued before frame i's readback and metrics
    pending = None
    ones = np.ones((h, w), np.float32)
    for i in range(eval_scene.n_frames):
        batch = {"img": eval_scene.imgs[i], "depth": ones, "camera_mat": eval_scene.K,
                 "pose_gt": eval_c2ws[i].astype(np.float32), "idx": i}
        out_dev = trainer.render_frame(state, batch, (h, w), use_learned_pose=False, sync=False)
        if pending is not None:
            eval_view(i - 1, trainer.finalize_frame(pending))
        pending = out_dev
    if pending is not None:
        eval_view(eval_scene.n_frames - 1, trainer.finalize_frame(pending))

    summary = {
        "mean_mse": float(np.mean([r["mse"] for r in results])),
        "mean_psnr": float(np.mean([r["psnr"] for r in results])),
        "mean_ssim": float(np.mean([r["ssim"] for r in results])),
    }
    if all(r["lpips"] is not None for r in results):
        summary["mean_lpips"] = float(np.mean([r["lpips"] for r in results]))
    if all("depth_pred_masked" in r for r in results):
        summary.update(aggregate_depth_errors(results))
        conf = np.sum([r["conf_mat"] for r in results], axis=0) / len(results)
        summary["conf_mat"] = conf.tolist()

    # evaluation.txt in the reference's format (evaluation/eval.py:215-221)
    with open(os.path.join(extraction_dir, "evaluation.txt"), "a") as f:
        f.write("Mean MSE: {0:.2f}, PSNR: {1:.2f}, SSIM: {2:.2f}, LPIPS {3}\n".format(
            summary["mean_mse"], summary["mean_psnr"], summary["mean_ssim"],
            "{0:.2f}".format(summary["mean_lpips"]) if "mean_lpips" in summary else "n/a"))
        if "abs_rel" in summary:
            names = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
            f.write(("{:>8} | " * 7).format(*names) + "\n")
            f.write(("&{: 8.3f}  " * 7).format(*[summary[k] for k in names]) + "\\\\\n")
            c = summary["conf_mat"]
            f.write(f"\ntp: {c[0][0]}, fn: {c[0][1]}, fp: {c[1][0]}, tn: {c[1][1]}\n")
        f.write("\n-> Done!\n")

    if video_frames:
        from ..evaluation.artifacts import write_eval_video
        write_eval_video(extraction_dir, video_frames)
    print(summary)
    return summary


def main():
    parser = argparse.ArgumentParser(description="Evaluate image/depth quality")
    parser.add_argument("config", nargs="?", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    args = parser.parse_args()
    from ..config import load_config
    evaluate(load_config(args.config), synthetic=args.synthetic, device=args.device)


if __name__ == "__main__":
    main()
