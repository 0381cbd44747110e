"""Training CLI: `python -m nope_nerf_torch.cli.train <config.yaml> --synthetic`.

Port of nope_nerf_tpu/cli/train.py (reference train.py:19-370): config merge
and source backup, checkpoint resume with the scheduler scalars, the epoch
loop with per-iteration logging, periodic checkpoint/backup/visualization,
per-epoch train-pose ATE/RPE and PSNR, the held best checkpoint, the
divergence abort and both scheduler modes.

With `tpu.scan_steps` (the default) an epoch is one Trainer.run_steps call
with one readback at its end; the per-iteration hooks whose boundary falls
inside an epoch fire at that epoch's end, with the step's own metrics, as in
the JAX package's scan-fused loop. With it off the epoch is a loop of
Trainer.step over data.frame_iterator's batches, each hook firing after its
own step, as the JAX package's other branch. On the card both replay the
captured step graph (training/graphs.py) and give the same states. The
state's tensors are updated in place, so the held best state is a copy.

The scene is one on disk (data/fields.py::DataField: LLFF, Tanks and
V-KITTI layouts, PNG images) or, with `synthetic`, the built-in generator.
`dataloading.show_pose_only` draws the preprocessed pose frustums
(cli/vis_poses.py) and returns without training.

`tpu.mesh_shape` shards the ray batch over processes, one per device
(parallel/): launch `python3 -m torch.distributed.run --nproc_per_node N -m
nope_nerf_torch.cli.train <config>` with N the product of mesh_shape;
`--backend gloo` lets several ranks share one card. Every rank trains the
same replicated state; only rank 0 writes checkpoints.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..data.image_io import write_png

BEST_CKPT_WRITE_EVERY = 25   # epochs between model_best.ckpt disk writes


def backup(out_dir: str, config_path: Optional[str], snapshot_source: bool = True) -> None:
    """Config and source snapshot into out_dir/backup (reference `backup`,
    common.py:492-506): the whole nope_nerf_torch package, so a run directory
    describes itself even when the working tree moves on."""
    backup_path = os.path.join(out_dir, "backup")
    os.makedirs(backup_path, exist_ok=True)
    if config_path and os.path.exists(config_path):
        shutil.copyfile(config_path, os.path.join(backup_path, "config.yaml"))
    if snapshot_source:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dest = os.path.join(backup_path, os.path.basename(pkg_root))
        shutil.copytree(pkg_root, dest, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))


def build_scene(cfg: dict, synthetic: bool, mode: Optional[str] = None):
    """The training scene: cfg's scene on disk in `mode` (default
    training.mode), or with `synthetic` the 8-frame 120x160 synthetic plane
    scene."""
    from ..data import DataField, SceneData, make_synthetic_scene
    if synthetic:
        return SceneData.from_dict(make_synthetic_scene(n_frames=8, h=120, w=160))
    return DataField.from_cfg(cfg, mode=mode or cfg["training"]["mode"]).scene


def show_poses(scene, out_dir: str) -> str:
    """Pose-loading sanity check (reference dataset.py:114-127): the
    preprocessed GT poses and the initial (COLMAP) ones as frustums, drawn to
    out_dir/pose_check.png. Needs matplotlib."""
    from .vis_poses import draw_poses
    h_img, w_img = scene.imgs.shape[1:3]
    fx = float(scene.K[0, 0]) * w_img / 2.0
    fy = float(-scene.K[1, 1]) * h_img / 2.0
    c2ws_list = [np.asarray(scene.c2ws_gt)]
    colors, labels = ["tab:blue"], ["preprocessed (gt/llff)"]
    if scene.c2ws_init is not None:
        c2ws_list.append(np.asarray(scene.c2ws_init))
        colors.append("tab:orange")
        labels.append("init (colmap)")
    out_path = os.path.join(out_dir, "pose_check.png")
    draw_poses(c2ws_list, colors, labels, h_img, w_img, fx, fy, out_path)
    print(f"show_pose_only: wrote {out_path}; exiting without training")
    return out_path


def _clone_state(state):
    """A copy of the state's tensors on their device (the live state is
    updated in place by every step)."""
    from ..training.state import AdamState, TrainState

    def clone(group):
        return {k: v.clone() for k, v in group.items()}

    generator = torch.Generator(device=state.generator.device)
    generator.set_state(state.generator.get_state())
    return TrainState(
        params={g: clone(d) for g, d in state.params.items()},
        opt_state={g: AdamState(mu=clone(o.mu), nu=clone(o.nu), count=o.count.clone())
                   for g, o in state.opt_state.items()},
        it=state.it, generator=generator)


def _save_u8(path: str, img: np.ndarray) -> None:
    """[0, 1] values -> an 8-bit PNG through the port's own writer."""
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def train(cfg: dict, synthetic: bool = False, max_epochs: Optional[int] = None,
          device: DeviceLike = None, backend: Optional[str] = None, graphs: bool = True):
    """Train cfg's model on `device` (CUDA unless told otherwise) until the
    schedule ends or `max_epochs` epochs have run; resumes from the checkpoint
    in training.out_dir when there is one. Returns (state, trainer, scene), or
    with dataloading.show_pose_only the pose figure's path. On the card the
    steps replay captured graphs; graphs=False runs them eagerly (Trainer).

    With tpu.mesh_shape the run is one rank of a process group of that many
    processes (parallel.default_mesh; `backend` overrides NCCL on CUDA), each
    on cuda:{LOCAL_RANK % device_count} or on `device` when it is the CPU;
    a group of another size raises before anything runs."""
    from ..data import batch_for_frame, epoch_order, frame_iterator
    from ..evaluation.image_eval import eval_image
    from ..evaluation.pose_eval import full_pose_evaluation
    from ..models.nerf import reset_linear_params
    from ..models.poses import pose_c2w_all
    from ..training import ModelConfigs, Trainer, create_train_state
    from ..training.checkpoints import load_checkpoint, save_checkpoint
    from ..training.scheduler import AutoScheduler
    from ..utils.metrics import mse2psnr
    from ..utils.profiling import StepTimer

    from ..parallel import default_mesh, rank_zero_first
    mesh = None
    if cfg["tpu"]["mesh_shape"]:
        mesh = default_mesh(cfg, backend=backend, device=device)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    t_cfg = cfg["training"]
    out_dir = t_cfg["out_dir"]
    render_path = os.path.join(out_dir, "rendering")
    os.makedirs(render_path, exist_ok=True)

    seed = cfg["tpu"]["seed"]
    np.random.seed(seed)

    with rank_zero_first(mesh):     # rank 0 writes the image caches the others read
        scene = build_scene(cfg, synthetic)
    if cfg["dataloading"]["show_pose_only"]:
        return show_poses(scene, out_dir)
    n_views = scene.n_frames
    c2ws_gt = np.asarray(scene.c2ws_gt)
    mc = ModelConfigs.from_cfg(cfg, num_cams=n_views)

    init_c2w = None
    if cfg["pose"]["learn_pose"] and cfg["pose"]["init_pose"]:
        src = scene.c2ws_gt if cfg["pose"]["init_pose_type"] == "gt" else scene.c2ws_init
        if src is None:
            # a scene on disk without COLMAP poses is a config error: GT init
            # would make a pose-refinement experiment trivially degenerate
            if not synthetic:
                raise ValueError(
                    "pose.init_pose_type=colmap but the scene has no COLMAP poses "
                    "(dataloading.load_colmap_poses is off?); set init_pose_type=gt "
                    "explicitly if GT init is intended")
            # synthetic scenes have no COLMAP reconstruction: GT init is the only option
            print("synthetic scene: init_pose_type=colmap falls back to GT init")
            src = scene.c2ws_gt
        init_c2w = torch.as_tensor(np.asarray(src))
    init_focal = None
    if cfg["pose"]["learn_focal"] and cfg["pose"]["init_focal_type"] == "gt":
        init_focal = [float(scene.K[0, 0]), float(-scene.K[1, 1])]

    scene = scene.to_device(dev)   # one upload; the steps slice it on the device
    state = create_train_state(seed, mc, init_c2w=init_c2w, init_focal=init_focal, device=dev)
    trainer = Trainer(cfg, mc, mesh=mesh, graphs=graphs)

    # resume
    epoch_it, it = -1, -1
    psnr_best = float("-inf")
    best_held = None          # (state copy, scalars) awaiting a write
    best_written_at = -10**9
    scheduling_start = t_cfg["scheduling_start"]
    auto = AutoScheduler(length_smooth=t_cfg["length_smooth"], patient=t_cfg["patient"])
    loaded = load_checkpoint(out_dir, t_cfg["load_dir"], state,
                             load_model_only=t_cfg["load_ckpt_model_only"])
    if loaded is not None:
        state, scalars = loaded
        epoch_it = scalars.get("epoch_it", -1)
        it = int(state.it)
        scheduling_start = scalars.get("scheduling_start", scheduling_start)
        psnr_best = scalars.get("psnr_best", psnr_best)
        auto.load_state_dict(scalars)
        if scalars.get("occ_grid") is not None:
            # resume the EMA occupancy grid: a fresh all-ones grid would make a
            # resumed run sample differently for dozens of epochs (ignored when
            # the config has the grid off)
            trainer.set_occupancy_grid(scalars["occ_grid"])
        print(f"resumed from {t_cfg['load_dir']} at epoch {epoch_it}, it {it}")
    trainer._globalize(state)     # rank 0's state on every rank of a mesh

    def ckpt_scalars(ep, sched_start):
        sc = {"epoch_it": ep, "scheduling_start": sched_start, "psnr_best": psnr_best,
              **auto.state_dict()}
        if trainer.occ_grid is not None:
            sc["occ_grid"] = trainer.occ_grid.cpu().numpy()
        return sc

    try:
        from torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(os.path.join(out_dir, "logs"))
    except Exception:
        writer = None

    nparams = sum(int(v.numel()) for d in state.params.values() for v in d.values())
    print(f"total parameters: {nparams}")

    scheduling_epoch = t_cfg["scheduling_epoch"]
    print_every = t_cfg["print_every"]
    validate_every = t_cfg["validate_every"]
    checkpoint_every = t_cfg["checkpoint_every"]
    backup_every = t_cfg["backup_every"]
    visualize_every = t_cfg["visualize_every"]
    eval_pose_every = t_cfg["eval_pose_every"]
    eval_img_every = t_cfg["eval_img_every"]
    log_scale_shift = t_cfg["log_scale_shift_per_view"]
    vis_reproj_every = t_cfg["vis_reprojection_every"]
    scan_steps = bool(cfg["tpu"].get("scan_steps", True))   # an epoch per run_steps call

    vis_batch = batch_for_frame(scene, 0, rng=np.random.RandomState(seed))
    vis_img = vis_batch["img"].cpu().numpy()
    timer = StepTimer(rays_per_step=t_cfg["n_training_points"])

    def run_it_hooks(itj: int, get_ld, frame_idx: int, ref_idx: int):
        """Fire the per-iteration hooks of global step `itj`. get_ld() returns
        that step's metrics as floats (lazy: only the print hook pays for it)."""
        nonlocal t0b
        if print_every > 0 and itj % print_every == 0:
            ld = get_ld()
            print(f"[Epoch {epoch_it:02d}] it={itj:03d}, loss={ld['loss']:.8f}, "
                  f"time={time.time() - t0b:.4f} ({timer.summary()})")
            t0b = time.time()
            if writer:
                for k, v in ld.items():
                    writer.add_scalar(f"train/{k}", v, itj)
                writer.add_scalar("perf/rays_per_s", timer.rays_per_s, itj)
                if log_scale_shift:
                    writer.add_scalar(f"train/scale_view{frame_idx:02d}", ld["scale"], itj)
                    writer.add_scalar(f"train/shift_view{frame_idx:02d}", ld["shift"], itj)

        if visualize_every > 0 and itj % visualize_every == 0:
            out = trainer.render_frame(state, vis_batch, tuple(t_cfg["vis_resolution"]))
            vis_dir = os.path.join(render_path, f"{itj:04d}_vis")
            os.makedirs(vis_dir, exist_ok=True)
            _save_u8(os.path.join(vis_dir, "rgb.png"), out["rgb"])
            d = out["depth"]
            _save_u8(os.path.join(vis_dir, "depth.png"), (d - d.min()) / max(d.max(), 1e-6))
            if t_cfg["vis_geo"]:
                # phong geometry view (reference render_visdata's vis_geo branch,
                # training.py:146-163)
                geo = trainer.render_geo(state, vis_batch, tuple(t_cfg["vis_resolution"]),
                                         radius=cfg["rendering"]["radius"])
                _save_u8(os.path.join(vis_dir, "geo.png"), geo)

        if validate_every > 0 and itj % validate_every == 0:
            # render the vis frame and log PSNR (reference Trainer.evaluate via
            # validate_every, train.py:245-249)
            out_v = trainer.render_frame(state, vis_batch, vis_img.shape[:2])
            r = eval_image(out_v["rgb"], vis_img, with_lpips=False)
            print(f"  val: PSNR {r['psnr']:.2f} SSIM {r['ssim']:.3f}")
            if writer:
                writer.add_scalar("val/psnr", r["psnr"], itj)
                writer.add_scalar("val/ssim", r["ssim"], itj)

        if (vis_reproj_every > 0 and itj % vis_reproj_every == 0 and mc.pose is not None
                and (mc.loss.use_pc or mc.loss.use_rgb_s)):
            a, b, _ = trainer.reprojection_pair(
                state, batch_for_frame(scene, frame_idx, ref_idx=ref_idx))
            _save_u8(os.path.join(render_path, f"{itj}_{frame_idx:04d}_img1.png"), a)
            _save_u8(os.path.join(render_path, f"{itj}_{frame_idx:04d}_img2.png"), b)

        if checkpoint_every > 0 and itj % checkpoint_every == 0:
            save_checkpoint(out_dir, t_cfg["load_dir"], state,
                            ckpt_scalars(epoch_it, scheduling_start))
        if backup_every > 0 and itj % backup_every == 0:
            save_checkpoint(out_dir, f"model_{itj}.ckpt", state,
                            ckpt_scalars(epoch_it, scheduling_start))

    t0b = time.time()
    psnr = 0.0
    epoch_at_start = epoch_it
    try:
        while epoch_it < (scheduling_start + scheduling_epoch):
            epoch_it += 1
            if max_epochs is not None and epoch_it >= max_epochs:
                # epoch_it now names an epoch that will not run: roll it back so the
                # final checkpoint records the last completed epoch
                epoch_it -= 1
                if epoch_it == epoch_at_start:
                    print(f"checkpoint is already at epoch {epoch_it} >= --max-epochs "
                          f"{max_epochs}; nothing to train (delete {out_dir} or raise "
                          f"--max-epochs to rerun)")
                break
            trainer.update_occupancy(state, epoch_it)    # no-op unless the grid is on
            if scan_steps:
                order, refs = epoch_order(scene.n_frames, shuffle=cfg["dataloading"]["shuffle"],
                                          random_ref=cfg["dataloading"]["random_ref"],
                                          seed=seed + epoch_it)
                state, lds = trainer.run_steps(state, scene, order, refs, epoch_it,
                                               scheduling_start)
                # one bulk readback per epoch: it also waits for the device, so the
                # throughput meter measures completed steps
                lds_np = {k: v.cpu().numpy() for k, v in lds.items()}
                timer.tick_many(len(order))
                for j, (fidx, ridx) in enumerate(zip(order, refs)):
                    it += 1
                    run_it_hooks(it, lambda j=j: {k: float(v[j]) for k, v in lds_np.items()},
                                 int(fidx), int(ridx))
            else:
                # one step at a time, each with its hooks (JAX's cli/train.py:306-318); the
                # metrics stay on the device unless a hook reads them
                lds = []
                for batch in frame_iterator(scene, shuffle=cfg["dataloading"]["shuffle"],
                                            random_ref=cfg["dataloading"]["random_ref"],
                                            seed=seed + epoch_it):
                    it += 1
                    state, ld = trainer.step(state, batch, epoch_it, scheduling_start)
                    timer.tick()
                    lds.append(ld)
                    run_it_hooks(it, lambda ld=ld: {k: float(v) for k, v in ld.items()},
                                 int(batch["idx"]), int(batch["ref_idx"]))
                lds_np = {k: torch.stack([d[k] for d in lds]).cpu().numpy() for k in lds[0]}
            last_loss = float(lds_np["loss"][-1])

            if not np.isfinite(last_loss):
                # divergence guard: the reference breakpoint()s on a NaN loss
                # (losses.py:213-214); abort loudly instead. The last periodic
                # checkpoint predates the epoch that diverged.
                raise FloatingPointError(
                    f"non-finite loss ({last_loss}) at epoch {epoch_it}, it {it}; "
                    f"training aborted. Last good checkpoint: "
                    f"{os.path.join(out_dir, t_cfg['load_dir'])}")

            if eval_pose_every > 0 and epoch_it % eval_pose_every == 0 and mc.pose:
                with torch.no_grad():
                    learned = pose_c2w_all(state.params["pose"], mc.pose).cpu().numpy()
                metrics = full_pose_evaluation(learned, c2ws_gt)
                print(f"{epoch_it:6d} ep: ATE_t {metrics['ate_trans']:.4f} "
                      f"ATE_r {metrics['ate_r_v2_deg']:.3f}deg "
                      f"RPE_r {metrics['rpe_rot_deg']:.3f}deg")
                if writer:
                    for k, v in metrics.items():
                        writer.add_scalar(f"eval/{k}", v, it)

            if eval_img_every > 0 and epoch_it % eval_img_every == 0:
                psnr = float(mse2psnr(np.float32(lds_np["l2_mean"].mean())))
                print(f"{epoch_it:6d} ep: Train PSNR {psnr:.3f}")
                if writer:
                    writer.add_scalar("train/psnr", psnr, it)
                if psnr > psnr_best:
                    # best-PSNR checkpoint: hold a copy of the state on the device and
                    # write it at most every BEST_CKPT_WRITE_EVERY epochs (PSNR
                    # improves nearly every epoch early on)
                    psnr_best = psnr
                    best_held = (_clone_state(state), ckpt_scalars(epoch_it, scheduling_start))
                if best_held is not None and (
                        epoch_it - best_written_at >= BEST_CKPT_WRITE_EVERY):
                    save_checkpoint(out_dir, "model_best.ckpt", *best_held)
                    best_held, best_written_at = None, epoch_it

            if t_cfg["auto_scheduler"]:
                scheduling_start = auto.update(psnr, epoch_it, scheduling_start)

            if t_cfg["scheduling_mode"] == "reset" and epoch_it == scheduling_start:
                # re-initialize every Linear at decay start (reference train.py:347-350);
                # Adam's moments stay, as in the JAX package
                gen = torch.Generator().manual_seed(seed * 1_000_003 + epoch_it)
                state.params["nerf"] = reset_linear_params(gen, state.params["nerf"], mc.nerf)
                # the EMA grid describes the old field: start it afresh
                trainer.reset_occupancy()
                print(f"scheduling_mode=reset: re-initialized NeRF at epoch {epoch_it}")
    finally:
        # flush the held best-PSNR state on any exit: divergence abort,
        # KeyboardInterrupt, crash, not just normal completion
        if best_held is not None:
            save_checkpoint(out_dir, "model_best.ckpt", *best_held)

    save_checkpoint(out_dir, t_cfg["load_dir"], state, ckpt_scalars(epoch_it, scheduling_start))
    if mesh is not None and mesh.size > 1:
        torch.distributed.barrier()     # rank 0's checkpoint is on disk for every rank
    return state, trainer, scene


def main():
    parser = argparse.ArgumentParser(description="Train a NoPe-NeRF model (PyTorch/CUDA port)")
    parser.add_argument("config", nargs="?", default=None,
                        help="scene config yaml (merged over defaults)")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on the built-in synthetic scene")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="process-group backend with tpu.mesh_shape (default: nccl on "
                             "CUDA, gloo on the CPU; gloo lets ranks share one card)")
    args = parser.parse_args()

    from ..config import load_config
    cfg = load_config(args.config)
    backup(cfg["training"]["out_dir"], args.config)
    train(cfg, synthetic=args.synthetic, max_epochs=args.max_epochs, device=args.device,
          backend=args.backend)


if __name__ == "__main__":
    main()
