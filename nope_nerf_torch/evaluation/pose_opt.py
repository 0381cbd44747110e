"""Test-time pose optimization for unseen (test) views.

Port of nope_nerf_tpu/evaluation/pose_opt.py (reference
model/eval_pose_one_epoch.py:10-98, Trainer_pose, and the init-method
dispatch in evaluation/eval.py:103-117): freeze the NeRF, fit fresh SE(3)
deltas for the eval frames with a photometric-MSE-only objective, Adam and a
five-milestone halving schedule. Rays render with eval semantics (no
stratified noise, eval renormalization), as the reference does
(eval_pose_one_epoch.py:96-99).

A step is one forward launch of the render kernel and one launch of its
backward kernel (the frozen-network variant: only the ray table's gradient is
needed, and it carries the pose's); with rendering.n_importance > 0 it is two
launches of the point-query MLP forward (coarse and fine pass) and one of its
backward, whose dW/dB the frozen NeRF discards. The JAX package runs chunks
of log_every epochs as one dispatch (_pose_opt_epochs); here one step, with
the frame index, the epoch's rate and the epoch's loss sum as device tensors
and the ray draw from a generator registered with the graph, is captured in
a CUDA graph on the card (training/graphs.py) and replayed n_eval times an
epoch. Nothing is read back except at the log points, as there.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..geometry.camera import camera_matrix_from_focal, pixel_grid_on, rigid_inverse
from ..models.intrinsics import FocalConfig, focal_fxfy
from ..models.nerf import NerfConfig
from ..models.poses import PoseConfig, init_pose_params, pose_c2w, pose_c2w_all
from ..ops.render import RenderConfig, render_nope_nerf
from ..training.graphs import CapturedStep
from ..training.state import adam_step, init_adam
from ..utils.metrics import mse2psnr


def init_test_poses(method: str, eval_c2ws_init: Optional[np.ndarray],
                    learned_c2ws_train: np.ndarray,
                    colmap_c2ws_train: Optional[np.ndarray],
                    sample_rate: int, n_eval: int) -> Optional[np.ndarray]:
    """Initial c2ws for test-pose optimization (evaluation/eval.py:103-117):
    'scale' / 'ate' align the colmap eval poses into the learned frame;
    'pre' seeds each test pose with its neighboring learned train pose;
    'none' starts from identity."""
    from .align import align_ate_c2b_use_a2b, align_scale_c2b_use_a2b

    if method == "scale":
        init, _ = align_scale_c2b_use_a2b(colmap_c2ws_train, learned_c2ws_train,
                                          eval_c2ws_init.copy())
        return init
    if method == "ate":
        return align_ate_c2b_use_a2b(colmap_c2ws_train, learned_c2ws_train, eval_c2ws_init)
    if method == "pre":
        return learned_c2ws_train[int(sample_rate / 2) - 1::sample_rate - 1][:n_eval]
    if method == "none":
        return None
    raise ValueError(f"unknown init method {method}")


def pose_opt_loss(pose_params: Dict[str, torch.Tensor], nerf_params, focal_params,
                  img: torch.Tensor, idx, camera_mat: torch.Tensor, ray_idx: torch.Tensor,
                  pcfg: PoseConfig, fcfg: Optional[FocalConfig], ncfg: NerfConfig,
                  rcfg: RenderConfig) -> torch.Tensor:
    """mean((rgb - gt)^2) over the rays `ray_idx` of frame `idx` (an integer
    or a one-element index tensor), rendered from its current test pose;
    differentiable in pose_params."""
    h, w, _ = img.shape
    pixels = pixel_grid_on((h, w), img.device, img.dtype)[ray_idx]
    rgb_gt = img.reshape(-1, 3)[ray_idx]
    world_mat = rigid_inverse(pose_c2w(pose_params, idx, pcfg))
    cam = camera_mat
    if fcfg is not None:
        fxfy = focal_fxfy(focal_params, fcfg)
        cam = camera_matrix_from_focal(fxfy[0], fxfy[1])
    ones = torch.ones((ray_idx.shape[0], 1), dtype=img.dtype, device=img.device)
    out = render_nope_nerf(nerf_params, pixels, ones, cam, world_mat, None, None, rcfg, ncfg,
                           add_noise=False, eval_=True, need_aux=False)
    return ((out["rgb"] - rgb_gt) ** 2).mean()


def pose_opt_step(pose_params, opt_state, nerf_params, focal_params, img, idx, camera_mat,
                  ray_idx, lr, pcfg: PoseConfig, fcfg, ncfg, rcfg) -> torch.Tensor:
    """One Adam step on frame `idx`'s pose, in place (Adam's moments without
    the rate, then p -= lr * update); returns the loss before the step. `idx`
    is an integer or a one-element index tensor, `lr` a number or a 0-d
    tensor. The NeRF and the focal are frozen. A tensor the loss does not
    reach (the frozen init pose, the other frames' rows) gets a zero
    gradient."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in pose_params.items()}
    frozen = {k: v.detach() for k, v in nerf_params.items()}
    loss = pose_opt_loss(leaves, frozen, focal_params, img, idx, camera_mat, ray_idx, pcfg, fcfg,
                         ncfg, rcfg)
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    adam_step(pose_params, {k: g if g is not None else torch.zeros_like(pose_params[k])
                            for k, g in zip(names, grads)}, opt_state, lr)
    return loss.detach()


def pose_opt_lrs(lr: float, n_epochs: int) -> list:
    """The rate of each epoch: halved at each of five evenly spaced milestones,
    the first of which is epoch 0 (eval_pose_one_epoch.py's MultiStepLR)."""
    milestones = list(range(0, n_epochs, max(n_epochs // 5, 1)))
    return [lr * (0.5 ** sum(1 for m in milestones if m <= e)) for e in range(n_epochs)]


class PoseOptRun:
    """A test-pose optimisation in progress: the test poses and their Adam
    state, the ray generator seeded with `seed`, and on the device the frame
    counter, the epoch's rate (`rate`, filled once per epoch), the epoch's
    loss sum (`loss_sum`, restarted at frame 0) and, with `pinned`, the index
    buffer `rays` the caller fills before each step. `step()` runs one frame's
    step and moves to the next frame: on CUDA with `graphs` a replay of the
    step captured in a CUDA graph (training/graphs.py), else the same body
    eagerly."""

    def __init__(self, nerf_params, focal_params, eval_scene, ncfg: NerfConfig,
                 rcfg: RenderConfig, init_c2ws: Optional[np.ndarray] = None,
                 fcfg: Optional[FocalConfig] = None, n_points: int = 1024, seed: int = 0,
                 device: DeviceLike = None, pinned: bool = False, graphs: bool = True):
        dev = resolve_device(device)
        self.n_eval = n_eval = eval_scene.n_frames
        self.pcfg = pcfg = PoseConfig(num_cams=n_eval, use_init_c2w=init_c2ws is not None)
        self.pose_params = init_pose_params(
            pcfg, None if init_c2ws is None
            else torch.as_tensor(np.asarray(init_c2ws, np.float32)), device=dev)
        self.opt_state = init_adam(self.pose_params)
        generator = torch.Generator(device=dev).manual_seed(seed)
        nerf_params = {k: v.to(dev) for k, v in nerf_params.items()}
        if focal_params is not None:
            focal_params = {k: v.to(dev) for k, v in focal_params.items()}
        imgs = torch.as_tensor(eval_scene.imgs).to(dev)
        camera_mat = torch.as_tensor(eval_scene.K).to(dev)
        hw = imgs.shape[1] * imgs.shape[2]
        self.rate = torch.zeros((), dtype=torch.float64, device=dev)
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        frame = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.rays = torch.zeros((n_points,), dtype=torch.int64, device=dev) if pinned else None

        def body():
            rays = (torch.randperm(hw, generator=generator, device=dev)[:n_points]
                    if self.rays is None else self.rays)
            loss = pose_opt_step(self.pose_params, self.opt_state, nerf_params, focal_params,
                                 imgs.index_select(0, frame)[0], frame, camera_mat, rays,
                                 self.rate, pcfg, fcfg, ncfg, rcfg)
            # the epoch's sum starts afresh at its first frame
            self.loss_sum.copy_(torch.where(frame.reshape(()) == 0,
                                            torch.zeros_like(self.loss_sum),
                                            self.loss_sum) + loss)
            frame.copy_(torch.remainder(frame + 1, n_eval))

        self.step = body
        self.captured = None
        if graphs and dev.type == "cuda":
            mutated = [*self.pose_params.values(), *self.opt_state.mu.values(),
                       *self.opt_state.nu.values(), self.opt_state.count, frame, self.loss_sum]
            self.captured = CapturedStep(body, mutated, generator, "the pose-optimisation step")
            self.step = self.captured.replay


def optimize_test_poses(nerf_params, focal_params, eval_scene,
                        ncfg: NerfConfig, rcfg: RenderConfig,
                        init_c2ws: Optional[np.ndarray] = None,
                        fcfg: Optional[FocalConfig] = None,
                        n_points: int = 1024, n_epochs: int = 1000,
                        lr: float = 0.001, seed: int = 0, log_every: int = 100,
                        device: DeviceLike = None,
                        ray_idx: Optional[torch.Tensor] = None,
                        graphs: bool = True) -> Tuple[Dict, np.ndarray]:
    """Optimize per-test-frame poses against the frozen NeRF on `device` (CUDA
    unless told otherwise). Returns (pose_params, learned eval c2ws (N,4,4)).
    Each step draws n_points rays without replacement from a generator seeded
    with `seed`; `ray_idx` (n_epochs, n_eval, n_points) pins the draws, copied
    step by step into the step's index buffer. One step body serves every
    frame (PoseOptRun): on CUDA it is captured in a CUDA graph and replayed
    n_eval times an epoch; graphs=False (and a CPU device) runs it eagerly.
    Nothing is read back but at the log points."""
    dev = resolve_device(device)
    run = PoseOptRun(nerf_params, focal_params, eval_scene, ncfg, rcfg, init_c2ws=init_c2ws,
                     fcfg=fcfg, n_points=n_points, seed=seed, device=dev,
                     pinned=ray_idx is not None, graphs=graphs)
    if ray_idx is not None:
        ray_idx = torch.as_tensor(ray_idx).to(device=dev, dtype=torch.int64)
    for epoch, lr_e in enumerate(pose_opt_lrs(lr, n_epochs)):
        run.rate.fill_(lr_e)
        for i in range(run.n_eval):
            if ray_idx is not None:
                run.rays.copy_(ray_idx[epoch, i])
            run.step()
        if log_every and epoch % log_every == 0:
            l2 = float(run.loss_sum) / run.n_eval
            print(f"  pose-opt epoch {epoch}: L2 {l2:.4f} PSNR {float(mse2psnr(l2)):.2f}")

    with torch.no_grad():
        c2ws = pose_c2w_all(run.pose_params, run.pcfg).cpu().numpy()
    return run.pose_params, c2ws
