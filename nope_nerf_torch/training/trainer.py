"""The train step and the host-side Trainer.

Port of nope_nerf_tpu/training/trainer.py (reference model/training.py:16-416,
Trainer.train_step/compute_loss): ray sampling with the sparse-depth validity
guarantee, pose/distortion/focal application, rendering, the inter-frame
reference pair (point-cloud lift, relative-pose warp, photometric
reprojection), loss assembly, and one Adam update per parameter group.

The step runs eagerly. With an eligible config the rays go through
ops/fused_render.render_ray_loss_fused: one launch of the train kernel gives
the rgb + depth term and every gradient below it, and autograd carries the
rest (poses, distortions, the pair losses). Other fused-eligible configs
render through render_nope_nerf, forward and backward kernels on CUDA; the
configs the fused render cannot serve (hierarchical sampling, num_points %
128 != 0) render through its unfused route, whose MLP queries are the
point-query kernels (ops/fused_mlp.py) on CUDA with use_pallas. The
frame-order select of the JAX package (a traced where) is a plain `if` here.
Trainer.render_frame renders a whole eval frame, Trainer.render_geo the phong
geometry view; the Trainer keeps the occupancy grid (ops/occupancy.py) when
rendering.occupancy_grid is set.

With a mesh (parallel/mesh.py) the step is sharded over processes, as the
JAX package's shard_map step over its 'data' axis: each rank renders
n_training_points / world of the rays, the loss sums are psum'd, and the
replicated inputs of the per-shard render pass pvary, whose backward sums
the shard's gradient over ranks (parallel/sharding.py). The frame pair runs
replicated on every rank. Every rank draws the global ray indices and the
global jitter from its replicated generator and takes its rows, so the
generators stay in step and a sharded step draws what the one-process step
draws (the JAX package splits the key per device instead).
Trainer.render_frame_multihost splits an eval frame's rows over the ranks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.camera import (
    camera_matrix_from_focal,
    pixel_grid_on,
    project_to_cam,
    rigid_inverse,
    transform_to_world,
)
from ..losses import compute_losses, depth_loss_invariant
from ..models.distortions import distortion_scale_shift
from ..models.intrinsics import focal_fxfy
from ..models.poses import pose_c2w, pose_translations
from ..ops.fused_render import pack_targets, render_ray_loss_fused
from ..ops.interp import get_tensor_values, resize_area, resize_bilinear, resize_nearest
from ..ops.occupancy import make_occupancy_grid, update_occupancy_grid
from ..ops.render import fused_train_eligible, fused_train_prepare, render_nope_nerf
from ..parallel.mesh import make_mesh
from ..parallel.multihost import (globalize_replicated, host_image_tiles, host_ray_slice,
                                  process_count)
from ..parallel.sharding import all_gather_tiled, psum, pvary
from .scheduler import annealed_weights, lr_at_epoch, rgb_loss_type_at
from .state import ModelConfigs, TrainState, adam_step


RENDER_CHUNK = 131072   # rays per render launch of an eval frame: one for a 188x621 frame


def _sample_rays(generator: torch.Generator, hw: int, n: int,
                 depth_mask_flat: Optional[torch.Tensor], resample: bool) -> torch.Tensor:
    """randperm(h*w)[:n], the reference's own draw (training.py:277), with its
    >= 1-valid-sparse-depth guarantee (training.py:277-283) as the JAX package
    has it: draw once; if no sampled pixel has a valid depth, put the first
    valid index into slot 0."""
    idx = torch.randperm(hw, generator=generator, device=generator.device)[:n]
    if not resample or depth_mask_flat is None:
        return idx
    idx = idx.to(depth_mask_flat.device)
    any_valid = depth_mask_flat[idx].any()
    forced = torch.argmax(depth_mask_flat.to(torch.uint8))  # first valid index
    idx[0] = torch.where(any_valid, idx[0], forced)
    return idx


def _apply_distortion(depth: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      shift_first: bool) -> torch.Tensor:
    """training.py:259-264 / :310-315."""
    if shift_first:
        return (depth + shift) * scale
    return depth * scale + shift


def _global_draws(generator: Optional[torch.Generator], n: int, mc: ModelConfigs,
                  noise: Optional[torch.Tensor], fine_u: Optional[torch.Tensor]):
    """(noise, fine_u, normal_noise): the draws the render of n rays would
    take from `generator`, in its order and at its shapes, for those not
    pinned: the stratified or occupancy jitter (N, S), the hierarchical fine
    draw (N, n_importance) and the normal output's jitter (N, 3). Without a
    generator nothing is drawn."""
    rcfg = mc.render
    normal_noise = None
    if generator is None:
        return noise, fine_u, normal_noise

    def rand(cols):
        return torch.rand((n, cols), generator=generator, device=generator.device)

    if noise is None and mc.stratified_noise and rcfg.sample_option != "ndc":
        noise = rand(rcfg.num_points - rcfg.outside_steps)
    if fine_u is None and rcfg.n_importance > 0 and rcfg.sample_option != "ndc":
        fine_u = rand(rcfg.n_importance) * (1.0 - 1e-5)
    if rcfg.normal_loss:
        normal_noise = rand(3)
    return noise, fine_u, normal_noise


def _ray_terms(nerf_params, pixels, depth_prior, rgb_gt, prior_mask, camera_mat, world_mat,
               scale_mat, generator, mc: ModelConfigs, rgb_loss_type: str, n_total: int,
               weights: Dict[str, float], noise: Optional[torch.Tensor] = None,
               fine_u: Optional[torch.Tensor] = None, occ_grid: Optional[torch.Tensor] = None,
               normal_noise: Optional[torch.Tensor] = None, mesh=None):
    """Render the ray batch and reduce its loss terms to scalars:
    (l_rgb, l_depth, l2_mean, ray_total). `noise`, `fine_u` and
    `normal_noise` pin the stratified (or occupancy) jitter, the hierarchical
    fine draw and the normal output's jitter; `occ_grid` guides the sampling
    when given. With `mesh` the rays are this rank's share and every sum is
    psum'd over the mesh, so each rank returns the global terms; the depth
    weight of the fused path divides by the global mask count, and the
    invariant depth loss takes its median over the gathered batch.

    On the fused path ray_total is the already-weighted rgb + depth term from
    the one program that also produces every gradient below it, and l_rgb,
    l_depth, l2_mean are metrics without gradient; otherwise (e.g.
    depth_loss_type invariant) the rays go through render_nope_nerf, whose
    backward on CUDA is the render-backward kernel, ray_total is None and the
    caller weights l_rgb and l_depth itself."""
    lcfg = mc.loss
    zero = torch.zeros((), dtype=torch.float32, device=pixels.device)
    fused = lcfg.depth_loss_type == "l1" and fused_train_eligible(mc.render, mc.nerf)
    if fused:
        ray_table, z_val, depth_gt, object_mask = fused_train_prepare(
            pixels, depth_prior, camera_mat, world_mat, scale_mat, generator, mc.render,
            add_noise=mc.stratified_noise, noise=noise, occ_grid=occ_grid)
        if mc.detach_gt_depth:
            depth_gt = depth_gt.detach()
        mask = object_mask & prior_mask
        # the global count, before the kernel: it sets the depth weight
        count = psum(mask.to(torch.float32).sum(), mesh)
        w_rgb_s = weights["rgb_weight"] / n_total if lcfg.use_rgb else 0.0
        w_depth_s = (weights["depth_weight"] * (count > 0) / count.clamp_min(1.0)
                     if lcfg.use_depth else 0.0)
        tgt = pack_targets(rgb_gt, depth_gt, mask, w_rgb_s, w_depth_s)
        total, sums = render_ray_loss_fused(
            nerf_params, ray_table, z_val, tgt, mc.nerf, mc.render.dist_alpha,
            1 if rgb_loss_type == "l1" else 2, mc.render.white_background)
        # one all-reduce on a mesh: the total with its gradient, the sums without
        both = psum(torch.cat([total.reshape(1), sums.detach()]), mesh)
        total, sums = both[0], both[1:]
        l_rgb = sums[0] / n_total if lcfg.use_rgb else zero
        l_depth = (torch.where(count > 0, sums[1] / count.clamp_min(1.0), zero)
                   if lcfg.use_depth else zero)
        return l_rgb, l_depth, sums[2] / (n_total * 3), total

    out = render_nope_nerf(nerf_params, pixels, depth_prior, camera_mat, world_mat, scale_mat,
                           generator, mc.render, mc.nerf, add_noise=mc.stratified_noise,
                           eval_=False, noise=noise, occ_grid=occ_grid, fine_u=fine_u,
                           normal_noise=normal_noise)
    depth_pred, depth_gt = out["depth_pred"], out["depth_gt"]
    if mc.detach_gt_depth:
        depth_gt = depth_gt.detach()
    mask = out["object_mask"] & prior_mask
    diff = out["rgb"] - rgb_gt
    l1_depth = lcfg.use_depth and lcfg.depth_loss_type == "l1"
    # the sums of the batch, psum'd together: rgb, depth, mask count, squared error
    sums = psum(torch.stack([
        (diff.abs() if rgb_loss_type == "l1" else diff * diff).sum() if lcfg.use_rgb else zero,
        torch.where(mask, (depth_pred - depth_gt).abs(), zero).sum() if l1_depth else zero,
        mask.to(torch.float32).sum() if l1_depth else zero,
        (diff * diff).sum()]), mesh)
    l_rgb = sums[0] / n_total if lcfg.use_rgb else zero
    if not lcfg.use_depth:
        l_depth = zero
    elif l1_depth:
        l_depth = torch.where(sums[2] > 0, sums[1] / sums[2].clamp_min(1.0), zero)
    else:   # the invariant loss needs the global median: on a mesh, gather the ray batch
        l_depth = depth_loss_invariant(all_gather_tiled(depth_pred, mesh),
                                       all_gather_tiled(depth_gt, mesh),
                                       all_gather_tiled(mask, mesh))
    l2_mean = sums[3] / (n_total * 3) if lcfg.use_rgb or lcfg.use_depth else zero
    return l_rgb, l_depth, l2_mean, None


def compute_step_loss(params: Dict[str, Any], batch: Dict[str, Any], weights: Dict[str, float],
                      ray_idx: torch.Tensor, generator: Optional[torch.Generator],
                      mc: ModelConfigs, rgb_loss_type: str,
                      noise: Optional[torch.Tensor] = None,
                      fine_u: Optional[torch.Tensor] = None, mesh=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one frame and its reference frame, differentiable in `params`
    through autograd: (loss, loss_dict). `noise` pins the stratified jitter
    (N, S) and `fine_u` the hierarchical fine draw (N, n_importance) that
    `generator` would otherwise draw. batch["occ_grid"], when present, guides
    the sampling. With `mesh` this rank renders its share of the rays and
    every rank returns the global loss; its gradients are the global ones."""
    img = batch["img"]                      # (H, W, 3)
    depth_input = batch["depth"]            # (H, W)
    depth_mask = batch["depth_mask"]        # (H, W) bool
    idx = int(batch["idx"])
    pose_gt = batch["pose_gt"]              # (4, 4) c2w
    h, w, _ = img.shape
    lcfg = mc.loss

    # --- pose, depth distortion, intrinsics ---------------------------------
    if mc.pose is not None:
        world_mat = rigid_inverse(pose_c2w(params["pose"], idx, mc.pose))
        t_list = pose_translations(params["pose"], mc.pose)
    else:
        world_mat = rigid_inverse(pose_gt)
        t_list = None
    world_mat_gt = rigid_inverse(pose_gt)

    if mc.distortion is not None:
        scale_in, shift_in = distortion_scale_shift(params["distortion"], idx, mc.distortion)
        depth_input = _apply_distortion(depth_input, scale_in[0], shift_in[0], mc.shift_first)
    else:
        scale_in = torch.ones((1,), dtype=img.dtype, device=img.device)
        shift_in = torch.zeros((1,), dtype=img.dtype, device=img.device)

    if mc.focal is not None:
        fxfy = focal_fxfy(params["focal"], mc.focal)
        camera_mat = camera_matrix_from_focal(fxfy[0], fxfy[1])
    else:
        camera_mat = batch["camera_mat"]
    scale_mat = batch.get("scale_mat")

    # --- render the sampled rays --------------------------------------------
    iy = ray_idx // w
    ix = ray_idx % w
    rgb_gt = img[iy, ix]
    pixels = torch.stack([2.0 * ix.to(img.dtype) / (w - 1) - 1.0,
                          2.0 * iy.to(img.dtype) / (h - 1) - 1.0], dim=-1)
    # per-ray depth prior: full-frame area resize, then gather (network.py:19-33)
    depth_resized = resize_area(depth_input[..., None], (h, w))[..., 0]
    depth_prior = depth_resized[iy, ix][:, None]

    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    precomputed = {"loss_rgb": zero, "loss_depth": zero, "l2_mean": zero}
    if lcfg.use_rgb or lcfg.use_depth:
        # the shard's inputs: the whole batch, or with a mesh this rank's rows of the
        # global batch and of the global draws. Every replicated input passes pvary (its
        # backward sums over the ranks; without a mesh an alias), so the shard's gradient
        # reaches it as one sum either way; the pair terms below keep the originals.
        n = pixels.shape[0]
        lo, hi = (0, n) if mesh is None else host_ray_slice(n, mesh.rank, mesh.size)
        draws = (noise, fine_u, None)
        if mesh is not None:
            draws = tuple(None if d is None else d[lo:hi]
                          for d in _global_draws(generator, n, mc, noise, fine_u))
            generator, scale_mat = None, None   # every draw is pinned; scale_mat: JAX :304
        shard = [{k: pvary(v, mesh) for k, v in params["nerf"].items()},
                 pvary(pixels, mesh)[lo:hi], pvary(depth_prior, mesh)[lo:hi], rgb_gt[lo:hi],
                 depth_mask[iy, ix][lo:hi], pvary(camera_mat, mesh), pvary(world_mat, mesh),
                 scale_mat, generator]
        l_rgb, l_depth, l2_mean, ray_total = _ray_terms(
            *shard, mc, rgb_loss_type, mc.n_training_points, weights, noise=draws[0],
            fine_u=draws[1], occ_grid=batch.get("occ_grid"), normal_noise=draws[2], mesh=mesh)
        precomputed = {"loss_rgb": l_rgb, "loss_depth": l_depth, "l2_mean": l2_mean}
        if ray_total is not None:
            precomputed["ray_total"] = ray_total

    # --- inter-frame reference pair -----------------------------------------
    loss_kwargs: Dict[str, Any] = {}
    if lcfg.use_pc or lcfg.use_rgb_s or lcfg.use_t_cycle:
        if mc.pose is None:
            raise ValueError("pair losses require learned poses")
        ref_idx = int(batch["ref_idx"])
        ref_img = batch["ref_img"]
        depth_ref = batch["ref_depth"]
        nl = mc.nearest_limit

        c2w_ref = pose_c2w(params["pose"], ref_idx, mc.pose)
        if mc.distortion is not None:
            scale_ref, shift_ref = distortion_scale_shift(params["distortion"], ref_idx,
                                                          mc.distortion)
            depth_ref = _apply_distortion(depth_ref, scale_ref[0], shift_ref[0], mc.shift_first)
        else:
            scale_ref = torch.ones((1,), dtype=img.dtype, device=img.device)
        if mc.detach_ref_img:
            c2w_ref, scale_ref, depth_ref = c2w_ref.detach(), scale_ref.detach(), depth_ref.detach()
        ref_Rt = rigid_inverse(c2w_ref)
        ref_Rt_gt = rigid_inverse(batch["ref_pose_gt"])

        # frame ordering: frame 1 must precede frame 2 (training.py:323-352)
        if idx < mc.pose.num_cams - 1:
            d1, d2, img1, img2, scale1 = depth_input, depth_ref, img, ref_img, scale_in
            Rt_rel_12 = ref_Rt @ rigid_inverse(world_mat)
            Rt_rel_12_gt = ref_Rt_gt @ rigid_inverse(world_mat_gt)
        else:
            d1, d2, img1, img2, scale1 = depth_ref, depth_input, ref_img, img, scale_ref
            Rt_rel_12 = world_mat @ rigid_inverse(ref_Rt)
            Rt_rel_12_gt = world_mat_gt @ rigid_inverse(ref_Rt_gt)
        R_rel = Rt_rel_12[:3, :3]
        t_rel = Rt_rel_12[:3, 3]

        sh, sw = h // mc.pc_ratio, w // mc.pc_ratio
        p_pc = pixel_grid_on((sh, sw), img.device, img.dtype)
        d1s = resize_nearest(d1[..., None], (sh, sw)).reshape(-1).clamp_min(nl)
        d2s = resize_nearest(d2[..., None], (sh, sw)).reshape(-1).clamp_min(nl)
        pc1 = transform_to_world(p_pc, d1s[:, None], camera_mat)
        pc2 = transform_to_world(p_pc, d2s[:, None], camera_mat)

        if lcfg.use_rgb_s:
            first = idx < mc.pose.num_cams - 1
            if "img_small" in batch:
                # per-frame constants, computed once per scene (Trainer._warp_frames)
                img2s = batch["ref_img_small"] if first else batch["img_small"]
                rgb_pc1 = batch["rgb_pc"] if first else batch["ref_rgb_pc"]
            else:
                img2s = resize_bilinear(img2, (sh, sw))
                rgb_pc1 = get_tensor_values(resize_bilinear(img1, (sh, sw)), p_pc,
                                            mode="bilinear", scale=False, align_corners=True)
            pc1_base = pc1.detach() if mc.detach_rgbs_scale else pc1
            pc1_rot = pc1_base @ R_rel.T + t_rel
            invalid = (-pc1_rot[:, 2:]) < nl  # in front of / too close to cam 2
            pc1_rot = torch.where(invalid.expand(pc1_rot.shape),
                                  torch.full_like(pc1_rot, nl), pc1_rot)
            p_reproj, valid_mask = project_to_cam(pc1_rot, camera_mat)
            rgb_pc1_proj = get_tensor_values(img2s, p_reproj, mode="bilinear", scale=False,
                                             align_corners=True)
            loss_kwargs.update(rgb_pc1=rgb_pc1.reshape(sh, sw, 3),
                               rgb_pc1_proj=rgb_pc1_proj.reshape(sh, sw, 3),
                               valid_points=valid_mask.reshape(sh, sw, 1).to(img.dtype))

        if mc.scale_pcs:  # training.py:394-396
            pc1 = pc1 / scale1
            pc2 = pc2 / scale1
        loss_kwargs.update(pc_x=pc1 @ R_rel.T + t_rel, pc_y=pc2, rt_12=Rt_rel_12,
                           rt_12_gt=Rt_rel_12_gt)

    loss_dict = compute_losses(lcfg, weights, rgb_loss_type=rgb_loss_type, t_list=t_list,
                               precomputed=precomputed, **loss_kwargs)
    loss_dict["scale"] = scale_in[0]
    loss_dict["shift"] = shift_in[0]
    return loss_dict["loss"], loss_dict


def step_gradients(params: Dict[str, Dict[str, torch.Tensor]], batch, weights, ray_idx,
                   generator, mc: ModelConfigs, rgb_loss_type: str, noise=None, fine_u=None,
                   mesh=None):
    """(grads shaped like params, detached loss_dict) of compute_step_loss. A
    tensor the loss does not reach (a frozen init pose) gets a zero gradient,
    as jax.grad gives it. With `mesh` both are the global ones, on every rank."""
    leaves = {g: {k: v.detach().requires_grad_(True) for k, v in group.items()}
              for g, group in params.items()}
    loss, loss_dict = compute_step_loss(leaves, batch, weights, ray_idx, generator, mc,
                                        rgb_loss_type, noise=noise, fine_u=fine_u, mesh=mesh)
    flat = [(g, k) for g in leaves for k in leaves[g]]
    grads = torch.autograd.grad(loss, [leaves[g][k] for g, k in flat], allow_unused=True)
    out: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in leaves}
    for (g, k), grad in zip(flat, grads):
        out[g][k] = grad if grad is not None else torch.zeros_like(leaves[g][k])
    # cloned: scale and shift are views of parameters that the update changes in place
    return out, {k: v.detach().clone() for k, v in loss_dict.items()}


def train_step(state: TrainState, batch: Dict[str, Any], weights: Dict[str, float],
               lrs: Dict[str, float], mc: ModelConfigs, rgb_loss_type: str,
               ray_idx: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               fine_u: Optional[torch.Tensor] = None,
               mesh=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One full optimization step: state -> (state, metrics). The state's
    tensors are updated in place and the same state object is returned.
    `ray_idx`, `noise` and `fine_u` pin the random draws (tests); otherwise
    they come from the state's generator. With `mesh` the rays shard over its
    ranks (compute_step_loss); every rank makes the same update."""
    h, w, _ = batch["img"].shape
    if mesh is not None and mc.n_training_points % mesh.size:
        raise ValueError(f"n_training_points {mc.n_training_points} must divide evenly across "
                         f"the mesh's {mesh.size} ranks")
    if ray_idx is None:
        ray_idx = _sample_rays(
            state.generator, h * w, mc.n_training_points,
            batch["depth_mask"].reshape(-1) if mc.use_sparse_depth_resample else None,
            mc.use_sparse_depth_resample)
    ray_idx = ray_idx.to(batch["img"].device)
    grads, loss_dict = step_gradients(state.params, batch, weights, ray_idx, state.generator,
                                      mc, rgb_loss_type, noise=noise, fine_u=fine_u, mesh=mesh)
    for group in state.params:
        adam_step(state.params[group], grads[group], state.opt_state[group], lrs[group],
                  mc.weight_decay if group == "nerf" else 0.0)
    state.it += 1
    return state, loss_dict


def train_steps(state: TrainState, scene_stack: Dict[str, torch.Tensor], order, ref_order,
                weights: Dict[str, float], lrs: Dict[str, float], mc: ModelConfigs,
                rgb_loss_type: str, mesh=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """len(order) train steps over the frame order (the JAX package's lax.scan
    as a loop): (state, loss_dict with a leading step axis). Nothing is read
    back to the host between steps."""
    dicts = []
    for idx, ref in zip(order, ref_order):
        idx, ref = int(idx), int(ref)
        batch = {
            "img": scene_stack["imgs"][idx],
            "depth": scene_stack["depths"][idx],
            "depth_mask": scene_stack["depth_masks"][idx],
            "camera_mat": scene_stack["K"],
            "pose_gt": scene_stack["c2ws_gt"][idx],
            "idx": idx,
            "ref_img": scene_stack["imgs"][ref],
            "ref_depth": scene_stack["depths"][ref],
            "ref_pose_gt": scene_stack["c2ws_gt"][ref],
            "ref_idx": ref,
        }
        if "imgs_small" in scene_stack:
            batch["img_small"] = scene_stack["imgs_small"][idx]
            batch["ref_img_small"] = scene_stack["imgs_small"][ref]
            batch["rgb_pc"] = scene_stack["rgb_pc"][idx]
            batch["ref_rgb_pc"] = scene_stack["rgb_pc"][ref]
        if "occ_grid" in scene_stack:
            batch["occ_grid"] = scene_stack["occ_grid"]
        state, loss_dict = train_step(state, batch, weights, lrs, mc, rgb_loss_type, mesh=mesh)
        dicts.append(loss_dict)
    return state, {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


class Trainer:
    """Host-side orchestration: the epoch's schedule scalars, the per-scene
    warp cache and the occupancy grid. The per-step compute lives in
    train_step; with `mesh` (parallel/mesh.py) it is sharded over the mesh's
    ranks."""

    def __init__(self, cfg: dict, mc: ModelConfigs, mesh=None):
        self.cfg = cfg
        self.mc = mc
        self.mesh = mesh
        t = cfg["training"]
        self.base_lrs = {"nerf": t["learning_rate"], "pose": t["pose_lr"],
                         "focal": t["focal_lr"], "distortion": t["distortion_lr"]}
        self.gammas = {"nerf": t["scheduler_gamma"], "pose": t["scheduler_gamma_pose"],
                       "focal": t["scheduler_gamma_focal"],
                       "distortion": t["scheduler_gamma_distortion"]}
        self.decay_intervals = {"nerf": 10, "pose": 100, "focal": 100, "distortion": 100}
        self._sched_cache: Dict[Any, Any] = {}
        self._warp_cache = None   # per-scene photometric-warp constants (_warp_frames)
        # occupancy-grid guided sampling (ops/occupancy.py), created by update_occupancy
        r = cfg["rendering"]
        self.occ_grid: Optional[torch.Tensor] = None
        self._occ_enabled = bool(r.get("occupancy_grid", False))
        self._occ_res = int(r.get("occupancy_res", 64))
        self._occ_decay = float(r.get("occupancy_decay", 0.95))
        self._occ_update_every = int(r.get("occupancy_update_every", 1))
        if self._occ_enabled and mc.render.sample_option == "ndc":
            # NDC sampling takes priority in _ray_geometry: a grid would only cost a
            # 262k-point density query per epoch and checkpoint space
            print("WARNING: rendering.occupancy_grid is ignored with sample_option=ndc "
                  "(NDC z-sampling takes priority); disabling occupancy for this run")
            self._occ_enabled = False

    def lrs_at(self, epoch: int, scheduling_start: int) -> Dict[str, float]:
        return {g: lr_at_epoch(self.base_lrs[g], self.gammas[g], scheduling_start, epoch,
                               self.decay_intervals[g]) for g in self.base_lrs}

    def weights_at(self, epoch: int, scheduling_start: int) -> Dict[str, float]:
        return annealed_weights(self.cfg["training"], scheduling_start, epoch)

    def rgb_loss_type(self, epoch: int, scheduling_start: int) -> str:
        return rgb_loss_type_at(self.cfg["training"], scheduling_start, epoch)

    def _globalize(self, tree):
        """`tree` overwritten by rank 0's values on a mesh of several ranks
        (parallel.globalize_replicated); the identity otherwise."""
        return globalize_replicated(tree, self.mesh)

    def _sched_at(self, epoch: int, scheduling_start: int):
        """(weights, lrs, rgb_loss_type) of this epoch, computed once per epoch."""
        key = (epoch, scheduling_start)
        sched = self._sched_cache.get(key)
        if sched is None:
            sched = (self.weights_at(epoch, scheduling_start),
                     self.lrs_at(epoch, scheduling_start),
                     self.rgb_loss_type(epoch, scheduling_start))
            self._sched_cache = {key: sched}  # keep only the current epoch
        return sched

    def step(self, state: TrainState, batch: Dict[str, Any], epoch: int,
             scheduling_start: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        weights, lrs, rgb_loss_type = self._sched_at(epoch, scheduling_start)
        if self.occ_grid is not None and "occ_grid" not in batch:
            batch = {**batch, "occ_grid": self.occ_grid}
        return train_step(state, batch, weights, lrs, self.mc, rgb_loss_type, mesh=self.mesh)

    def run_steps(self, state: TrainState, scene, order, ref_order, epoch: int,
                  scheduling_start: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """len(order) steps over a device-resident SceneData (see train_steps);
        order/ref_order come from data.loader.epoch_order."""
        weights, lrs, rgb_loss_type = self._sched_at(epoch, scheduling_start)
        scene_stack = {"imgs": scene.imgs, "depths": scene.depths,
                       "depth_masks": scene.depth_masks, "K": scene.K,
                       "c2ws_gt": scene.c2ws_gt}
        small, rgb_pc = self._warp_frames(scene)
        if small is not None:
            scene_stack["imgs_small"] = small
            scene_stack["rgb_pc"] = rgb_pc
        if self.occ_grid is not None:
            scene_stack["occ_grid"] = self.occ_grid
        return train_steps(state, scene_stack, order, ref_order, weights, lrs, self.mc,
                           rgb_loss_type, mesh=self.mesh)

    def _warp_frames(self, scene):
        """Per-frame constants of the photometric warp, computed once per scene:
        the pc_ratio-downsampled images and the source-side samples
        rgb_pc1 = bilinear(img_small, fixed pixel grid): the ops the step
        would otherwise repeat every time."""
        if self.mc.pose is None:
            return None, None
        # keyed on the tensor object itself (kept alive in the cache tuple)
        if self._warp_cache is None or self._warp_cache[0] is not scene.imgs:
            imgs = scene.imgs
            h, w = imgs.shape[1:3]
            sh, sw = h // self.mc.pc_ratio, w // self.mc.pc_ratio
            p_pc = pixel_grid_on((sh, sw), imgs.device, imgs.dtype)
            small = torch.stack([resize_bilinear(im, (sh, sw)) for im in imgs])
            rgb_pc = torch.stack([get_tensor_values(sm, p_pc, mode="bilinear", scale=False,
                                                    align_corners=True) for sm in small])
            self._warp_cache = (imgs, small, rgb_pc)
        return self._warp_cache[1], self._warp_cache[2]

    def set_occupancy_grid(self, grid) -> None:
        """Install a grid (a checkpoint's). Ignored when the feature is off: a
        checkpoint of an occupancy run does not turn it on under a config that
        has it off. The grid goes to the device of the nerf params once the
        first update runs, or at once when one ran."""
        if not self._occ_enabled:
            return
        grid = torch.as_tensor(np.asarray(grid, np.float32))
        if grid.shape[0] != self._occ_res:
            print(f"WARNING: checkpointed occupancy grid is {grid.shape[0]}^3 but "
                  f"rendering.occupancy_res={self._occ_res}; keeping the checkpoint's "
                  "resolution for this run")
        self.occ_grid = self._globalize(
            grid if self.occ_grid is None else grid.to(self.occ_grid.device))

    def reset_occupancy(self) -> None:
        """A fresh all-ones grid (scheduling_mode reset discards the field the
        EMA describes)."""
        if self.occ_grid is not None:
            self.occ_grid = self._globalize(make_occupancy_grid(self._occ_res,
                                                                self.occ_grid.device))

    def update_occupancy(self, state: TrainState, epoch: int) -> None:
        """EMA-update the occupancy grid from the current field; call once per
        epoch. The grid is created on the first call whenever the feature is
        on, whatever the cadence; update_every <= 0 never updates it. The
        jitter of epoch e comes from a generator seeded with (17, e), so a
        resumed run draws what the straight run drew."""
        if not self._occ_enabled:
            return
        dev = state.params["nerf"]["density_w"].device
        if self.occ_grid is None:
            self.occ_grid = self._globalize(make_occupancy_grid(self._occ_res, dev))
            far = self.mc.render.depth_range[1]
            if far > self.mc.render.occ_radius:
                print(f"WARNING: rendering.depth_range far ({far}) exceeds the occupancy cube "
                      f"radius ({self.mc.render.occ_radius}); content beyond the cube only gets "
                      "floor-level sampling: set rendering.radius to cover the scene")
        self.occ_grid = self.occ_grid.to(dev)
        if self._occ_update_every <= 0 or epoch % self._occ_update_every:
            return
        gen = torch.Generator(device=dev).manual_seed(17 * 1_000_003 + epoch)
        self.occ_grid = self._globalize(update_occupancy_grid(
            self.occ_grid, state.params["nerf"], self.mc.nerf, radius=self.mc.render.occ_radius,
            decay=self._occ_decay, generator=gen))

    @torch.no_grad()
    def render_frame(self, state: TrainState, batch: Dict[str, Any],
                     resolution: Tuple[int, int], chunk: int = RENDER_CHUNK,
                     use_learned_pose: bool = True, sync: bool = True,
                     rows: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
        """Full-frame eval render in ray chunks, on the device of the state's
        params (reference render_visdata, training.py:103-165). Returns
        {'rgb': (h,w,3), 'depth': (h,w)} as numpy. `batch` is batch_for_frame's
        dict, of tensors or numpy arrays; the learned pose of frame
        batch['idx'] is used unless use_learned_pose is off (then
        batch['pose_gt']), with the learned focal and distortion when the
        config has them. The render kernel takes any ray count, so the last
        chunk is simply shorter.

        sync=False returns a pending frame (device tensors, nothing read
        back); pass it to finalize_frame. A caller that renders many frames
        queues the next one before it reads this one back.

        rows=(lo, hi) renders only that row slab: per-ray math is independent,
        so a slab equals the same rows of a full-frame render (the depth
        prior's area resize stays full-frame)."""
        h, w = resolution
        mc = self.mc
        params = state.params
        dev = params["nerf"]["density_w"].device

        def on_device(x):
            return torch.as_tensor(x).to(dev)

        idx = int(batch["idx"])
        if use_learned_pose and mc.pose is not None:
            world_mat = rigid_inverse(pose_c2w(params["pose"], idx, mc.pose))
        else:
            world_mat = rigid_inverse(on_device(batch["pose_gt"]))
        if mc.focal is not None:
            fxfy = focal_fxfy(params["focal"], mc.focal)
            camera_mat = camera_matrix_from_focal(fxfy[0], fxfy[1])
        else:
            camera_mat = on_device(batch["camera_mat"])
        depth_input = on_device(batch["depth"])
        if mc.distortion is not None:
            scale, shift = distortion_scale_shift(params["distortion"], idx, mc.distortion)
            depth_input = _apply_distortion(depth_input, scale[0], shift[0], mc.shift_first)
        depth_resized = resize_area(depth_input[..., None], (h, w)).reshape(-1)
        pixels_all = pixel_grid_on((h, w), dev, depth_resized.dtype)
        if rows is not None:
            lo, hi = rows
            pixels_all = pixels_all[lo * w:hi * w]
            depth_resized = depth_resized[lo * w:hi * w]
            h = hi - lo
        n = h * w
        rgbs, depths = [], []
        for i in range(0, n, chunk):
            out = render_nope_nerf(params["nerf"], pixels_all[i:i + chunk],
                                   depth_resized[i:i + chunk, None], camera_mat, world_mat,
                                   None, None, mc.render, mc.nerf, add_noise=False, eval_=True,
                                   need_aux=False)
            rgbs.append(out["rgb"])
            depths.append(out["depth_pred"])
        pending = {"rgb_chunks": rgbs, "depth_chunks": depths, "resolution": (h, w)}
        return self.finalize_frame(pending) if sync else pending

    @staticmethod
    def finalize_frame(pending: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Read back a pending render_frame(sync=False) result -> numpy dict."""
        h, w = pending["resolution"]
        rgb = torch.cat(pending["rgb_chunks"]).cpu().numpy()
        depth = torch.cat(pending["depth_chunks"]).cpu().numpy()
        return {"rgb": rgb.reshape(h, w, 3), "depth": depth.reshape(h, w)}

    def render_frame_multihost(self, state: TrainState, batch: Dict[str, Any],
                               resolution: Tuple[int, int], chunk: int = RENDER_CHUNK,
                               use_learned_pose: bool = True) -> Dict[str, np.ndarray]:
        """render_frame with the rows split over the ranks: each renders its
        host_image_tiles slab, the slabs (padded to ceil(h / ranks) rows) are
        gathered, and every rank returns the same assembled frame (callers
        gate file IO on rank 0). Per-ray math is independent, so the frame
        equals render_frame's. With one process: render_frame. The mesh is
        the Trainer's, else the initialised process group's."""
        mesh = self.mesh
        dev = state.params["nerf"]["density_w"].device
        if mesh is None and process_count() > 1:
            mesh = make_mesh(device=dev)
        if mesh is None or mesh.size == 1:
            return self.render_frame(state, batch, resolution, chunk=chunk,
                                     use_learned_pose=use_learned_pose)
        h, w = resolution
        lo, hi = host_image_tiles(h, mesh.rank, mesh.size)
        per = -(-h // mesh.size)
        slab = torch.zeros((per, w, 4), dtype=torch.float32, device=dev)  # rgb and depth
        if hi > lo:
            tile = self.render_frame(state, batch, resolution, chunk=chunk,
                                     use_learned_pose=use_learned_pose, rows=(lo, hi))
            slab[:hi - lo, :, :3] = torch.from_numpy(tile["rgb"])
            slab[:hi - lo, :, 3] = torch.from_numpy(tile["depth"])
        frame = all_gather_tiled(slab, mesh)[:h].cpu().numpy()
        return {"rgb": frame[..., :3].copy(), "depth": frame[..., 3].copy()}

    @torch.no_grad()
    def render_geo(self, state: TrainState, batch: Dict[str, Any], resolution: Tuple[int, int],
                   chunk: int = 1024, radius: float = 4.0, n_steps: int = 512) -> np.ndarray:
        """Phong geometry view of the current surface (reference render_visdata's
        vis_geo branch, training.py:146-163) on the device of the state's
        params, in chunks of `chunk` rays of n_steps density queries each:
        (h, w, 3) numpy. The learned pose of frame batch['idx'] is used when
        the config learns poses, else batch['pose_gt']."""
        from ..ops.phong import phong_render
        h, w = resolution
        mc = self.mc
        params = state.params
        dev = params["nerf"]["density_w"].device
        if mc.pose is not None:
            world_mat = rigid_inverse(pose_c2w(params["pose"], int(batch["idx"]), mc.pose))
        else:
            world_mat = rigid_inverse(torch.as_tensor(batch["pose_gt"]).to(dev))
        camera_mat = torch.as_tensor(batch["camera_mat"]).to(dev)
        pixels = pixel_grid_on((h, w), dev, camera_mat.dtype)
        rgbs = [phong_render(params["nerf"], pixels[i:i + chunk], camera_mat, world_mat, None,
                             mc.nerf, radius=radius, n_steps=n_steps)["rgb"]
                for i in range(0, h * w, chunk)]
        return torch.cat(rgbs).cpu().numpy().reshape(h, w, 3)

    @torch.no_grad()
    def reprojection_pair(self, state: TrainState, batch: Dict[str, Any]):
        """The photometric warp pair (rgb_pc1, rgb_pc1_proj, valid) as numpy
        images: the reference dumps these every vis_reprojection_every
        iterations (training.py:383-393). The pieces are compute_step_loss's."""
        mc = self.mc
        params = state.params
        img, ref_img = batch["img"], batch["ref_img"]
        h, w, _ = img.shape
        idx, ref_idx = int(batch["idx"]), int(batch["ref_idx"])
        nl = mc.nearest_limit
        world_mat = rigid_inverse(pose_c2w(params["pose"], idx, mc.pose))
        ref_Rt = rigid_inverse(pose_c2w(params["pose"], ref_idx, mc.pose))
        depth, depth_ref = batch["depth"], batch["ref_depth"]
        if mc.distortion is not None:
            s, sh = distortion_scale_shift(params["distortion"], idx, mc.distortion)
            depth = _apply_distortion(depth, s[0], sh[0], mc.shift_first)
            s2, sh2 = distortion_scale_shift(params["distortion"], ref_idx, mc.distortion)
            depth_ref = _apply_distortion(depth_ref, s2[0], sh2[0], mc.shift_first)
        camera_mat = batch["camera_mat"]

        fwd = idx < mc.pose.num_cams - 1
        d1 = depth if fwd else depth_ref
        img1, img2 = (img, ref_img) if fwd else (ref_img, img)
        Rt_rel = (ref_Rt @ rigid_inverse(world_mat) if fwd
                  else world_mat @ rigid_inverse(ref_Rt))

        sh_res = (h // mc.pc_ratio, w // mc.pc_ratio)
        p_pc = pixel_grid_on(sh_res, img.device, img.dtype)
        d1s = resize_nearest(d1[..., None], sh_res).reshape(-1).clamp_min(nl)
        pc1 = transform_to_world(p_pc, d1s[:, None], camera_mat)
        rgb_pc1 = get_tensor_values(resize_bilinear(img1, sh_res), p_pc, mode="bilinear",
                                    scale=False, align_corners=True)
        pc1_rot = pc1 @ Rt_rel[:3, :3].T + Rt_rel[:3, 3]
        invalid = (-pc1_rot[:, 2:]) < nl
        pc1_rot = torch.where(invalid.expand(pc1_rot.shape), torch.full_like(pc1_rot, nl),
                              pc1_rot)
        p_reproj, valid = project_to_cam(pc1_rot, camera_mat)
        rgb_proj = get_tensor_values(resize_bilinear(img2, sh_res), p_reproj, mode="bilinear",
                                     scale=False, align_corners=True)
        return (rgb_pc1.cpu().numpy().reshape(*sh_res, 3),
                rgb_proj.cpu().numpy().reshape(*sh_res, 3),
                valid.cpu().numpy().reshape(*sh_res))
