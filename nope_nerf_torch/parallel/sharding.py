"""Ray-sharded training: the collectives of the sharded step and its entry points.

Port of nope_nerf_tpu/parallel/sharding.py. The JAX package shards the
per-step ray batch over the mesh's 'data' axis with shard_map inside
compute_step_loss; the parameters are replicated, and the gradient
all-reduce is what shard_map's transpose makes of its psums. Here every
process runs the step on its share of the rays (training/trainer.py,
mesh=), and three autograd functions play the part of shard_map's
collectives and their transposes:

- psum: all-reduce SUM forward; backward the identity, since the cotangent
  of a replicated output is already whole on every rank;
- pvary: identity forward; backward all-reduce SUM. Every replicated tensor
  that enters the per-shard computation goes through it, so the shard's
  gradient sums over ranks while the gradients of terms computed once on
  every rank (the frame pair's) are not multiplied by the world size;
- all_gather_tiled: gather along dim 0 forward; backward this rank's rows.

(torch.distributed.nn.functional's all_reduce sums the cotangent in its
backward as well: every gradient through it would come out world-size times
too large.) All three are built on all_reduce: a gather is an all-reduce of
a zero buffer in which each rank writes its own rows, which is exact, and
gloo offers only broadcast and all-reduce on CUDA tensors.

Every rank must call the collectives in the same order. The sharded step
does: the same code runs on every rank, and autograd's order over one
graph is fixed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A fresh copy of `t` the backend can reduce: bool as uint8, and on the
    mesh's device when the backend is NCCL."""
    dev = mesh.device if mesh.backend == "nccl" else t.device
    dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
    return t.detach().to(device=dev, dtype=dtype, copy=True).contiguous()


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """SUM over the mesh, as a new tensor of t's device and dtype."""
    buf = _wire(t, mesh)
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(device=t.device, dtype=t.dtype)


@torch.no_grad()
def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Overwrite `t` in place with rank 0's values."""
    buf = _wire(t, mesh)
    dist.broadcast(buf, src=0, group=mesh.group)
    t.copy_(buf.to(device=t.device, dtype=t.dtype))
    return t


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh), None


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        n = x.shape[0]
        ctx.rows = (mesh.rank * n, (mesh.rank + 1) * n)
        buf = torch.zeros((mesh.size * n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        buf[ctx.rows[0]:ctx.rows[1]] = x
        return all_reduce(buf, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows[0]:ctx.rows[1]], None


def psum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x summed over the mesh's ranks; x itself without a mesh."""
    return x if mesh is None else _PSum.apply(x, mesh)


def pvary(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x, whose gradient sums over the mesh's ranks. Without a mesh an alias
    of x: the gradients that reach the alias arrive at x as one sum, as they
    do through pvary, so a step on a mesh of one adds in the same order as
    the step without a mesh."""
    return x.view_as(x) if mesh is None else _PVary.apply(x, mesh)


def all_gather_tiled(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in rank order (all ranks'
    x of one shape); x itself without a mesh."""
    return x if mesh is None else _AllGatherTiled.apply(x, mesh)


def sharded_compute_step_loss(mesh: Mesh, *args, **kwargs):
    """compute_step_loss with the render fanned out over the mesh."""
    from ..training.trainer import compute_step_loss
    return compute_step_loss(*args, **kwargs, mesh=mesh)


def make_sharded_train_step(mesh: Mesh, mc, rgb_loss_type: str = "l1"):
    """step(state, batch, weights, lrs) over `mesh` (Adam is written out in
    the port, so no optimizer objects are passed)."""
    from ..training.trainer import train_step

    def step(state, batch, weights, lrs, **pins):
        return train_step(state, batch, weights, lrs, mc, rgb_loss_type, mesh=mesh, **pins)
    return step
