"""The process mesh: one process per device over a 1-axis ('data',) layout.

Port of nope_nerf_tpu/parallel/mesh.py. The JAX package builds a jax Mesh
of devices and shards the ray batch over its 'data' axis inside one SPMD
program. Here each device is driven by a process of its own, joined by
torch.distributed, as the JAX package treats a multi-host run
(parallel/multihost.py): a Mesh holds the world size, this process's rank,
its device and the process group.

make_mesh joins the group the environment describes (`env://`, as
`python3 -m torch.distributed.run` sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT) when no group exists yet, or a one-process
group in memory when the environment names none; a caller that has
initialised a group itself (a `file://` rendezvous, say) gets that one.
Each rank drives cuda:{LOCAL_RANK % device_count}, the CPU only when asked.
NCCL is the backend on CUDA, gloo on the CPU; gloo also runs CUDA tensors
(broadcast and all-reduce, staged through the host), which lets two ranks
share one card, where NCCL refuses.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import DeviceLike

TIMEOUT_S = 600.0   # a rendezvous or collective that waits longer raises


@dataclasses.dataclass(frozen=True)
class Mesh:
    """World size, this process's rank and device, the backend and the
    process group of a 1-axis ('data',) mesh."""
    size: int
    rank: int
    device: torch.device
    backend: str
    group: Any


def launch_hint(n: int) -> str:
    return (f"python3 -m torch.distributed.run --nproc_per_node {n} "
            "-m nope_nerf_torch.cli.train <config>")


def _rank_device(device: DeviceLike) -> torch.device:
    """cuda:{LOCAL_RANK % device_count} for None or a bare 'cuda'; raises
    when there is no CUDA device; the CPU only when asked for."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to this rank; pass device='cpu' "
                           "to build a mesh of CPU processes")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
              device: DeviceLike = None, axis_names: Sequence[str] = ("data",)) -> Mesh:
    """The mesh of this process group, initialised here when none exists.
    Raises when the group's world size is not `n_devices` (None: any)."""
    if len(axis_names) != 1:
        raise NotImplementedError("only 1-axis meshes are used; rays are the one scalable "
                                  "axis for this workload")
    dev = _rank_device(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if n_devices is not None and world != n_devices:
            raise ValueError(f"a multi-device mesh of {n_devices} processes was asked for, "
                             f"but this run has a world size of {world}: launch it as "
                             f"`{launch_hint(n_devices)}`")
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    timeout=timeout)
    world = dist.get_world_size()
    if n_devices is not None and world != n_devices:
        raise ValueError(f"a multi-device mesh of {n_devices} processes was asked for, but "
                         f"the process group has {world}: launch it as "
                         f"`{launch_hint(n_devices)}`")
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"the process group runs {have}, not the {backend} asked for")
    if have == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL runs CUDA tensors only: a CPU mesh needs gloo")
    return Mesh(size=world, rank=dist.get_rank(), device=dev, backend=have,
                group=dist.group.WORLD)


def default_mesh(cfg: Optional[dict] = None, backend: Optional[str] = None,
                 device: DeviceLike = None) -> Mesh:
    """The mesh of cfg's tpu.mesh_shape (its product is the process count;
    unset: whatever the group holds)."""
    n = None
    if cfg is not None and cfg.get("tpu", {}).get("mesh_shape"):
        n = int(np.prod(cfg["tpu"]["mesh_shape"]))
    return make_mesh(n, backend=backend, device=device)
