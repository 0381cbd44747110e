"""Multi-process coordination helpers.

Port of nope_nerf_tpu/parallel/multihost.py. The recipe is the JAX
package's:

- params are replicated; every process feeds the same per-step frame (the
  frame schedule derives from the seed and the epoch, so processes agree
  without communication);
- the global ray batch shards over the processes of the mesh;
- eval rendering splits image rows across processes (each renders rows
  [lo, hi) of the pixel grid) and every process assembles the frame;
- checkpoint IO is gated on process 0 (training/checkpoints.py), and
  rank 0 loads a scene first (`rank_zero_first`), since the processes of one
  host share the scene's image caches.

The slice helpers are pure functions of (process_index, process_count),
testable in one process by passing both. Without an initialised process
group the index is 0 and the count 1.

`run_ranks` starts the processes of a local multi-process run (tests and
chip_smoke.py use it) and fails the whole run when one of them fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import subprocess
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .sharding import broadcast_


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_index, _count = process_index, process_count   # the slice helpers' parameters shadow the names


def _tensors(tree, out: List[torch.Tensor]) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out)


@torch.no_grad()
def globalize_replicated(tree, mesh):
    """Every tensor of `tree` (nested dicts, lists, tuples and dataclasses
    such as a TrainState) overwritten in place by rank 0's values, and a
    torch.Generator field of a dataclass `tree` set to rank 0's state. Every
    rank builds the same values from the shared seed already; the broadcast
    makes that hold by construction. Returns `tree`; a no-op on a mesh of
    one."""
    if mesh is None or mesh.size == 1:
        return tree
    leaves: List[torch.Tensor] = []
    _tensors(tree, leaves)
    for t in leaves:
        broadcast_(t, mesh)
    for f in dataclasses.fields(tree) if dataclasses.is_dataclass(tree) else ():
        gen = getattr(tree, f.name)
        if isinstance(gen, torch.Generator):
            gen.set_state(broadcast_(gen.get_state(), mesh))
    return tree


@contextlib.contextmanager
def rank_zero_first(mesh) -> Iterator[None]:
    """Rank 0 runs the block before the other ranks start it, so what it
    writes on the way (a scene's minified image caches) is whole on disk when
    they read it. A no-op without a mesh of several ranks."""
    multi = mesh is not None and mesh.size > 1
    if multi and mesh.rank != 0:
        dist.barrier(group=mesh.group)
    try:
        yield
    finally:
        if multi and mesh.rank == 0:
            dist.barrier(group=mesh.group)


def host_frame_schedule(n_frames: int, epoch: int, seed: int,
                        shuffle: bool = True) -> np.ndarray:
    """Deterministic per-epoch frame order, identical on every process: all
    derive it from (seed, epoch)."""
    rng = np.random.RandomState(seed * 100003 + epoch)
    return rng.permutation(n_frames) if shuffle else np.arange(n_frames)


def host_ray_slice(n_rays: int, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of the global ray batch owned by this process."""
    pi = _index() if process_index is None else process_index
    pc = _count() if process_count is None else process_count
    if n_rays % pc:
        raise ValueError(f"the global ray batch of {n_rays} does not divide across "
                         f"{pc} processes")
    per = n_rays // pc
    return pi * per, (pi + 1) * per


def host_image_tiles(h: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> Tuple[int, int]:
    """Row range [lo, hi) of an image this process renders during eval:
    disjoint tiles of ceil(h / count) rows (the last may be short or empty)."""
    pi = _index() if process_index is None else process_index
    pc = _count() if process_count is None else process_count
    per = (h + pc - 1) // pc
    return min(pi * per, h), min((pi + 1) * per, h)


def run_ranks(commands: Sequence[Sequence[str]], timeout_s: float,
              env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None) -> List[str]:
    """Run one process per command side by side, each in a session of its
    own; return their outputs (stdout and stderr together) in order. When
    one exits non-zero, or the run outlasts `timeout_s`, every other is
    killed and RuntimeError names the failure with the tail of each output:
    a peer left waiting in a collective never hangs the caller. On the way
    out every process of each session is killed, so nothing a command
    started outlives the call."""
    procs = [subprocess.Popen(list(c), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, cwd=cwd, start_new_session=True) for c in commands]
    readers = [_Drain(p) for p in procs]
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks did not finish within {timeout_s:.0f} s"
                break
            time.sleep(0.05)
        else:
            bad = [i for i, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with code {procs[bad[0]].returncode}"
    finally:
        for p in procs:      # each in a session of its own: a launcher's children go too
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in procs:
            p.wait()
    outs = [r.text() for r in readers]
    if failed:
        tails = "\n".join(f"--- rank {i} ---\n{o[-4000:]}" for i, o in enumerate(outs))
        raise RuntimeError(f"{failed}; the other ranks were stopped\n{tails}")
    return outs


class _Drain:
    """Reads a process's output on a thread, so a full pipe never blocks it."""

    def __init__(self, proc: subprocess.Popen):
        import threading
        self._chunks: List[bytes] = []
        self._thread = threading.Thread(target=self._read, args=(proc.stdout,), daemon=True)
        self._thread.start()

    def _read(self, stream) -> None:
        for chunk in iter(lambda: stream.read(65536), b""):
            self._chunks.append(chunk)
        stream.close()

    def text(self) -> str:
        self._thread.join(timeout=30)
        return b"".join(self._chunks).decode(errors="replace")
