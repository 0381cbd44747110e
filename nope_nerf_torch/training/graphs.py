"""Captured CUDA graphs of the step bodies: the port's counterpart of jax.jit
and lax.scan.

The JAX package never runs a step as a loop of eager operations: the train
step is one jitted program, an epoch one lax.scan dispatch (training/
trainer.py::train_steps there, cli/train.py:282-318), and pose optimisation
runs chunks of epochs as one dispatch (evaluation/pose_opt.py::
_pose_opt_epochs). On the card the counterpart is a CUDA graph. A step body
that reads nothing back to the host (frame indices, schedule scalars and
Adam's count are device tensors) is run once eagerly on a side stream, its
effects undone, then captured whole, forward, autograd backward, the kernels
K1 to K7 and the in-place Adam updates; each step after that is one
replay, so the host no longer issues some 800 kernel launches a step.

CapturedStep owns the capture and the replay. What the body reads and
writes lives in tensors whose addresses the graph keeps (the state's, the
scene stack, the static buffers of its owner); its random draws come from a
generator registered with the graph, so a replay draws what the eager body
draws from the same generator state, and the generator's offset advances by
the same amount. A body that cannot be captured raises GraphCaptureError
naming the operation; nothing falls back to the eager loop. The kernel
wrappers count their launches in Python, which a replay skips: the capture
records each count's increase and every replay adds it again, so launch
counts through replays equal the eager ones.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..ops import chamfer, fused_mlp, fused_render  # noqa: F401  (their kernels' counters)
from ..ops._build import LIBRARIES, CudaLibrary


class GraphCaptureError(RuntimeError):
    """A step body that could not be captured in a CUDA graph."""


def launch_counts() -> Dict[CudaLibrary, int]:
    """Every kernel library's launch count."""
    return {lib: lib.launches for lib in LIBRARIES}


def failing_operation(err: BaseException) -> str:
    """Where `err`, or the exception it arose from, was raised: the innermost
    frame of its traceback outside torch's own modules and this one, as
    'dir/file:line in function: source'."""
    chain = []
    while err is not None and err not in chain:
        chain.append(err)
        err = err.__cause__ or err.__context__
    torch_dir = os.path.dirname(torch.__file__) + os.sep
    for e in reversed(chain):         # the first exception raised comes last
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if not f.filename.startswith(torch_dir) and f.filename != __file__]
        if frames:
            f = frames[-1]
            where = os.sep.join(f.filename.split(os.sep)[-2:])
            return f"{where}:{f.lineno} in {f.name}: {f.line}"
    return "an operation inside torch"


class CapturedStep:
    """One step body captured in a CUDA graph, and its replay.

    `body()` does the step's device work on the current stream. `mutated`
    are the tensors it updates in place (the state's, counters): the
    warm-up's updates to them are undone, and the generator's state is put
    back, so the first replay starts from what the caller handed over. The
    warm-up, on the capture's side stream, is the body's first run: the
    kernels' libraries load there, each launcher sets its function
    attributes, and the constant tensors the ops cache are uploaded, none of
    which may happen inside a capture. Its launches and the capture's are
    taken back out of the counters. `buffers` are the static tensors the
    owner fills before a replay and reads after it, kept with the graph."""

    def __init__(self, body: Callable[[], None], mutated: Sequence[torch.Tensor],
                 generator: torch.Generator, what: str,
                 buffers: Optional[Dict[str, Any]] = None):
        dev = generator.device
        self.what = what
        self.generator = generator
        self.buffers = buffers or {}
        counts = launch_counts()
        saved = [t.clone() for t in mutated]
        gen_state = generator.get_state()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                body()
                for t, s in zip(mutated, saved):
                    t.copy_(s)
            torch.cuda.current_stream(dev).wait_stream(stream)
            generator.set_state(gen_state)
            torch.cuda.synchronize(dev)
            del saved
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            warm = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(generator)
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(self.graph, stream=stream):
                    body()
            except Exception as err:
                raise GraphCaptureError(f"capturing {what} in a CUDA graph failed at "
                                        f"{failing_operation(err)}: {err}") from err
            self.capture_s = time.perf_counter() - t0
            self.pool_mb = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
            self.launches = {lib: lib.launches - warm[lib] for lib in LIBRARIES
                             if lib.launches != warm.get(lib, lib.launches)}
        finally:
            for lib in LIBRARIES:
                lib.launches = counts.get(lib, lib.launches)

    def replay(self) -> None:
        """One run of the captured body on the current stream."""
        self.graph.replay()
        for lib, n in self.launches.items():
            lib.launches += n


class GraphCache:
    """The captured steps of one owner, by key: a static signature (what the
    JAX package would compile anew for) and the addresses of every tensor
    the graph reads or writes. A key that changes (a state rebound to new
    tensors, another scene, another loss type) captures anew; the oldest
    graphs beyond `keep` are released with their memory pools."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self._steps: Dict[tuple, CapturedStep] = {}

    @staticmethod
    def key(static: tuple, bound: Sequence[torch.Tensor], generator: torch.Generator) -> tuple:
        return (static, id(generator),
                tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in bound))

    def get(self, key: tuple, generator: torch.Generator, capture: Callable[[], CapturedStep]
            ) -> CapturedStep:
        step = self._steps.get(key)
        if step is None or step.generator is not generator:
            step = capture()
            self._steps[key] = step
            while len(self._steps) > self.keep:
                old = self._steps.pop(next(iter(self._steps)))
                old.graph.reset()
        return step

    def steps(self):
        return list(self._steps.values())

    def clear(self) -> None:
        for step in self._steps.values():
            step.graph.reset()
        self._steps.clear()
