"""Profiling and the throughput meter of the training loop.

Port of nope_nerf_tpu/utils/profiling.py:
- `profile_trace`: a context manager that records a torch.profiler trace of
  its block into a Chrome trace file under `log_dir` (the JAX package's
  wraps jax.profiler);
- `summarize_trace`: the per-op time table of the newest trace there, from
  its leaf events;
- `StepTimer`: rolling steps/s and rays/s.
nope_nerf_torch/tools/profile_train.py profiles the train step by the
profiler's own tables.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from collections import deque
from typing import Iterator, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")   # the card's events in a trace


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Record the block with torch.profiler (the CPU, and the card when CUDA
    is available) and write it as a gzipped Chrome trace
    `<log_dir>/trace_<pid>_<ns>.pt.trace.json.gz` (chrome://tracing or
    Perfetto opens it). A no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json.gz"))


def summarize_trace(log_dir: str, steps: int = 1, top: int = 20
                    ) -> List[Tuple[float, float, str]]:
    """Per-op time table of the newest Chrome trace under `log_dir`.

    Keeps the events of one device: the card's kernels, copies and sets when
    the trace holds any, else the CPU's operators. Each event counts its self time: its
    duration less that of the events nested in it on the same thread (the
    card's kernels do not nest; an operator that only calls others is a
    wrapper, not work). Divide by `steps` when the traced block ran that
    many steps.

    Returns [(ms_per_step, count_per_step, name), ...], largest first."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.trace.json*"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace files under {log_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    on_card = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    events = on_card or [e for e in events if e.get("cat") == "cpu_op"]

    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e["pid"], e["tid"])].append(e)
    entries = []                # [name, duration less the events nested in it]
    for es in by_thread.values():
        es.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []        # the events still open at the current one
        for e in es:
            while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                stack[-1][1][1] -= e["dur"]
            entry = [e["name"], e["dur"]]
            entries.append(entry)
            stack.append((e, entry))
    self_time: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for name, dur in entries:
        self_time[name] += dur
        count[name] += 1
    return [(dur / steps / 1e3, count[name] / steps, name)
            for name, dur in self_time.most_common(top)]


class StepTimer:
    """Rolling steps/s and rays/s: call tick() once per step, or tick_many(n)
    after a chunk of n steps whose end the caller has waited for."""

    def __init__(self, rays_per_step: int, window: int = 100):
        self.rays_per_step = rays_per_step
        self.times: deque = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        self.tick_many(1)

    def tick_many(self, n: int) -> None:
        """Record n steps completed since the last tick; each gets an equal
        share of the elapsed time."""
        now = time.perf_counter()
        if self._last is not None and n > 0:
            self.times.extend([(now - self._last) / n] * n)
        self._last = now

    @property
    def steps_per_s(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    @property
    def rays_per_s(self) -> float:
        return self.steps_per_s * self.rays_per_step

    def summary(self) -> str:
        return f"{self.steps_per_s:.2f} steps/s, {self.rays_per_s:,.0f} rays/s"
