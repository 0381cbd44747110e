"""Throughput meter for the training loop.

Port of nope_nerf_tpu/utils/profiling.py::StepTimer. The JAX package's
`profile_trace` wraps jax.profiler; the port profiles with torch.profiler in
nope_nerf_torch/tools/profile_train.py instead.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional


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
