"""Tracing / profiling utilities (SURVEY.md §5: the reference has none; here
the north-star observable is steps/sec/world plus per-phase attribution).

- `trace(path)`: context manager around any jitted region, writes a
  TensorBoard-compatible trace via jax.profiler.
- `Throughput`: simple steps/sec/world counter for run loops.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block: `with trace('/tmp/tb'): run()`."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Throughput:
    """Steps/sec(/world) counter with exponential smoothing."""

    def __init__(self, n_worlds: int = 1, alpha: float = 0.2):
        self.n_worlds = n_worlds
        self.alpha = alpha
        self.rate = None
        self._t = None
        self._steps = 0

    def tick(self, steps: int = 1):
        now = time.perf_counter()
        if self._t is not None:
            inst = steps / max(now - self._t, 1e-9)
            self.rate = (
                inst if self.rate is None
                else self.alpha * inst + (1 - self.alpha) * self.rate
            )
        self._t = now
        self._steps += steps
        return self.rate

    @property
    def steps_per_sec_per_world(self):
        return self.rate

    @property
    def aggregate_steps_per_sec(self):
        return None if self.rate is None else self.rate * self.n_worlds
