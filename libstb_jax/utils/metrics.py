"""Throughput counters and profiling hooks.

The reference's observability is ad-hoc clock_gettime timing in test
programs plus per-table byte counters (SURVEY.md §5.1).  Here:

* ``Meter`` -- named rate counters (cells/s for fills, samples/s for
  sampler steps, acceptance fractions) with a one-line report in the
  spirit of S_report (stable.c:1025-1055);
* ``device_timer`` -- wall-time a device computation (dispatch is async,
  so each timing waits for the outputs with ``block_until_ready``);
* ``trace`` -- context manager around jax.profiler for TensorBoard-style
  traces.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable

import jax

__all__ = ["Meter", "device_timer", "trace"]


@dataclass
class Meter:
    """Accumulating rate meter: ``add(units, seconds)`` then ``rate``."""
    name: str
    unit: str = "items/s"
    units: float = 0.0
    seconds: float = 0.0
    calls: int = field(default=0)

    def add(self, units: float, seconds: float):
        self.units += units
        self.seconds += seconds
        self.calls += 1

    @property
    def rate(self) -> float:
        return self.units / self.seconds if self.seconds > 0 else 0.0

    def report(self) -> str:
        return (f"{self.name}: {self.rate:.4g} {self.unit} "
                f"({self.units:.4g} in {self.seconds:.3f}s, {self.calls} calls)")


def device_timer(fn: Callable, *args, reps: int = 3) -> float:
    """Best-of-``reps`` seconds for fn(*args), each timing ending when
    every output is ready on the device (``jax.block_until_ready``).
    The first call compiles and warms, off the clock."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace scope (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
