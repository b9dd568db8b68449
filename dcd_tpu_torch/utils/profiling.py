"""Step tracing and timing, the counterpart of ``dcd_tpu/utils/profiling.py``.

The reference times the forward with a tic/toc timer around
``torch.cuda.synchronize`` (DGDE/engine/inference.py:39-46); the JAX package
traces with ``jax.profiler``. Here: a ``torch.profiler`` session that writes a
chrome trace (CPU and, when a card is present, its kernels), named regions
for that trace, and a step-time meter that waits for the card before it
reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_session(logdir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the body and write ``logdir/trace.json`` (chrome trace
    format: ``chrome://tracing``, Perfetto); yields the profiler, whose
    ``key_averages()`` sums the kernels. A no-op when ``logdir`` is None."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def step_annotation(name: str) -> torch.profiler.record_function:
    """A named region of the trace (``with step_annotation("train"): ...``)."""
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock step meter. ``start`` and ``stop`` first wait for the card
    (when the process has used it): a launch returns before its kernels
    finish, so a clock read without the wait measures the enqueue. The first
    ``warmup`` steps are left out of ``times``."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0 = 0.0
        self._count = 0

    def start(self) -> None:
        _sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """Seconds since :meth:`start`, after the card's queue has drained
        (every launch of the process, so no result needs fetching, unlike
        the JAX meter's ``stop(result)``)."""
        _sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
