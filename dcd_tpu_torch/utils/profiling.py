"""Step tracing and timing, the counterpart of ``dcd_tpu/utils/profiling.py``.

The reference times the forward with a tic/toc timer around
``torch.cuda.synchronize`` (DGDE/engine/inference.py:39-46); the JAX package
traces with ``jax.profiler``. Here: a ``torch.profiler`` session that writes a
chrome trace (CPU and, when a card is present, its kernels), the named spans
that the port opens at its layer boundaries for that trace, and a step-time
meter that waits for the card before it reads the clock.

The port's spans (:func:`span`), one per call where each is opened:

* inference: ``dcd.infer`` (``engine/infer.py::infer``), inside it
  ``dcd.infer.h2d`` (the inputs' copies), ``dcd.model``
  (``KeypointDetector.forward``), ``dcd.postprocess``; inside the model
  ``dcd.trunk`` (DLA-34), ``dcd.decoder`` (DLAUp and IDAUp), inside it
  ``dcd.upsample`` (each upsampling with the add after it, one kernel) and
  ``dcd.dcn`` (each DCN: the offset conv and the deformable conv; the
  deeper head's stems open it inside ``dcd.heads``), then ``dcd.heads``
  (``Predictor.forward``);
* training: ``dcd.train_step``, inside it ``dcd.train.h2d``
  (``batch_to_device``), then per microbatch ``dcd.train.forward`` (the
  model's spans nest inside), ``dcd.train.loss`` and
  ``dcd.train.backward``, then ``dcd.train.grad_norm`` (the logs' norm) and
  ``dcd.optimizer`` (``Optimizer.step``; ``dcd.optimizer.clip`` and torch's
  own ``Optimizer.step#AdamW.step`` inside);
* stage 2 and data parallelism: ``gmw.towers``, ``gmw.cost_matrix``,
  ``sinkhorn.scaling``, ``sinkhorn.vjp``, ``sinkhorn.schur_product``,
  ``sinkhorn.cholesky`` and ``parallel.all_reduce_sum``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import ContextManager, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

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


_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A named span of the trace (``with span("dcd.model"): ...``).

    While a profiler runs (:func:`trace_session`, or any
    ``torch.profiler.profile``) this is a ``record_function`` range: the
    profiler records it on the clock of the card's events, so a reader of
    the trace can give each kernel, copy or idle gap to the spans that held
    the host call that launched it (launch correlation). Without a profiler
    it is one check and a shared no-op context; ``record_function`` is not
    entered.

    A backward's kernels launch from autograd's device thread while the
    calling thread waits inside its span (``dcd.train.backward``); the
    spans hold them by launch time, not by thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)


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
