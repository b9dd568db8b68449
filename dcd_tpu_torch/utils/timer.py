"""tic/toc averaging timer for inference throughput (reference
DGDE/utils/timer.py:8-45), the counterpart of the JAX package's
``dcd_tpu/utils/timer.py``: on the card, ``toc`` first waits for the device
with ``torch.cuda.synchronize``, so that a call's time is its device work and
not its enqueue."""

from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self, device: torch.device = torch.device("cpu")):
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tic(self):
        self._sync()
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self._sync()
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        return self.average_time if average else self.diff

    @property
    def average_time(self) -> float:
        return self.total_time / max(self.calls, 1)
