"""Windowed metric smoothing (reference DGDE/utils/metric_logger.py:8-74); a
copy of the JAX package's ``dcd_tpu/utils/metrics.py``."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Deque


class SmoothedValue:
    """Track a series and provide smoothed values over a window."""

    def __init__(self, window_size: int = 20):
        self.deque: Deque[float] = deque(maxlen=window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        value = float(value)
        self.deque.append(value)
        self.series.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter.median:.4f} ({meter.global_avg:.4f})"
            for name, meter in self.meters.items()
        )
