"""Spans opened from the benchmark's own files, the profiled segment of a
traced run, and what it reads.

Spans are ``torch.profiler`` ranges: one around each call into the program
(``portbench.step``), and ranges pushed and popped by forward pre-hooks and
hooks on the detector's modules (``portbench.model``, ``portbench.trunk``
on ``backbone.base``, ``portbench.decoder`` from ``backbone.dla_up`` into
``backbone.ida_up``, ``portbench.heads`` on ``heads``). A traced run
profiles a bounded number of steady steps after its measured window, exports
the profiler's trace to a temporary file, reads it and deletes it.

Device time is attributed to a span by the profiler's launch correlation:
a kernel, copy or memset belongs to the spans that hold the host call that
launched it. The device is busy where any of them runs (the union of their
intervals); the traced window runs from the first step's start to the last
step's end, and each step ends with its results on the host.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .counts import ForwardCount

STEP = "portbench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


@contextlib.contextmanager
def module_spans(model: torch.nn.Module) -> Iterator[None]:
    """Profiler ranges around the detector's layers while the body runs."""
    stack: List = []

    def enter(name):
        def hook(*_):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)
        return hook

    def leave(*_):
        stack.pop().__exit__(None, None, None)

    bb = model.backbone
    handles = [model.register_forward_pre_hook(enter("portbench.model")),
               model.register_forward_hook(leave),
               bb.base.register_forward_pre_hook(enter("portbench.trunk")),
               bb.base.register_forward_hook(leave),
               bb.dla_up.register_forward_pre_hook(enter("portbench.decoder")),
               bb.ida_up.register_forward_hook(leave),
               model.heads.register_forward_pre_hook(enter("portbench.heads")),
               model.heads.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@dataclass
class DeviceEvent:
    name: str
    cat: str
    ts: float  # us, the trace's clock
    dur: float
    launch: Optional[float]  # host time of the call that launched it


@dataclass
class Reading:
    """What a traced run read: the profiled steps' device events and spans,
    with the counts and rates that the per-layer metrics combine them
    with."""

    kind: str  # the traffic's loop: "infer" or "train"
    steps: int
    batch: int
    bf16: bool
    count: ForwardCount  # one forward at the run's batch
    images_per_s: float  # over the untraced window of the same run
    launches: Dict[str, int] = field(default_factory=dict)  # the program's DCN counters, per step
    device: List[DeviceEvent] = field(default_factory=list)
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _intervals(self) -> List[Tuple[float, float]]:
        t0, t1 = self.window
        spans = sorted((max(e.ts, t0), min(e.ts + e.dur, t1)) for e in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals()) * 1e-6

    def within(self, event: DeviceEvent, span: str) -> bool:
        t = event.launch
        return t is not None and any(a <= t <= b for a, b in self.spans.get(span, ()))

    def device_ms(self, within: str = STEP, outside: Sequence[str] = (),
                  cats: Sequence[str] = DEVICE_CATS,
                  match: Optional[Callable[[str], bool]] = None) -> float:
        """Device ms of the events of ``cats`` launched inside span
        ``within`` and outside every span of ``outside`` (whose name passes
        ``match``, where given), over the profiled steps."""
        us = sum(e.dur for e in self.device
                 if e.cat in cats and (match is None or match(e.name))
                 and self.within(e, within) and not any(self.within(e, o) for o in outside))
        return us * 1e-3

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the longest idle
        gaps of the traced window by what the host was doing, in seconds."""
        ops: Dict[str, float] = {}
        for e in self.device:
            ops[e.name] = ops.get(e.name, 0.0) + e.dur * 1e-6
        gaps: Dict[str, float] = {}
        idle = []  # (midpoint, length) of each gap between busy intervals
        t = self.window[0]
        for a, b in self._intervals() + [(self.window[1], self.window[1])]:
            if a > t:
                idle.append(((t + a) / 2, a - t))
            t = max(t, b)
        for (mid, length), name in zip(idle, self._innermost([m for m, _ in idle])):
            gaps[name] = gaps.get(name, 0.0) + length * 1e-6
        order = lambda d: sorted(([k[:160], v] for k, v in d.items()), key=lambda kv: -kv[1])  # noqa: E731
        return {"device_ops": order(ops)[:top], "idle_gaps": order(gaps)[:top]}


    def _innermost(self, points: List[float]) -> List[str]:
        """For each of the ascending ``points``, the shortest host call
        that holds it: one sweep over the host calls in start order, with
        the calls still open in a heap by their end."""
        calls = sorted(self.host, key=lambda h: h[1])
        open_calls: List[Tuple[float, float, str]] = []
        out, i = [], 0
        for p in points:
            while i < len(calls) and calls[i][1] <= p:
                name, ts, dur = calls[i]
                heapq.heappush(open_calls, (ts + dur, dur, name))
                i += 1
            while open_calls and open_calls[0][0] < p:
                heapq.heappop(open_calls)
            out.append(min((dur, name) for _, dur, name in open_calls)[1] if open_calls
                       else "(no host call)")
        return out


def profile_steps(step: Callable[[int], None], n: int, device: torch.device) -> dict:
    """Run ``step(i)`` for i < n under the profiler, each inside a
    ``portbench.step`` range; return the exported trace, read back from a
    temporary file, which is deleted."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for i in range(n):
            with torch.autograd.profiler.record_function(STEP):
                step(i)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def read_trace(trace: dict, **fields) -> Reading:
    """A :class:`Reading` of an exported trace; ``fields`` fills the rest."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    r = Reading(**fields)
    for e in events:
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            r.device.append(DeviceEvent(e["name"], cat, ts, dur,
                                        launch.get(e.get("args", {}).get("correlation"))))
        elif cat == "user_annotation":
            r.spans.setdefault(e["name"], []).append((ts, ts + dur))
        if cat in HOST_CATS:
            r.host.append((e["name"], ts, dur))
    steps = r.spans.get(STEP, [])
    if steps:
        r.window = (min(a for a, _ in steps), max(b for _, b in steps))
    return r
