"""What a traced run reads under the program's own spans.

The program opens ``torch.profiler`` ranges at its layer boundaries
(``dcd_tpu_torch/utils/profiling.py::span``: ``dcd.infer``, ``dcd.model``,
``dcd.dcn``, ``dcd.train.backward``, ``dcd.optimizer`` and the rest). They
arrive in a :class:`~portbench.harness.trace.Reading`'s ``spans`` beside the
harness's own. A program that opens none (an older tree) leaves every reader
here with nothing to read: they return None and raise nothing.

Device work goes to a span by launch time, as ``Reading.within`` gives it:
a backward's kernels, launched from autograd's device thread while the
calling thread waits in ``dcd.train.backward``, belong to that span. Idle
time is the traced window less the union of the device's intervals, as
``Reading.busy_s`` takes it, cut where the host's spans open and close.
"""

from __future__ import annotations

import bisect
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import Reading

PREFIX = "dcd."
# the host's kernel launch calls, through the runtime API and the lower-level cu* API
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
OUTSIDE = "outside the program"
NO_CALL = "(no host call)"  # Reading._innermost's name for a point no call holds


def present(r: Reading, kind: str, names: Sequence[str]) -> bool:
    """The run is of loop ``kind``, traced the card, and the program opened
    at least one of the spans ``names``."""
    return r.kind == kind and bool(r.device) and any(n in r.spans for n in names)


def device_ms_per_step(r: Reading, kind: str, names: Sequence[str]) -> Optional[float]:
    """Device ms per profiled step launched inside the spans ``names``
    (spans that never overlap: each event counts once), or None where
    :func:`present` is false."""
    if not present(r, kind, names):
        return None
    return sum(r.device_ms(within=n) for n in names) / r.steps


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle(r: Reading) -> List[Tuple[float, float]]:
    """The traced window's intervals (us) in which no kernel, copy or memset
    ran: the complement of the union ``Reading.busy_s`` sums."""
    t0, t1 = r.window
    out, t = [], t0
    for a, b in r._intervals():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t1 > t:
        out.append((t, t1))
    return out


def idle_ms_under(r: Reading, names: Sequence[str]) -> float:
    """Idle ms of the traced window while the host was inside any span of
    ``names``."""
    spans = _merged([iv for n in names for iv in r.spans.get(n, ())])
    starts = [a for a, _ in spans]
    us = 0.0
    for a, b in idle(r):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(spans) and spans[i][0] < b:
            us += max(0.0, min(b, spans[i][1]) - max(a, spans[i][0]))
            i += 1
    return us * 1e-3


def launch_calls(r: Reading, name: str) -> int:
    """The host's kernel launch calls (:data:`LAUNCH_CALLS`, on any thread)
    that started inside a span ``name``."""
    spans = r.spans.get(name, ())
    return sum(1 for call, ts, _ in r.host if call.startswith(LAUNCH_CALLS)
               and any(a <= ts <= b for a, b in spans))


def idle_by_span(r: Reading, prefix: str = PREFIX) -> Dict[str, float]:
    """The traced window's idle seconds by the innermost span whose name
    starts with ``prefix`` that the host was in, cut at every such span's
    start and end; :data:`OUTSIDE` where it was in none (the harness's feed
    and its reads of results). The parts sum to the window's idle."""
    spans = [(n, a, b - a) for n, ivs in r.spans.items() if n.startswith(prefix)
             for a, b in ivs]
    cuts = sorted({x for _, a, d in spans for x in (a, a + d)})
    pieces = []
    for a, b in idle(r):
        edges = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
        pieces += [(p, q) for p, q in zip(edges, edges[1:]) if q > p]
    # the reading's own sweep for the shortest host call at each point,
    # over these spans as the host's calls
    names = replace(r, host=spans)._innermost([(p + q) / 2 for p, q in pieces])
    out: Dict[str, float] = {}
    for (p, q), name in zip(pieces, names):
        name = OUTSIDE if name == NO_CALL else name
        out[name] = out.get(name, 0.0) + (q - p) * 1e-6
    return out
