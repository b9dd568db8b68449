"""One run of a cell: its loop, its metrics, its checks, its result line."""

from __future__ import annotations

import json
import sys
from typing import Callable, Dict, Optional

import torch

from . import judge
from .loops import LOOPS
from .spec import Cell, metric_reader

# the host's intra-op threads: one, as the loops run no large host operation
# (a host-bound training step spread less so on the card: PERF.md)
HOST_THREADS = 1


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device,
        setup_clock: Callable[[], float], marks: Optional[Dict] = None) -> Dict:
    """Run ``cell`` once and return its result object (not yet printed);
    ``marks``: the set-up's earlier phases, reported with the loop's."""
    torch.set_num_threads(HOST_THREADS)
    out = LOOPS[cell.traffic["loop"]](cell, seed, seconds, trace, dev, setup_clock)
    out.info["phases_s"] = {**(marks or {}), **out.info["phases_s"]}
    units = {m["name"]: m["unit"] for m in cell.metrics}
    metrics = {}
    if trace:
        for m in cell.metrics:
            value = metric_reader(m["name"], cell.root)(out.reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for name, unit in units.items():
            metrics[name] = {"value": float(out.end_to_end[name]), "unit": unit}
    limits = cell.limits["limits"]
    checks = {k: {"value": out.numbers[k], "limit": limits[k]} for k in limits}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": judge.verdict(out.numbers, limits), "attempted": out.attempted,
              "failed": 0, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out.reading.busy_s
        device["window_s"] = out.reading.window_s
        result["breakdown"] = out.reading.breakdown()
    result["info"] = out.info
    result["checks"] = checks
    return result


def emit(result: Dict) -> None:
    """The info line and the compared numbers on standard error (the
    numbers last), then the result as the last line of standard output."""
    print("portbench: " + json.dumps(result.get("info", {}), default=str), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"portbench check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
