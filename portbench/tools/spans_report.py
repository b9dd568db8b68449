"""One traced run of a cell, read under the program's own spans.

    python3 -m portbench.tools.spans_report --workload <cell> --seed <n> --seconds <s> --out <file.json>

It runs the cell's loop as ``run.py --trace 1`` does and writes one JSON
object: the cell's per-layer metrics, the traced step's host ms, the cost of
one span entered and left with no profiler, and for every ``dcd.*`` span its
count, host ms and the device ms launched inside it, per step. Then the
checks that the spans and the card's clock agree: the traced window's idle
split by the innermost ``dcd.*`` span the host was in (the parts and the
whole); inference: the ``dcn_fwd_kernel`` launches under ``dcd.dcn`` and the
device events under ``portbench.model`` but outside ``dcd.model``; training:
the forward, loss, backward and update against the device ms under
``dcd.train_step``, what the step launched in none of them, and the launch
calls by name. It needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from portbench.harness import judge, spans, spec
from portbench.harness.loops import LOOPS
from portbench.harness.trace import DEVICE_CATS

TRAIN_PARTS = ("dcd.train.forward", "dcd.train.loss", "dcd.train.backward",
               "dcd.train.grad_norm", "dcd.optimizer")


def span_cost_us(n: int = 10 ** 6) -> float:
    """Microseconds of one ``span`` entered and left with no profiler."""
    from dcd_tpu_torch.utils.profiling import span

    t0 = time.perf_counter()
    for _ in range(n):
        with span("dcd.cost"):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def by_span(r) -> Dict[str, Dict[str, float]]:
    out = {}
    for name, ivs in sorted(r.spans.items()):
        if name.startswith(spans.PREFIX):
            out[name] = {"count": len(ivs) / r.steps,
                         "host_ms": 1e-3 * sum(b - a for a, b in ivs) / r.steps,
                         "device_ms": r.device_ms(within=name) / r.steps}
    return out


def checks(r) -> Dict[str, object]:
    idle = spans.idle_by_span(r)
    out: Dict[str, object] = {
        "idle_ms_per_step": {k: 1e3 * v / r.steps for k, v in sorted(idle.items(),
                                                                       key=lambda kv: -kv[1])},
        "idle_parts_s": sum(idle.values()), "idle_whole_s": r.window_s - r.busy_s}
    if r.kind == "infer":
        out["dcn_fwd_kernel_under_dcd_dcn"] = sum(
            1 for e in r.device if e.cat == "kernel" and "dcn_fwd_kernel" in e.name
            and r.within(e, "dcd.dcn"))
        out["model_events_outside_dcd_model"] = sum(
            1 for e in r.device if r.within(e, "portbench.model") and not r.within(e, "dcd.model"))
        out["model_events"] = sum(1 for e in r.device if r.within(e, "portbench.model"))
        return out
    step = r.device_ms(within="dcd.train_step") / r.steps
    parts = sum(r.device_ms(within=n) for n in TRAIN_PARTS) / r.steps
    rest: Dict[str, float] = {}
    for e in r.device:
        if (e.cat in DEVICE_CATS and r.within(e, "dcd.train_step")
                and not any(r.within(e, n) for n in TRAIN_PARTS)):
            where = "dcd.train.h2d" if r.within(e, "dcd.train.h2d") else "between spans"
            key = f"{where}: {e.name[:80]}"
            rest[key] = rest.get(key, 0.0) + 1e-3 * e.dur / r.steps
    calls: Dict[str, int] = {}
    for name, ts, _ in r.host:
        if name.startswith(spans.LAUNCH_CALLS) and any(
                a <= ts <= b for a, b in r.spans.get("dcd.train_step", ())):
            calls[name] = calls.get(name, 0) + 1
    out.update(train_step_device_ms=step, parts_device_ms=parts,
               parts_share=parts / step if step else None,
               outside_parts_ms=dict(sorted(rest.items(), key=lambda kv: -kv[1])[:12]),
               launch_calls=calls,
               kernels_launched_in_step=sum(1 for e in r.device if e.cat == "kernel"
                                            and r.within(e, "dcd.train_step")) / r.steps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload, True)
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    run = LOOPS[cell.traffic["loop"]](cell, args.seed, args.seconds, True, dev,
                                      lambda: time.perf_counter() - t0)
    r = run.reading
    result = {"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(dev),
              "correct": judge.verdict(run.numbers, cell.limits["limits"]),
              "end_to_end": run.end_to_end,
              "metrics": {m["name"]: spec.metric_reader(m["name"])(r) for m in cell.metrics},
              "traced_step_host_ms": 1e3 * r.window_s / r.steps,
              "busy_s": r.busy_s, "window_s": r.window_s, "steps": r.steps,
              "span_cost_us": span_cost_us(),
              "spans": by_span(r), "checks": checks(r)}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("workload", "correct", "metrics",
                                             "traced_step_host_ms", "span_cost_us")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
