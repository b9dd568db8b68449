"""What one run measures, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells. Everything
that belongs to one configuration, one traffic mix, one cell's limits or one
per-layer metric is a file of its own under ``portbench/``, found by the
name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  the program's configuration tree as it is run, its source, ``reduced``
  and ``assumed``;
* ``traffic/<traffic>.json``: the loop that drives the program and its
  parameters (batch, precision, pools, profiled steps);
* ``limits/<cell>.json``: the limits of the numbers that decide ``correct``,
  with the readings they were set from;
* ``metrics/<metric>.py``: a reader with ``read(reading) -> float | None``.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries, and edits no file that is there.
"""

from __future__ import annotations

import copy
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


@dataclass
class Cell:
    """One cell as a run sees it: its entry, configuration, traffic,
    limits and the metrics it reports at its trace level."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]  # the configuration file
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    metrics: List[Dict[str, Any]] = field(default_factory=list)
    root: Path = ROOT

    @property
    def tree(self) -> Dict[str, Any]:
        """The configuration tree the program and the reference run: the
        file's tree with ``model.fp16`` set by the traffic's precision."""
        tree = copy.deepcopy(self.config["config"])
        tree["model"]["fp16"] = self.traffic["precision"] == "bf16"
        return tree


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[Mapping[str, Any]], name: str, what: str) -> Mapping[str, Any]:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named {name!r}")
    return found[0]


def metrics_of(bench: Mapping[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The end-to-end metrics a cell reports (``trace`` false) or its
    per-layer metrics (``trace`` true): a metric with ``workloads`` in the
    cells it lists; an end-to-end metric without, in every cell; a
    per-layer metric without, in every cell that reports the metric it
    moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def reported(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in bench["per_layer"] if reported(m)]


def load_cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    """Resolve cell ``name`` from ``root/BENCHMARK.json`` and the files it
    names under ``root``."""
    bench = load_json(root / "BENCHMARK.json")
    work = _by_name(bench["workloads"], name, "workloads")
    conf = _by_name(bench["configs"], work["config"], "configs")
    pkg = root / PACKAGE.name
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config_name=conf["name"],
        config=load_json(root / conf["file"]),
        traffic_name=work["traffic"],
        traffic=load_json(pkg / "traffic" / f"{work['traffic']}.json"),
        limits=load_json(pkg / "limits" / f"{name}.json"),
        metrics=metrics_of(bench, name, trace),
        root=root,
    )


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read`` of ``metrics/<name>.py``, loaded from its file (a metric's
    name holds dots, so it is no module path)."""
    path = root / PACKAGE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
