"""A tiny copy of the benchmark for the CPU tests: the real files under a
temporary root, and one more configuration (the shipped one at 8-32
channels and a 64x128 canvas), one more mix and their cells."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench.harness.spec import PACKAGE, ROOT

TINY_IMAGE = [120, 60]


def tiny_tree(deeper_head: bool = False) -> dict:
    with open(PACKAGE / "configs" / "dgde.json") as f:
        tree = copy.deepcopy(json.load(f)["config"])
    tree["input"].update(height_train=64, width_train=128, height_test=64, width_test=128)
    tree["model"]["backbone"]["channels"] = [8, 8, 16, 16, 32, 32]
    tree["model"]["head"]["num_channel"] = 16
    tree["model"]["head"]["deeper_head"] = deeper_head
    tree["test"]["detections_per_img"] = 10
    return tree


def make_root(tmp: Path, loop: str = "infer", deeper_head: bool = False) -> Path:
    """A checkout-like root under ``tmp`` holding the benchmark's files and a
    tiny cell ``tiny.<loop>`` on the CPU."""
    root = tmp / "root"
    shutil.copytree(PACKAGE, root / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    pkg = root / PACKAGE.name
    conf = {"name": "tiny", "source": "tests", "reduced": ["input", "model"], "assumed": {},
            "config": tiny_tree(deeper_head)}
    (pkg / "configs" / "tiny.json").write_text(json.dumps(conf))
    if loop == "infer":
        traffic = {"loop": "infer", "batch": 4, "precision": "bf16", "image": TINY_IMAGE,
                   "pool": 2, "trace_steps": 2}
        limits = {"peak_gap": 1.0, "row_gap": 0.5, "frame_gap": 0.5, "valid_flips": 0}
    else:
        traffic = {"loop": "train", "batch": 2, "precision": "fp32", "image": TINY_IMAGE,
                   "pool": 4, "objects": 3, "ahead_steps": 2, "trace_steps": 1}
        limits = {"grad_leaves_off": 0, "median_change_gap": 1e-2}
    (pkg / "traffic" / f"tiny_{loop}.json").write_text(json.dumps(traffic))
    name = f"tiny.{loop}"
    margins = {"heat_logit": 1e-3, "depth_error_log": 1e-4}
    (pkg / "limits" / f"{name}.json").write_text(json.dumps({"limits": limits, "margins": margins}))
    bench["configs"].append({"name": "tiny", "source": "tests", "file": "portbench/configs/tiny.json",
                             "reduced": ["input", "model"], "why": "CPU tests"})
    bench["workloads"].append({"name": name, "config": "tiny", "traffic": f"tiny_{loop}",
                               "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and any(w.startswith(f"dgde.{loop}") for w in m["workloads"]):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
