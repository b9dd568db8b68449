"""A run's result line, driven on the CPU at a tiny size (the look for a
card skipped), and the command's refusal where there is no card."""

import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from portbench.harness import report, spec
from portbench.harness.spec import ROOT
from portbench.tests.tiny import make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(tmp_path, loop, trace, seed=2 ** 31 + 11):
    root = make_root(tmp_path, loop)
    cell = spec.load_cell(f"tiny.{loop}", trace, root)
    t0 = time.perf_counter()
    result = report.run(cell, seed, 0.5, trace, torch.device("cpu"), lambda: time.perf_counter() - t0)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        report.emit(result)
    return cell, json.loads(out.getvalue().splitlines()[-1]), err.getvalue().splitlines()


@pytest.mark.parametrize("loop, trace", [("infer", False), ("infer", True), ("train", False),
                                         ("train", True)])
def test_the_last_line_has_the_contract_keys(tmp_path, one_thread, loop, trace):
    cell, line, err = run_tiny(tmp_path, loop, trace)
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.metrics}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    checks = [s for s in err if s.startswith("portbench check ")]
    assert err[-len(checks):] == checks and len(checks) == len(line["checks"])


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for a machine without one")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dgde.infer_b64_bf16",
                           "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_command_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dgde.infer_b64_bf16",
                           "--seed", "7", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_caches_stay_inside_the_checkout(tmp_path, monkeypatch):
    from portbench import run

    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    run.cache_dirs(tmp_path)
    import os

    for path in (os.environ["TRITON_CACHE_DIR"], os.environ["TORCH_EXTENSIONS_DIR"],
                 sys.pycache_prefix):
        assert Path(path).is_relative_to(tmp_path)
    assert sys.dont_write_bytecode is False
