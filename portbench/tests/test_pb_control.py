"""The control, the reference in the next lower precision put in the
program's place, comes out not correct: at a tiny size on the CPU against
the tiny cell's limits, and on the card at each cell's own size against its
limits (``card``: ``python -m pytest portbench/tests -q -m card`` there)."""

import json
import time

import pytest
import torch

from portbench.harness import spec
from portbench.tests.tiny import make_root
from portbench.tools import readings

SEEDS_ON_THE_CARD = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _fails(numbers, limits):
    return [k for k in limits if not numbers[k] <= limits[k]]


@pytest.mark.parametrize("loop", ["infer", "train"])
def test_the_control_fails_at_a_tiny_size(tmp_path, one_thread, loop):
    root = make_root(tmp_path, loop)
    cell = spec.load_cell(f"tiny.{loop}", False, root)
    fn = readings.infer_seed if loop == "infer" else readings.train_seed
    got = fn(cell, 2 ** 31 + 17, torch.device("cpu"), True, {})
    limits = cell.limits["limits"]
    assert not _fails(got["program"], limits), got
    assert _fails(got["control"], limits), got
    if loop == "train":
        assert _fails(got["half_batch"], limits), got


@pytest.mark.card
@pytest.mark.parametrize("workload", [c["name"] for c in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]])
def test_the_control_fails_on_the_card(card, workload):
    cell = spec.load_cell(workload, False)
    fn = readings.infer_seed if cell.traffic["loop"] == "infer" else readings.train_seed
    limits = cell.limits["limits"]
    for seed in SEEDS_ON_THE_CARD:
        t0 = time.perf_counter()
        got = fn(cell, seed, card, True, {})
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **got}))
        assert not _fails(got["program"], limits), got
        assert _fails(got["control"], limits), got
