"""The readings that a cell's limits are set from, many seeds in one process.

For each seed: the cell's own run (its loop, with a window of no seconds:
the inference loop's least number of batches, one training step), judged
as a run judges it; then, from the same inputs and weights, the control
(the reference in the next lower precision put in the program's place,
judged the same way) and the faults a run can have. Inference: every row
marked valid, none marked valid, and one frame's rows altered (its depth
half again as far), each read from the run's judged outputs. Training: a
step that leaves half of the batch out and takes the mean over the rest,
read with the reference in the program's place.

    python3 -m portbench.tools.readings --workload <cell> --seeds 1,2,3 --out <file.json>

It needs the card, as a run does. The result is one JSON object by seed,
and for an inference cell each seed's judged rows' validity and switch
distances (``<out>.<seed>.npz``), which the validity margins are set from.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench.harness import judge, loops

DEPTH_COLUMN = 11


def _clock():
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


def infer_faults(blocks, margins) -> dict:
    """The judge's numbers with the program's outputs altered where they
    are produced: validity all true, all false; one frame's rows moved."""
    out = {}
    for name, mark in (("all_valid", True), ("none_valid", False)):
        out[name] = judge.infer_numbers([dict(b, got_valid=np.full_like(b["got_valid"], mark))
                                         for b in blocks], margins)[0]
    moved = copy.deepcopy(list(blocks))
    rows = moved[0]["got_rows"]
    rows[0, :, DEPTH_COLUMN] += 0.5 * abs(rows[0, :, DEPTH_COLUMN])
    out["one_frame"] = judge.infer_numbers(moved, margins)[0]
    return out


def switch_rows(blocks) -> dict:
    """Each judged row's validity (the reference's and the kept one) and
    its distances from the two switches: what the margins are set from."""
    return {k: np.concatenate([b[k] for b in blocks]).reshape(-1)
            for k in ("valid", "got_valid", "by_heat", "by_error")}


def infer_seed(cell, seed, dev, control: bool, rows: dict) -> dict:
    """The seed's readings; ``rows`` gets each judged row's switch data."""
    margins = cell.limits["margins"]
    run = loops.infer_cell(cell, seed, 0.0, False, dev, _clock())
    res = {"program": run.numbers, "shown": run.info["shown"]}
    rows.update({f"program_{k}": v for k, v in switch_rows(run.kept["blocks"]).items()})
    if control:
        pool, state, blocks = run.kept["pool"], run.kept["state"], run.kept["blocks"]
        res["faults"] = infer_faults(blocks, margins)
        kept = run.info["checked_batches"]
        del run
        block = loops.REFERENCE_BLOCK
        ctl = loops._reference(cell, state, dev, quantize=True)
        with judge.reference_precision():
            made = [(p,) + loops.control_infer(ctl, pool[p].to(dev), block) for p in kept]
        del ctl
        loops._free(dev)
        ref = loops._reference(cell, state, dev)
        judged = loops.judge_infer(ref, pool, made, dev, block)
        res["control"], res["control_shown"] = judge.infer_numbers(judged, margins)
        rows.update({f"control_{k}": v for k, v in switch_rows(judged).items()})
        del ref
        loops._free(dev)
    return res


def train_seed(cell, seed, dev, control: bool, rows: dict) -> dict:
    run = loops.train_cell(cell, seed, 0.0, False, dev, _clock())
    res = {"program": dict(run.numbers, **run.info["shown"]), "losses": run.info["losses"],
           "reference_losses": run.info["reference_losses"]}
    if control:
        state, want = run.kept["state"], run.kept["want"]
        batches = run.kept["pool"][:loops.CHECK_STEPS]
        del run
        bf16 = loops.reference_steps(cell, state, batches, dev, bf16=True)
        res["control"] = judge.train_numbers(bf16, want, worst=True)
        res["control_losses"] = bf16["losses"]
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
        res["half_batch"] = judge.train_numbers(loops.reference_steps(cell, state, half, dev),
                                                want, worst=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=1, help="also read the control and faults")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from portbench.harness import spec

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload, False)
    dev = torch.device("cuda", 0)
    fn = {"infer": infer_seed, "train": train_seed}[cell.traffic["loop"]]
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "seeds": {}}
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        rows = {}
        out["seeds"][s] = fn(cell, s, dev, bool(args.control), rows)
        out["seeds"][s]["seconds"] = time.perf_counter() - t0
        if rows:
            np.savez_compressed(Path(args.out).with_suffix(f".{s}.npz"), **rows)
        print(json.dumps({s: out["seeds"][s]}), flush=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
