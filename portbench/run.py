"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``dcd_tpu_torch``). The run loads, warms up, measures for
``--seconds``, judges what the timed path produced against the plain
reference, prints each compared number beside its limit on standard error
and, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.

It exits with another code than 0 and prints no result where no CUDA card is
available, where fewer cards are there than the cell asks for, or where the
process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_START = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "dcd_tpu")


def _started_s_ago() -> float:
    """Seconds since this process started (Linux: /proc), else since this
    module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


_BEFORE = _started_s_ago()


def setup_clock() -> float:
    """Seconds from the process's start to now."""
    return _BEFORE + time.perf_counter() - _START


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a checkout's first run builds. (The program builds its kernel
    library under ``build/dcd_tpu_torch`` of the checkout itself.) That
    includes Python's bytecode of every module the run imports, torch's
    too: where the environment asks Python to write none
    (``PYTHONDONTWRITEBYTECODE``) and the installation holds none, each run
    would compile torch's sources again, some ten seconds of set-up."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)
    sys.pycache_prefix = str(base / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parents[1]
    cache_dirs(root)
    from portbench.harness import spec

    cell = spec.load_cell(args.workload, bool(args.trace), root)
    marks = {"interpreter": [setup_clock(), time.process_time()]}

    import torch

    marks["torch"] = [setup_clock(), time.process_time()]
    if not torch.cuda.is_available():
        print("portbench: no CUDA device is available; nothing was measured", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} are available", file=sys.stderr)
        return 3

    marks["driver"] = [setup_clock(), time.process_time()]
    from portbench.harness import report

    result = report.run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), setup_clock, marks)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)} after the window; "
              "no result", file=sys.stderr)
        return 4
    report.emit(result)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this file's folder, is where imports start
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
