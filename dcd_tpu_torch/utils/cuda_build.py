"""Build and load the port's CUDA kernels.

One ``nvcc`` process per ``dcd_tpu_torch/csrc/*.cu``, all started together,
compiles the sources to objects, and one more links them into
``build/dcd_tpu_torch/libdcd_kernels.so`` at the root of the checkout, which
is loaded with :mod:`ctypes`. The sources have a plain C interface and
include no PyTorch header, so the build takes seconds. It happens at first
use and again whenever a source is newer than the library; nothing is built
when the package is imported.

Every launch goes through :func:`launch`, which counts it by C entry point;
each wrapper shows its entry points' counts as ``launches_by_kernel``
(:class:`LaunchCounts`), and :func:`reset_launch_counts` zeroes them all.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from collections import Counter
from collections.abc import Mapping
from pathlib import Path
from typing import Iterable, Iterator, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dcd_tpu_torch"
LIBRARY = BUILD_DIR / "libdcd_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
_launches: Counter = Counter()


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return str(path)


def is_stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    deps = sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build() -> dict:
    """Compile the kernels now; return the seconds taken and ``nvcc``'s
    output, which holds ``-Xptxas -v``'s registers and spills per kernel.

    The library is written under a temporary name and renamed into place, so
    a reader never sees half a file and no lock file is left behind.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources(), objs)]
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{tag}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(compiles, procs)]
        log = "".join(out for _, out, _ in results)
        for cmd, out, rc in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(link)}\n{log}")
        os.replace(tmp, LIBRARY)
    finally:
        for path in [*objs, tmp]:
            path.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    commands = [" ".join(cmd) for cmd in compiles + [link]]
    return {"seconds": seconds, "log": log, "command": "\n  ".join(commands)}


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        # x, offset, mask, weight, bias, out, B, H, W, Cin, Cout, radius, stream
        "dcn_fwd_f32": [ptr] * 6 + [i32] * 6 + [ptr],
        "dcn_fwd_bf16": [ptr] * 6 + [i32] * 6 + [ptr],
        # B, H, W, Cout: the forward's output tile, pixels and channels
        "dcn_fwd_tile_m": [i32] * 4,
        "dcn_fwd_tile_n": [i32] * 4,
        # B, H, W, Cin, Cout
        "dcn_bwd_weight_splits": [i32] * 5,
        # x, offset, mask, g, weight, go, gm, gw, part, B, H, W, Cin, Cout, radius, splits, stream
        "dcn_bwd_pom_f32": [ptr] * 9 + [i32] * 7 + [ptr],
        "dcn_bwd_pom_bf16": [ptr] * 9 + [i32] * 7 + [ptr],
        # offset, mask, g, weight, gx, B, H, W, Cin, Cout, radius, stream
        "dcn_bwd_x_f32": [ptr] * 5 + [i32] * 6 + [ptr],
        "dcn_bwd_x_bf16": [ptr] * 5 + [i32] * 6 + [ptr],
        # x, weight, skip, out, B, H, W, C, f, stream
        "upsample_add_f32": [ptr] * 4 + [i32] * 5 + [ptr],
        "upsample_add_bf16": [ptr] * 4 + [i32] * 5 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32


def launch(name: str, device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and PyTorch's current
    stream on ``device``; raise if the launch was refused."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    _launches[name] += 1


def reset_launch_counts() -> None:
    """Zero the launch count of every entry point."""
    _launches.clear()


class LaunchCounts(Mapping):
    """The launches of the entry points ``names`` since the last
    :func:`reset_launch_counts`, by name: a read-only view of the counts
    :func:`launch` keeps (``dict(view)`` takes a snapshot)."""

    def __init__(self, names: Iterable[str]):
        self._names = tuple(names)

    def __getitem__(self, name: str) -> int:
        if name not in self._names:
            raise KeyError(name)
        return _launches[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    if _lib is None:
        if is_stale():
            build()
        lib = ctypes.CDLL(str(LIBRARY))
        _declare(lib)
        _lib = lib
    return _lib
