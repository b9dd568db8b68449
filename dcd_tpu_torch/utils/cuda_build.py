"""Build and load the port's CUDA kernels.

One ``nvcc`` process per ``dcd_tpu_torch/csrc/*.cu``, all started together,
compiles the sources to objects, and one more links them into
``build/dcd_tpu_torch/libdcd_kernels.so`` at the root of the checkout, which
is loaded with :mod:`ctypes`. The sources have a plain C interface and
include no PyTorch header, so the build takes seconds. It happens at first
use and again whenever a source is newer than the library; nothing is built
when the package is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dcd_tpu_torch"
LIBRARY = BUILD_DIR / "libdcd_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None


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
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32


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
