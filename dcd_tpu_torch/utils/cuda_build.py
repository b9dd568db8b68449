"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every ``dcd_tpu_torch/csrc/*.cu`` into
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, LIBRARY)
    return {"seconds": seconds, "log": log, "command": " ".join(cmd)}


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("dcn_fwd_f32", "dcn_fwd_bf16"):
        fn = getattr(lib, name)
        # x, offset, mask, weight, bias, out, B, H, W, Cin, Cout, radius, stream
        fn.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
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
