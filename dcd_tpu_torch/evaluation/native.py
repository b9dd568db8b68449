"""ctypes binding of the fused KITTI matcher, ``csrc/eval_native.cc``.

The counterpart of the JAX package's ``dcd_tpu/native`` binding of the same
C++ (``kitti_match_scores`` and ``kitti_fused_statistics``). It is host code:
at first use, ``g++ -O3 -shared -fPIC`` builds it into
``build/dcd_tpu_torch/libeval_native.so`` at the root of the checkout, and
again whenever the source is newer than the library. There is no
``-march=native``, so a library built on one machine runs on another. A build
that fails raises: the caller asked for the native matcher, and the Python
protocol loops of :mod:`.kitti_eval` (``use_native=False``) are its plain
version, not a silent fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "eval_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dcd_tpu_torch"
LIBRARY = BUILD_DIR / "libeval_native.so"
COMMAND = ["g++", "-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_D = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)


def build() -> Path:
    """Compile the matcher now (into a temporary name, then renamed into
    place, so that a reader never loads half a library); raises with the
    compiler's output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run([*COMMAND, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native KITTI matcher is built with g++") from e
    if done.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{done.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded matcher, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                build()
            lib = ctypes.CDLL(str(LIBRARY))
            lib.kitti_match_scores.restype = ctypes.c_int
            lib.kitti_match_scores.argtypes = [
                _D, ctypes.c_int, ctypes.c_int, _D, _I64, _I64, ctypes.c_double, _D]
            lib.kitti_fused_statistics.restype = None
            lib.kitti_fused_statistics.argtypes = [
                _D, ctypes.c_int, ctypes.c_int, _D, _D, _D, _D, ctypes.c_int, _I64, _I64,
                ctypes.c_int, ctypes.c_double, _D, ctypes.c_int, ctypes.c_int, _D]
            _lib = lib
        return _lib


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def kitti_match_scores(overlaps, dt_scores, ignored_gt, ignored_det, min_overlap) -> np.ndarray:
    """Phase 1 of the protocol for one image: the scores of the detections
    matched as true positives at threshold 0 (``compute_statistics`` with
    ``compute_fp=False``)."""
    overlaps, dt_scores = _f64(overlaps), _f64(dt_scores)
    ignored_gt, ignored_det = _i64(ignored_gt), _i64(ignored_det)
    det_size, gt_size = overlaps.shape
    if dt_scores.shape != (det_size,) or ignored_det.shape != (det_size,) \
            or ignored_gt.shape != (gt_size,):
        raise ValueError(f"sizes disagree: overlaps {overlaps.shape}, scores {dt_scores.shape}, "
                         f"ignored gt {ignored_gt.shape}, ignored det {ignored_det.shape}")
    out = np.empty((max(gt_size, 1),), np.float64)
    n = library().kitti_match_scores(
        _ptr(overlaps, ctypes.c_double), det_size, gt_size, _ptr(dt_scores, ctypes.c_double),
        _ptr(ignored_gt, ctypes.c_int64), _ptr(ignored_det, ctypes.c_int64),
        ctypes.c_double(min_overlap), _ptr(out, ctypes.c_double))
    return out[:n]


def kitti_fused_statistics(overlaps, dt_scores, dt_alphas, gt_alphas, dt_dc_overlap,
                           ignored_gt, ignored_det, metric, min_overlap, thresholds,
                           compute_aos, pr) -> None:
    """The greedy matching of one image at every threshold, added into
    ``pr`` (T, 4) float64 in place: tp, fp, fn and the orientation
    similarity (``compute_statistics`` with ``compute_fp=True``, once per
    threshold). ``dt_dc_overlap`` is the (det, DontCare) overlap or None."""
    overlaps = _f64(overlaps)
    det_size, gt_size = overlaps.shape
    dt_scores, dt_alphas, gt_alphas = _f64(dt_scores), _f64(dt_alphas), _f64(gt_alphas)
    ignored_gt, ignored_det = _i64(ignored_gt), _i64(ignored_det)
    thresholds = _f64(thresholds)
    if dt_scores.shape != (det_size,) or dt_alphas.shape != (det_size,) \
            or ignored_det.shape != (det_size,) or gt_alphas.shape != (gt_size,) \
            or ignored_gt.shape != (gt_size,):
        raise ValueError(f"sizes disagree with overlaps {overlaps.shape}")
    if pr.dtype != np.float64 or not pr.flags.c_contiguous or pr.shape != (len(thresholds), 4):
        raise ValueError(f"pr must be C-contiguous float64 ({len(thresholds)}, 4)")
    dc_size = 0 if dt_dc_overlap is None else dt_dc_overlap.shape[1]
    dc = _f64(dt_dc_overlap) if dc_size else None
    if dc is not None and dc.shape != (det_size, dc_size):
        raise ValueError(f"DontCare overlaps must be ({det_size}, {dc_size}), got {dc.shape}")
    library().kitti_fused_statistics(
        _ptr(overlaps, ctypes.c_double), det_size, gt_size,
        _ptr(dt_scores, ctypes.c_double), _ptr(dt_alphas, ctypes.c_double),
        _ptr(gt_alphas, ctypes.c_double), _ptr(dc, ctypes.c_double) if dc is not None else _D(),
        dc_size, _ptr(ignored_gt, ctypes.c_int64), _ptr(ignored_det, ctypes.c_int64),
        int(metric), ctypes.c_double(min_overlap),
        _ptr(thresholds, ctypes.c_double), len(thresholds), int(compute_aos),
        _ptr(pr, ctypes.c_double))
