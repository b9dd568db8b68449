"""ctypes binding of the host heat-map encoder, ``csrc/heatmap_native.cc``.

The counterpart of the JAX package's ``dcd_tpu/native`` binding of the same
C++ (``splat_batch`` and ``pad_normalize_image``), which
:func:`..data.target_encoder.encode_targets` calls. It is host code: at first
use, ``g++ -O3 -shared -fPIC`` builds it into
``build/dcd_tpu_torch/libheatmap_native.so`` at the root of the checkout, and
again whenever the source is newer than the library, as
:mod:`..evaluation.native` builds the KITTI matcher. There is no
``-march=native``: the library is bitwise equal to the numpy versions
(:func:`.heatmap.splat_batch`, ``target_encoder.pad_image`` +
``normalize_image``), which stay as its plain versions. A build that fails
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "heatmap_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dcd_tpu_torch"
LIBRARY = BUILD_DIR / "libheatmap_native.so"
COMMAND = ["g++", "-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def build() -> Path:
    """Compile the encoder now (into a temporary name, then renamed into
    place, so that a reader never loads half a library); raises with the
    compiler's output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run([*COMMAND, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native heat-map encoder is built with g++") from e
    if done.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{done.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded encoder, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                build()
            lib = ctypes.CDLL(str(LIBRARY))
            lib.splat_batch.restype = None
            lib.splat_batch.argtypes = [_F, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        _I32, _I32, _I32, _I32, _I32, _I32, ctypes.c_int]
            lib.pad_normalize_image.restype = None
            lib.pad_normalize_image.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F, _F]
            _lib = lib
        return _lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def splat_batch(heatmap: np.ndarray, cls_ids: np.ndarray, centers: np.ndarray,
                radii_x: np.ndarray, radii_y: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Max-splat each object onto its class plane of ``heatmap`` (C, H, W)
    float32, in place (``heatmap`` must be C-contiguous): kind 0 an
    isotropic gaussian of radius ``radii_x``, kind 1 an elliptic one of radii
    (``radii_x``, ``radii_y``); a class id outside [0, C) is skipped."""
    if heatmap.dtype != np.float32 or not heatmap.flags.c_contiguous or heatmap.ndim != 3:
        raise ValueError("heatmap must be a C-contiguous (C, H, W) float32 array")
    n = len(cls_ids)
    if n == 0:
        return heatmap
    centers = np.asarray(centers)
    args = [_i32(a) for a in (cls_ids, centers[:, 0], centers[:, 1], radii_x, radii_y, kinds)]
    library().splat_batch(_ptr(heatmap, ctypes.c_float), *heatmap.shape,
                          *(_ptr(a, ctypes.c_int32) for a in args), n)
    return heatmap


def pad_normalize_image(img: np.ndarray, out_h: int, out_w: int, pad: Sequence[int],
                        mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """uint8 (h, w, c) -> float32 (out_h, out_w, c): padded with zeros, the
    image's corner at ``pad`` = (x, y) (``target_encoder.pad_offset``), and
    normalised, (x / 255 - mean) / std per channel, in one pass."""
    if img.dtype != np.uint8:
        raise TypeError(f"the image must be uint8, got {img.dtype}")
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    pad_x, pad_y = (int(v) for v in pad)
    if min(pad_x, pad_y) < 0 or pad_y + h > out_h or pad_x + w > out_w:
        raise ValueError(f"image {h}x{w} at {pad_x, pad_y} does not fit the canvas {out_h}x{out_w}")
    out = np.empty((out_h, out_w, c), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    library().pad_normalize_image(_ptr(img, ctypes.c_uint8), h, w, c, _ptr(out, ctypes.c_float),
                                  out_h, out_w, pad_x, pad_y, _ptr(mean, ctypes.c_float),
                                  _ptr(std, ctypes.c_float))
    return out
