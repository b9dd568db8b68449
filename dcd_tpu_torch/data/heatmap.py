"""Heatmap target splats, numpy.

Copied from the JAX package (``dcd_tpu/data/heatmap.py``; reference
``DGDE/model/heatmap_coder.py``: gaussian_radius :37-56,
draw_umich_gaussian :83-106, draw_umich_gaussian_2D :108-124).
:func:`splat_batch` draws a list of objects with them, as the JAX package's
``native.splat_batch`` does when its compiled library is absent; that
library is built with ``-march=native`` for the machine it runs on, and the
two are bit-compatible (``tests/test_native.py``).
"""

from __future__ import annotations

import numpy as np


def gaussian_radius(height: float, width: float, min_overlap: float = 0.7) -> float:
    """CenterNet 3-case quadratic radius (reference heatmap_coder.py:37-56)."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(b1**2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2**2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3**2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def _gaussian2d_patch(radius_y: int, radius_x: int, sigma_x: float, sigma_y: float) -> np.ndarray:
    y, x = np.ogrid[-radius_y : radius_y + 1, -radius_x : radius_x + 1]
    h = np.exp(-(x * x) / (2 * sigma_x * sigma_x) - (y * y) / (2 * sigma_y * sigma_y))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_umich_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0) -> np.ndarray:
    """Max-splat an isotropic gaussian (reference heatmap_coder.py:83-106)."""
    diameter = 2 * radius + 1
    gaussian = _gaussian2d_patch(radius, radius, diameter / 6.0, diameter / 6.0)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    if min(left + right, top + bottom) > 0:
        masked = heatmap[y - top : y + bottom, x - left : x + right]
        patch = gaussian[radius - top : radius + bottom, radius - left : radius + right]
        np.maximum(masked, patch * k, out=masked)
    return heatmap


def draw_umich_gaussian_2d(
    heatmap: np.ndarray, center, radius_x: int, radius_y: int, k: float = 1.0
) -> np.ndarray:
    """Max-splat an axis-aligned elliptic gaussian — used for truncated
    objects whose center sits on the image border
    (reference heatmap_coder.py:108-124)."""
    dx, dy = 2 * radius_x + 1, 2 * radius_y + 1
    gaussian = _gaussian2d_patch(radius_y, radius_x, dx / 6.0, dy / 6.0)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius_x), min(width - x, radius_x + 1)
    top, bottom = min(y, radius_y), min(height - y, radius_y + 1)
    if min(left + right, top + bottom) > 0:
        masked = heatmap[y - top : y + bottom, x - left : x + right]
        patch = gaussian[radius_y - top : radius_y + bottom, radius_x - left : radius_x + right]
        np.maximum(masked, patch * k, out=masked)
    return heatmap


def splat_batch(heatmap: np.ndarray, cls_ids: np.ndarray, centers: np.ndarray,
                radii_x: np.ndarray, radii_y: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Max-splat each object onto its class plane of ``heatmap`` (C, H, W),
    in place: kind 0 an isotropic gaussian of radius ``radii_x``, kind 1 an
    elliptic one of radii (``radii_x``, ``radii_y``)."""
    for i in range(len(cls_ids)):
        c = int(cls_ids[i])
        if c < 0 or c >= heatmap.shape[0]:
            continue
        if kinds[i] == 0:
            draw_umich_gaussian(heatmap[c], centers[i], int(radii_x[i]))
        else:
            draw_umich_gaussian_2d(heatmap[c], centers[i], int(radii_x[i]), int(radii_y[i]))
    return heatmap
