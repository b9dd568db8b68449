"""The boundary ring that edge fusion reads, and the KITTI camera.

Copied from the JAX package (``dcd_tpu/data/target_encoder.py::get_edge_indices``
and ``dcd_tpu/data/synthetic.py::KITTI_P2``), numpy only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# KITTI left color camera projection (a typical P2 of the training set)
KITTI_P2 = np.array(
    [
        [721.5377, 0.0, 609.5593, 44.85728],
        [0.0, 721.5377, 172.854, 0.2163791],
        [0.0, 0.0, 1.0, 0.002745884],
    ]
)

KITTI_IMAGE_SIZE = (1242, 375)  # (w, h)


def get_edge_indices(
    image_size: Tuple[int, int], pad_size: np.ndarray, down_ratio: int = 4
) -> np.ndarray:
    """(x, y) boundary pixels of the valid (un-padded) image region on the
    feature map, ordered left / bottom / right / top
    (reference kitti.py:170-223 get_edge_utils)."""
    img_w, img_h = image_size
    x_min, y_min = int(np.ceil(pad_size[0] / down_ratio)), int(np.ceil(pad_size[1] / down_ratio))
    x_max = (pad_size[0] + img_w - 1) // down_ratio
    y_max = (pad_size[1] + img_h - 1) // down_ratio

    segs = []
    # left (ascending y)
    y = np.arange(y_min, y_max)
    segs.append(np.stack([np.full_like(y, x_min), y], axis=1))
    # bottom (ascending x)
    x = np.arange(x_min, x_max)
    segs.append(np.stack([x, np.full_like(x, y_max)], axis=1))
    # right (descending y)
    y = np.arange(y_max, y_min, -1)
    seg = np.stack([np.full_like(y, x_max), y], axis=1)
    segs.append(seg[np.argsort(seg[:, 1])][::-1])
    # top (descending x)
    x = np.arange(x_max, x_min - 1, -1)
    seg = np.stack([x, np.full_like(x, y_min)], axis=1)
    segs.append(seg[np.argsort(seg[:, 0])][::-1])
    return np.concatenate(segs, axis=0).astype(np.int64)


def padded_edge_indices(image_size: Tuple[int, int], pad_size: np.ndarray, length: int,
                        down_ratio: int = 4) -> Tuple[np.ndarray, int]:
    """The ring zero-padded to ``length`` rows (``cfg.max_edge_length``), and
    its true length."""
    ring = get_edge_indices(image_size, pad_size, down_ratio)
    out = np.zeros((length, 2), np.int64)
    out[: len(ring)] = ring
    return out, len(ring)
