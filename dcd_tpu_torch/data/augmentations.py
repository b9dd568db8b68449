"""Scene augmentations: so far only the resize that the target encoder uses.

A copy of ``dcd_tpu/data/augmentations.py::resize_scene`` (the reference's
RandomResize, ``DGDE/data/transforms``, :89-132). The flip and the composed
train-time augmentation are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .kitti_geometry import Calibration, Object3d


def resize_scene(
    img: np.ndarray, objs: Optional[List[Object3d]], calib: Calibration, scale: float
) -> Tuple[np.ndarray, Optional[List[Object3d]], Calibration]:
    """Rescale the image (nearest neighbour), the 2D boxes and the first two
    rows of P; the 3D geometry is unchanged."""
    img_h, img_w = img.shape[:2]
    new_w, new_h = int(round(img_w * scale)), int(round(img_h * scale))
    yi = np.clip((np.arange(new_h) / scale).astype(int), 0, img_h - 1)
    xi = np.clip((np.arange(new_w) / scale).astype(int), 0, img_w - 1)
    out_img = img[yi][:, xi]

    P = calib.P.copy()
    P[0] *= scale
    P[1] *= scale
    new_calib = Calibration(P)
    if objs is None:
        return out_img, None, new_calib
    new_objs = [dataclasses.replace(obj, box2d=(obj.box2d * scale).astype(np.float32),
                                    t=obj.t.copy(), extra_kpts_3D=obj.extra_kpts_3D.copy())
                for obj in objs]
    return out_img, new_objs, new_calib
