"""Object- and calibration-aware augmentations.

A copy of the JAX package's ``dcd_tpu/data/augmentations.py`` (numpy, host
side), drawing from the same ``np.random.RandomState`` calls in the same
order, so that one seed gives the same scene in both packages. Reference:
``DGDE/data/augmentations/augmentations.py``:
* RandomHorizontalFlip (:28-87): mirrors the image, every 2D box, yaw
  (ry -> pi - ry with wrap), x-location, the extra keypoints' object-frame
  x/z, and the calibration cx / baseline terms.
* RandomResize (:89-132): multi-scale resize that rescales P accordingly.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .kitti_geometry import Calibration, Object3d


def flip_horizontal(
    img: np.ndarray, objs: Optional[List[Object3d]], calib: Calibration
) -> Tuple[np.ndarray, Optional[List[Object3d]], Calibration]:
    """Mirror image + labels + calib around the vertical axis."""
    img_h, img_w = img.shape[:2]
    out_img = img[:, ::-1].copy()
    new_calib = calib.flip_horizontally(img_w)

    if objs is None:
        return out_img, None, new_calib

    new_objs = []
    for obj in objs:
        o = Object3d(
            type=obj.type,
            truncation=obj.truncation,
            occlusion=obj.occlusion,
            alpha_label=obj.alpha_label,
            box2d=np.array(
                [img_w - 1 - obj.box2d[2], obj.box2d[1], img_w - 1 - obj.box2d[0], obj.box2d[3]],
                dtype=np.float32,
            ),
            h=obj.h,
            w=obj.w,
            l=obj.l,
            t=np.array([-obj.t[0], obj.t[1], obj.t[2]]),
            ry=_flip_ry(obj.ry),
            extra_kpts_3D=_flip_kpts(obj.extra_kpts_3D),
            find_pcl=obj.find_pcl,
            level=obj.level,
        )
        new_objs.append(o)
    return out_img, new_objs, new_calib


def _flip_ry(ry: float) -> float:
    # mirroring x negates the heading's x-component: ry -> pi - ry, wrapped
    out = math.pi - ry
    if out > math.pi:
        out -= 2 * math.pi
    if out < -math.pi:
        out += 2 * math.pi
    return out


def _flip_kpts(kpts: np.ndarray) -> np.ndarray:
    """Mirror object-frame keypoints consistently with the pose flip.

    World mirroring M(x->-x) + yaw change ry' = pi - ry composes in the
    object frame to (x, y, z) -> (x, y, -z): with R' = R(pi - ry),
    R'^T M R(ry) = diag(1, 1, -1).

    Deviation from the reference (documented): the reference leaves
    extra_kpts_3D untouched on flip — its commented-out attempt negated x
    (augmentations.py:72, tagged as a bug) and was abandoned, relying on
    cars being nearly z-symmetric. The z-negation here is the exact
    transform.
    """
    out = kpts.copy()
    out[:, 2] = -out[:, 2]
    return out


def resize_scene(
    img: np.ndarray, objs: Optional[List[Object3d]], calib: Calibration, scale: float
) -> Tuple[np.ndarray, Optional[List[Object3d]], Calibration]:
    """Rescale image + 2D boxes + P (3D geometry unchanged).

    Reference RandomResize (:89-132): P[0:2] scale with the image.
    """
    img_h, img_w = img.shape[:2]
    new_w, new_h = int(round(img_w * scale)), int(round(img_h * scale))
    # nearest-neighbor is enough for synthetic/test use; PIL bilinear is
    # used in the real loader path
    yi = np.clip((np.arange(new_h) / scale).astype(int), 0, img_h - 1)
    xi = np.clip((np.arange(new_w) / scale).astype(int), 0, img_w - 1)
    out_img = img[yi][:, xi]

    P = calib.P.copy()
    P[0] *= scale
    P[1] *= scale
    new_calib = Calibration(P, calib.V2C, calib.R0)

    if objs is None:
        return out_img, None, new_calib
    new_objs = []
    for obj in objs:
        o = Object3d(
            type=obj.type, truncation=obj.truncation, occlusion=obj.occlusion,
            alpha_label=obj.alpha_label,
            box2d=(obj.box2d * scale).astype(np.float32),
            h=obj.h, w=obj.w, l=obj.l, t=obj.t.copy(), ry=obj.ry,
            extra_kpts_3D=obj.extra_kpts_3D.copy(), find_pcl=obj.find_pcl, level=obj.level,
        )
        new_objs.append(o)
    return out_img, new_objs, new_calib


class ComposedAugmentation:
    """flip (p from aug_params[0][0]) then optional multi-scale resize."""

    def __init__(self, flip_prob: float = 0.5, scales: Sequence[float] = (), resize_prob: float = 0.0):
        self.flip_prob = flip_prob
        self.scales = list(scales)
        self.resize_prob = resize_prob

    def __call__(self, img, objs, calib, rng: np.random.RandomState):
        if rng.rand() < self.flip_prob:
            img, objs, calib = flip_horizontal(img, objs, calib)
        if self.scales and rng.rand() < self.resize_prob:
            scale = self.scales[rng.randint(len(self.scales))]
            img, objs, calib = resize_scene(img, objs, calib, scale)
        return img, objs, calib
