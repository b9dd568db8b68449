"""Synthetic KITTI-like scenes: car boxes of plausible size on a ground
plane, projected through a real KITTI P2, with CAD-like extra keypoints
inside each box, and a simple render so that convolutions see structure.
A frozen copy of the program's generator, numpy only: the same seed gives
the same scene.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .edges import KITTI_IMAGE_SIZE, KITTI_P2
from .kitti_geometry import Calibration, Object3d


def make_extra_kpts(rng: np.random.RandomState, n: int, l: float, h: float, w: float) -> np.ndarray:
    """CAD-ish surface keypoints in the object frame (bottom-centered, like
    the annotation JSON before the h/2 shift)."""
    pts = rng.uniform(-0.5, 0.5, size=(n, 3))
    pts[:, 0] *= l
    pts[:, 1] = -rng.uniform(0, 1, size=n) * h  # y in [-h, 0]
    pts[:, 2] *= w
    return pts


def scaled_P(image_size: Tuple[int, int]) -> np.ndarray:
    """Scale the KITTI intrinsics to a non-default image size so projected
    objects land inside the frame (keeps the real P2 at the native size)."""
    img_w, img_h = image_size
    if (img_w, img_h) == KITTI_IMAGE_SIZE:
        return KITTI_P2.copy()
    P = KITTI_P2.copy()
    sx = img_w / KITTI_IMAGE_SIZE[0]
    sy = img_h / KITTI_IMAGE_SIZE[1]
    P[0] *= sx
    P[1] *= sy
    return P


def make_scene(
    seed: int = 0,
    num_objs: int = 6,
    extra_kpts_num: int = 63,
    image_size: Tuple[int, int] = KITTI_IMAGE_SIZE,
    depth_range: Tuple[float, float] = (8.0, 55.0),
) -> Tuple[np.ndarray, List[Object3d], Calibration]:
    """Returns (HWC uint8 image, objects, calibration).

    ``depth_range`` controls object distance — close ranges give large 2-D
    boxes, needed on small test images where the KITTI difficulty rules
    would otherwise ignore every GT (MIN_HEIGHT 40/25/25 px)."""
    rng = np.random.RandomState(seed)
    img_w, img_h = image_size
    calib = Calibration(scaled_P(image_size))

    objs: List[Object3d] = []
    for _ in range(num_objs):
        h = rng.uniform(1.4, 1.7)
        w = rng.uniform(1.5, 1.8)
        l = rng.uniform(3.4, 4.5)
        z = rng.uniform(*depth_range)
        x = rng.uniform(-0.8, 0.8) * z * 0.35
        y = 1.65 + rng.uniform(-0.1, 0.1)  # camera height above ground
        ry = rng.uniform(-np.pi, np.pi)

        kpts = make_extra_kpts(rng, extra_kpts_num, l, h, w)
        kpts_mid = kpts.copy()
        kpts_mid[:, 1] += h / 2  # mid-height origin like the dataset loader

        obj = Object3d(
            type="Car",
            truncation=0.0,
            occlusion=0,
            alpha_label=0.0,
            box2d=np.zeros(4, dtype=np.float32),
            h=h,
            w=w,
            l=l,
            t=np.array([x, y, z]),
            ry=ry,
            extra_kpts_3D=kpts_mid,
            find_pcl=1,
        )
        # project to get a 2D box; skip objects fully outside the image
        corners_2d, depth = calib.project_rect_to_image(obj.generate_corners3d())
        if (depth <= 0.1).any():
            continue
        box = np.array(
            [
                corners_2d[:, 0].min(),
                corners_2d[:, 1].min(),
                corners_2d[:, 0].max(),
                corners_2d[:, 1].max(),
            ]
        )
        clipped = np.array(
            [
                np.clip(box[0], 0, img_w - 1),
                np.clip(box[1], 0, img_h - 1),
                np.clip(box[2], 0, img_w - 1),
                np.clip(box[3], 0, img_h - 1),
            ],
            dtype=np.float32,
        )
        if clipped[2] - clipped[0] < 5 or clipped[3] - clipped[1] < 5:
            continue
        obj.box2d = clipped
        # truncation estimate from clipping
        area_full = max((box[2] - box[0]) * (box[3] - box[1]), 1e-6)
        area_vis = (clipped[2] - clipped[0]) * (clipped[3] - clipped[1])
        obj.truncation = float(np.clip(1.0 - area_vis / area_full, 0.0, 1.0))
        obj.level = obj.get_kitti_obj_level()
        objs.append(obj)

    # simple render: gradient background + box splats so convs see structure
    img = np.tile(
        np.linspace(60, 180, img_w, dtype=np.float32)[None, :, None], (img_h, 1, 3)
    )
    for obj in objs:
        x0, y0, x1, y1 = obj.box2d.astype(int)
        color = rng.uniform(0, 255, size=3)
        img[y0:y1, x0:x1] = 0.5 * img[y0:y1, x0:x1] + 0.5 * color
    img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
    return img, objs, calib
