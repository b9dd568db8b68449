"""Synthetic KITTI-like scenes: car boxes of plausible size on a ground
plane, projected through a real KITTI P2, with CAD-like extra keypoints
inside each box, and a simple render so that convolutions see structure.

Copied from the JAX package (``dcd_tpu/data/synthetic.py``), numpy only.
The same seed gives the same scene in both packages.
"""

from __future__ import annotations

import os
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


def write_kitti_tree(
    root: str,
    train_seeds=(0, 1, 2, 3),
    val_seeds=None,
    num_objs: int = 4,
    image_size: Tuple[int, int] = KITTI_IMAGE_SIZE,
    extra_kpts_num: int = 63,
) -> str:
    """Write synthetic scenes as a real on-disk KITTI directory tree.

    Produces ``root/training/{image_2,label_2,calib,ImageSets}`` plus the
    ``kpts_ann/kpts_ann_{train,val}.json`` CAD-keypoint annotations — the
    exact layout ``KITTIDataset`` (and the reference's
    DGDE/data/datasets/kitti.py:37-76) reads, so the full CLI workflow can
    run with zero real data. Returns the ``training`` directory path.

    ``val_seeds`` defaults to ``train_seeds`` (the reference smoke setup:
    train == val split)."""
    import json

    from PIL import Image

    if val_seeds is None:
        val_seeds = train_seeds
    training = os.path.join(root, "training")
    for sub in ("image_2", "label_2", "calib", "ImageSets"):
        os.makedirs(os.path.join(training, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "kpts_ann"), exist_ok=True)

    kpts_ann = {s: {} for s in ("train", "val")}
    split_ids = {"train": [], "val": []}
    all_seeds = sorted(set(train_seeds) | set(val_seeds))
    for seed in all_seeds:
        img, objs, calib = make_scene(
            seed=seed, num_objs=num_objs, extra_kpts_num=extra_kpts_num,
            image_size=image_size,
        )
        img_id = f"{seed:06d}"
        Image.fromarray(img).save(os.path.join(training, "image_2", f"{img_id}.png"))
        with open(os.path.join(training, "calib", f"{img_id}.txt"), "w") as f:
            f.write("P2: " + " ".join(str(v) for v in calib.P.reshape(-1)) + "\n")
            f.write("P3: " + " ".join(str(v) for v in calib.P.reshape(-1)) + "\n")
            f.write("R0_rect: " + " ".join(str(v) for v in np.eye(3).reshape(-1)) + "\n")
            f.write("Tr_velo_to_cam: " + " ".join(str(v) for v in np.eye(3, 4).reshape(-1)) + "\n")
        anns = []
        with open(os.path.join(training, "label_2", f"{img_id}.txt"), "w") as f:
            for o in objs:
                f.write(
                    f"Car {o.truncation:.2f} {o.occlusion} {o.alpha:.2f} "
                    f"{o.box2d[0]:.2f} {o.box2d[1]:.2f} {o.box2d[2]:.2f} {o.box2d[3]:.2f} "
                    f"{o.h:.2f} {o.w:.2f} {o.l:.2f} "
                    f"{o.t[0]:.2f} {o.t[1]:.2f} {o.t[2]:.2f} {o.ry:.2f}\n"
                )
                # annotation stores bottom-centered kpts (loader shifts by h/2)
                kp = o.extra_kpts_3D.copy()
                kp[:, 1] += o.h / 2
                anns.append(
                    {
                        "dim": [round(o.h, 2), round(o.w, 2), round(o.l, 2)],
                        "3dkeypoints": kp.reshape(-1).tolist(),
                        "2dkeypoints": np.zeros((kp.shape[0], 3)).reshape(-1).tolist(),
                        "find_pcl": 1,
                    }
                )
        for split, seeds in (("train", train_seeds), ("val", val_seeds)):
            if seed in seeds:
                kpts_ann[split][str(int(img_id))] = anns
                split_ids[split].append(img_id)
    for split in ("train", "val"):
        with open(os.path.join(training, "ImageSets", f"{split}.txt"), "w") as f:
            f.write("\n".join(split_ids[split]))
        with open(os.path.join(root, "kpts_ann", f"kpts_ann_{split}.json"), "w") as f:
            json.dump(kpts_ann[split], f)
    return training
