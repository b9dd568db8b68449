"""Training targets of one image, numpy: a frozen copy of the program's
numpy target encoder for the benchmark's training batches (the
target-building body of the DGDE reference ``KITTIDataset.__getitem__``,
``data/datasets/kitti.py:274-610``): a dict of fixed-shape arrays,
``max_objects`` slots padded everywhere (hm (C, Ho, Wo), cls_ids,
target_centers, 2d boxes, 10 keypoints, extra keypoints 2d/3d, Calib_P,
find_pcl, depth masks, dimensions, locations, rotys, alphas, multi-bin
orientations, offset_3D, reg/trunc masks, pad_size, edge_indices/edge_len,
ori_mask). The heatmap splats and the pad + normalise are the numpy ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import heatmap as hm_coder
from .edges import get_edge_indices
from .kitti_geometry import Calibration, Object3d, approx_proj_center

# KITTI class name -> class id (DGDE reference ``config/paths_catalog``)
TYPE_ID_CONVERSION = {
    "Car": 0,
    "Pedestrian": 1,
    "Cyclist": 2,
    "Van": -4,
    "Truck": -4,
    "Person_sitting": -2,
    "Tram": -99,
    "Misc": -99,
    "DontCare": -1,
}

PI = np.pi
ALPHA_CENTERS = np.array([0.0, PI / 2, PI, -PI / 2])


def encode_alpha_multibin(alpha: float, num_bin: int = 2, margin: float = 1 / 6) -> np.ndarray:
    """Encode alpha in [-pi, pi] into per-bin membership + offset
    (reference kitti.py:225-244)."""
    encode = np.zeros(num_bin * 2)
    bin_size = 2 * np.pi / num_bin
    margin_size = bin_size * margin
    range_size = bin_size / 2 + margin_size

    offsets = alpha - ALPHA_CENTERS[:num_bin]
    offsets[offsets > np.pi] -= 2 * np.pi
    offsets[offsets < -np.pi] += 2 * np.pi
    for i in range(num_bin):
        if abs(offsets[i]) < range_size:
            encode[i] = 1
            encode[i + num_bin] = offsets[i]
    return encode


@dataclass
class EncodedSample:
    """One preprocessed example. `image` is HWC float32, everything else is
    the fixed-shape target dict."""

    image: np.ndarray
    targets: Dict[str, np.ndarray]
    img_id: str
    calib: Calibration
    image_size: Tuple[int, int]  # original (w, h) before padding


def pad_offset(img_w: int, img_h: int, input_w: int, input_h: int) -> np.ndarray:
    """(pad_x, pad_y): where the image's corner lands on the input canvas,
    centred (reference kitti.py:262-272); the one place the offset is
    decided, for the image and the targets."""
    return np.array([(input_w - img_w) // 2, (input_h - img_h) // 2], dtype=np.int64)


def pad_image(img: np.ndarray, input_height: int, input_width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Center-pad to the fixed input resolution (reference kitti.py:262-272)."""
    h, w, c = img.shape
    out = np.zeros((input_height, input_width, c), dtype=img.dtype)
    pad = pad_offset(w, h, input_width, input_height)
    out[pad[1] : pad[1] + h, pad[0] : pad[0] + w] = img
    return out, pad


def normalize_image(img: np.ndarray, cfg) -> np.ndarray:
    """uint8 HWC -> normalized float32 HWC (reference transforms.py:5-30)."""
    x = img.astype(np.float32) / 255.0
    mean = np.asarray(cfg.input.pixel_mean, np.float32)
    std = np.asarray(cfg.input.pixel_std, np.float32)
    if cfg.input.to_bgr:
        x = x[..., ::-1]
    return (x - mean) / std


def encode_targets(
    img: np.ndarray,
    objs: Optional[Sequence[Object3d]],
    calib: Calibration,
    cfg,
    img_id: str = "000000",
    is_train: bool = True,
) -> EncodedSample:
    """Build the full fixed-shape target dict for one image.

    img: HWC uint8 (original size). Follows kitti.py:306-610.
    """
    input_w, input_h = cfg.input.width_train, cfg.input.height_train
    # images larger than the input canvas are scaled down with the
    # calibration (the reference assumes canvas >= image and would fail on
    # negative padding)
    if img.shape[1] > input_w or img.shape[0] > input_h:
        raise ValueError(f"image {img.shape[1]}x{img.shape[0]} exceeds the input canvas")

    img_h, img_w = img.shape[:2]
    down = cfg.model.backbone.down_ratio
    out_w, out_h = input_w // down, input_h // down
    max_objs = cfg.datasets.max_objects
    num_cls = cfg.datasets.max_classes_num
    extra_n = cfg.model.head.extra_kpts_num
    n_kpts = extra_n + 10

    pad_size = pad_offset(img_w, img_h, input_w, input_h)

    x_min, y_min = int(np.ceil(pad_size[0] / down)), int(np.ceil(pad_size[1] / down))
    x_max, y_max = (pad_size[0] + img_w - 1) // down, (pad_size[1] + img_h - 1) // down

    max_edge_length = (out_w + out_h) * 2
    edge_indices_arr = np.zeros([max_edge_length, 2], dtype=np.int64)
    edge_count = 0
    if cfg.model.head.enable_edge_fusion:
        edge_indices = get_edge_indices((img_w, img_h), pad_size, down)
        edge_count = edge_indices.shape[0]
        edge_indices_arr[:edge_count] = edge_indices
        edge_count = edge_count - 1  # reference subtracts 1 (kitti.py:336)

    targets: Dict[str, np.ndarray] = {}

    heat_map = np.zeros([num_cls, out_h, out_w], dtype=np.float32)
    cls_ids = np.zeros([max_objs], dtype=np.int32)
    target_centers = np.zeros([max_objs, 2], dtype=np.int32)
    bboxes = np.zeros([max_objs, 4], dtype=np.float32)
    extra_kpts_3d = np.zeros([max_objs, n_kpts, 3], dtype=np.float32)
    extra_kpts_2d = np.zeros([max_objs, n_kpts, 3], dtype=np.float32)
    calib_p = np.zeros([max_objs, 3, 4], dtype=np.float32)
    find_pcl = np.zeros([max_objs], dtype=np.float32)
    keypoints = np.zeros([max_objs, 10, 3], dtype=np.float32)
    keypoints_depth_mask = np.zeros([max_objs, 3], dtype=np.float32)
    extra_kpts_depth_mask = np.zeros([max_objs, n_kpts], dtype=np.float32)
    dimensions = np.zeros([max_objs, 3], dtype=np.float32)
    locations = np.zeros([max_objs, 3], dtype=np.float32)
    rotys = np.zeros([max_objs], dtype=np.float32)
    alphas = np.zeros([max_objs], dtype=np.float32)
    offset_3d = np.zeros([max_objs, 2], dtype=np.float32)
    nbins = cfg.input.orientation_bin_size
    orientations = np.zeros([max_objs, nbins * 2], dtype=np.float32)
    reg_mask = np.zeros([max_objs], dtype=np.float32)
    trunc_mask = np.zeros([max_objs], dtype=np.float32)
    reg_weight = np.zeros([max_objs], dtype=np.float32)
    ori_mask = np.ones([max_objs], dtype=np.float32)
    splat_jobs = []  # (cls_id, center, rx, ry, kind), drawn together

    if objs is not None:
        for i, obj in enumerate(objs):
            if i >= max_objs:
                break
            cls_id = TYPE_ID_CONVERSION.get(obj.type, -99)
            if cls_id < 0:
                continue

            # bottom center -> 3D (mid-height) center (kitti.py:417-419)
            locs = obj.t.copy().astype(np.float64)
            locs[1] = locs[1] - obj.h / 2
            if locs[-1] <= 0:
                continue

            corners_3d = obj.generate_corners3d()
            corners_2d, _ = calib.project_rect_to_image(corners_3d)
            projected_box2d = np.array(
                [
                    corners_2d[:, 0].min(),
                    corners_2d[:, 1].min(),
                    corners_2d[:, 0].max(),
                    corners_2d[:, 1].max(),
                ]
            )
            if (
                projected_box2d[0] >= 0
                and projected_box2d[1] >= 0
                and projected_box2d[2] <= img_w - 1
                and projected_box2d[3] <= img_h - 1
            ):
                box2d = projected_box2d.copy()
            else:
                box2d = obj.box2d.copy().astype(np.float64)

            if cfg.datasets.filter_anno_enable:
                fp = cfg.datasets.filter_annos
                if obj.truncation >= fp[0] and (box2d[2:] - box2d[:2]).min() <= fp[1]:
                    continue

            proj_center, _ = calib.project_rect_to_image(locs.reshape(1, 3))
            proj_center = proj_center[0]
            proj_inside = (0 <= proj_center[0] <= img_w - 1) and (0 <= proj_center[1] <= img_h - 1)

            approx_center = False
            if not proj_inside:
                if cfg.datasets.consider_outside_objs:
                    approx_center = True
                    center_2d = (box2d[:2] + box2d[2:]) / 2
                    res = approx_proj_center(proj_center, center_2d.reshape(1, 2), (img_w, img_h))
                    if res is None:
                        continue
                    target_proj_center, _ = res
                else:
                    continue
            else:
                target_proj_center = proj_center.copy()

            # 10 box keypoints: 8 corners + bottom/top face centers
            bot_top_centers = np.stack(
                (corners_3d[:4].mean(axis=0), corners_3d[4:].mean(axis=0)), axis=0
            )
            keypoints_3d_cam = np.concatenate((corners_3d, bot_top_centers), axis=0)
            keypoints_2d, _ = calib.project_rect_to_image(keypoints_3d_cam)
            ek3 = obj.extra_kpts_3D
            ek_cam = obj.generate_extra_kpts_3d_loc()
            ek_2d, _ = calib.project_rect_to_image(ek_cam)

            kx = (keypoints_2d[:, 0] >= 0) & (keypoints_2d[:, 0] <= img_w - 1)
            ky = (keypoints_2d[:, 1] >= 0) & (keypoints_2d[:, 1] <= img_h - 1)
            kz = keypoints_3d_cam[:, -1] > 0
            ex = (ek_2d[:, 0] >= 0) & (ek_2d[:, 0] <= img_w - 1)
            ey = (ek_2d[:, 1] >= 0) & (ek_2d[:, 1] <= img_h - 1)
            ez = ek_cam[:, -1] > 0
            keypoints_visible = kx & ky & kz
            extra_visible = ex & ey & ez
            keypoints_depth_valid = np.stack(
                (
                    keypoints_visible[[8, 9]].all(),
                    keypoints_visible[[0, 2, 4, 6]].all(),
                    keypoints_visible[[1, 3, 5, 7]].all(),
                )
            )
            extra_depth_valid = extra_visible.copy()

            if cfg.input.keypoint_visible_modify:
                # symmetric visibility transfer (kitti.py:483-488)
                keypoints_visible = np.append(
                    np.tile(keypoints_visible[:4] | keypoints_visible[4:8], 2),
                    np.tile(keypoints_visible[8] | keypoints_visible[9], 2),
                )
                keypoints_depth_valid = np.stack(
                    (
                        keypoints_visible[[8, 9]].all(),
                        keypoints_visible[[0, 2, 4, 6]].all(),
                        keypoints_visible[[1, 3, 5, 7]].all(),
                    )
                )
            keypoints_visible = keypoints_visible.astype(np.float32)
            keypoints_depth_valid = keypoints_depth_valid.astype(np.float32)

            # downsample to feature-map scale (kitti.py:490-498)
            keypoints_2d = (keypoints_2d + pad_size.reshape(1, 2)) / down
            ek_2d_fm = (ek_2d[:, :2] + pad_size.reshape(1, 2)) / down
            target_proj_center_fm = (target_proj_center + pad_size) / down
            proj_center_fm = (proj_center + pad_size) / down

            box2d = box2d.copy()
            box2d[0::2] += pad_size[0]
            box2d[1::2] += pad_size[1]
            box2d /= down
            bbox_center = (box2d[:2] + box2d[2:]) / 2
            bbox_dim = box2d[2:] - box2d[:2]

            if cfg.input.heatmap_center == "2D":
                target_center = bbox_center.round().astype(np.int64)
            else:
                target_center = target_proj_center_fm.round().astype(np.int64)
            target_center[0] = np.clip(target_center[0], x_min, x_max)
            target_center[1] = np.clip(target_center[1], y_min, y_max)

            pred_2d = (
                target_center[0] >= box2d[0]
                and target_center[1] >= box2d[1]
                and target_center[0] <= box2d[2]
                and target_center[1] <= box2d[3]
            )

            if (bbox_dim > 0).all() and 0 <= target_center[0] <= out_w - 1 and 0 <= target_center[1] <= out_h - 1:
                if cfg.input.adjust_boundary_heatmap and approx_center:
                    bw = min(target_center[0] - box2d[0], box2d[2] - target_center[0])
                    bh = min(target_center[1] - box2d[1], box2d[3] - target_center[1])
                    rx = max(0, int(bw * cfg.input.heatmap_ratio))
                    ry_ = max(0, int(bh * cfg.input.heatmap_ratio))
                    splat_jobs.append((cls_id, target_center.copy(), rx, ry_, 1))
                else:
                    radius = hm_coder.gaussian_radius(bbox_dim[1], bbox_dim[0])
                    radius = max(0, int(radius))
                    splat_jobs.append((cls_id, target_center.copy(), radius, radius, 0))

                cls_ids[i] = cls_id
                target_centers[i] = target_center
                offset_3d[i] = proj_center_fm - target_center
                if pred_2d:
                    bboxes[i] = box2d
                keypoints[i] = np.concatenate(
                    (keypoints_2d - target_center.reshape(1, -1), keypoints_visible[:, None]), axis=1
                )
                extra_tmp = np.concatenate(
                    (ek_2d_fm - target_center.reshape(1, -1), extra_visible[:, None].astype(np.float32)),
                    axis=1,
                )
                extra_kpts_2d[i] = np.vstack((extra_tmp, keypoints[i]))
                extra_kpts_3d[i] = np.vstack((ek3, obj.raw_kpts_3d()))
                calib_p[i] = calib.P
                find_pcl[i] = obj.find_pcl
                keypoints_depth_mask[i] = keypoints_depth_valid
                extra_kpts_depth_mask[i] = np.concatenate((extra_depth_valid, keypoints_visible))
                dimensions[i] = np.array([obj.l, obj.h, obj.w])
                locations[i] = locs
                rotys[i] = obj.ry
                alphas[i] = obj.alpha
                orientations[i] = encode_alpha_multibin(obj.alpha, num_bin=nbins)
                reg_mask[i] = 1
                reg_weight[i] = 1
                trunc_mask[i] = float(approx_center)

    if splat_jobs:
        hm_coder.splat_batch(
            heat_map,
            np.array([j[0] for j in splat_jobs], np.int32),
            np.stack([j[1] for j in splat_jobs]).astype(np.int32),
            np.array([j[2] for j in splat_jobs], np.int32),
            np.array([j[3] for j in splat_jobs], np.int32),
            np.array([j[4] for j in splat_jobs], np.int32),
        )

    targets = dict(
        hm=heat_map,
        cls_ids=cls_ids,
        target_centers=target_centers,
        bboxes_2d=bboxes,
        keypoints=keypoints,
        keypoints_depth_mask=keypoints_depth_mask,
        extra_kpts_2d=extra_kpts_2d,
        extra_kpts_3d=extra_kpts_3d,
        Calib_P=calib_p,
        find_pcl=find_pcl,
        extra_kpts_depth_mask=extra_kpts_depth_mask,
        dimensions=dimensions,
        locations=locations,
        rotys=rotys,
        alphas=alphas,
        orientations=orientations,
        offset_3D=offset_3d,
        reg_mask=reg_mask,
        reg_weight=reg_weight,
        trunc_mask=trunc_mask,
        ori_mask=ori_mask,
        pad_size=pad_size.astype(np.float32),
        calib_P_full=calib.P.astype(np.float32),
        image_size=np.array([img_w, img_h], dtype=np.float32),
        edge_indices=edge_indices_arr,
        edge_len=np.array(edge_count, dtype=np.int32),
    )

    # reference pad_image + ToTensor/Normalize (kitti.py:262-272,
    # transforms.py:5-30)
    image = normalize_image(pad_image(img, input_h, input_w)[0], cfg)
    return EncodedSample(image=image, targets=targets, img_id=img_id, calib=calib, image_size=(img_w, img_h))


def collate(samples: List[EncodedSample]) -> Dict[str, np.ndarray]:
    """Stack encoded samples into one batch dict (+ images under 'images')."""
    batch = {k: np.stack([s.targets[k] for s in samples]) for k in samples[0].targets}
    batch["images"] = np.stack([s.image for s in samples])
    return batch
