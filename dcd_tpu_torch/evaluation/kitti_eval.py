"""Official KITTI AP evaluation (11-point R11 / 40-point R40).

A copy of the JAX package's evaluator (``dcd_tpu/evaluation/kitti_eval.py``),
numpy, so that the port imports nothing of ``dcd_tpu``. It is the reference
protocol (``GMW/evaluation/kitti_object_eval_python/eval.py``): threshold
selection (get_thresholds :8-25), difficulty/class ignore semantics
(clean_data :28-81), the greedy TP/FP matching with ignore and DontCare
handling (compute_statistics_jit :156-273), per-image IoU (calculate_iou_partly
:338-412) and the AP summaries (get_mAP :554-566); the rotated IoU is
:mod:`.rotate_iou`.

The per-image matching runs in the fused C++ matcher of :mod:`.native` (one
call per image covers every score threshold, as the reference's
fused_compute_statistics, eval.py:276-335). ``use_native=False`` runs the
Python protocol loops instead: the plain version that the native matcher is
held to. Unlike the JAX package, a native library that does not build raises;
nothing falls back to the loops silently.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from . import native
from .rotate_iou import rotate_iou_eval

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting", "truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = 41) -> List[float]:
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < (len(scores) - 1)
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class]
    num_gt = len(gt_anno["name"])
    num_dt = len(dt_anno["name"])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno["bbox"][i]
        gt_name = gt_anno["name"][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (
            (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty])
            or (gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty])
            or (height <= MIN_HEIGHT[difficulty])
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(num_dt):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray, criterion: int = -1) -> np.ndarray:
    """Axis-aligned 2D box overlap, vectorized (reference :84-111)."""
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=boxes.dtype if N else np.float64)
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0])
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1])
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    area_q = (q[..., 2] - q[..., 0]) * (q[..., 3] - q[..., 1])
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape)
    else:
        ua = np.ones_like(inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(inter > 0, inter / ua, 0.0)
    return out.astype(boxes.dtype)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    return rotate_iou_eval(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame 3D IoU: BEV rotated intersection x height overlap
    (reference :119-152). boxes: (N, 7) [x, y, z, l, h, w?, ry] — actually
    [loc(3), dims(3), ry] with dims order from the label (h, w, l -> the
    reference passes dims columns [3], [4], [5] = l, h, w of its anno
    layout)."""
    rinc = rotate_iou_eval(boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], 2)
    N, K = boxes.shape[0], qboxes.shape[0]
    out = rinc.astype(np.float64)
    if N == 0 or K == 0:
        return out
    b = boxes[:, None, :]
    q = qboxes[None, :, :]
    # y grows downward in camera frame; box spans [y - h, y]
    iw = np.minimum(b[..., 1], q[..., 1]) - np.maximum(b[..., 1] - b[..., 4], q[..., 1] - q[..., 4])
    area1 = b[..., 3] * b[..., 4] * b[..., 5]
    area2 = q[..., 3] * q[..., 4] * q[..., 5]
    inc = iw * out
    if criterion == -1:
        ua = area1 + area2 - inc
    elif criterion == 0:
        ua = area1
    elif criterion == 1:
        ua = area2
    else:
        ua = inc
    with np.errstate(divide="ignore", invalid="ignore"):
        res = np.where((out > 0) & (iw > 0), inc / ua, 0.0)
    return res


def compute_statistics(
    overlaps,
    gt_datas,
    dt_datas,
    ignored_gt,
    ignored_det,
    dc_bboxes,
    metric,
    min_overlap,
    thresh=0.0,
    compute_fp=False,
    compute_aos=False,
):
    """Greedy matching per image (reference compute_statistics_jit :156-273)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True
    NO_DETECTION = -10000000
    tp, fp, fn, similarity = 0, 0, 0, 0.0
    thresholds = np.zeros((gt_size,))
    thresh_idx = 0
    delta = np.zeros((gt_size,))
    delta_idx = 0
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0
        assigned_ignored_det = False

        for j in range(det_size):
            if ignored_det[j] == -1:
                continue
            if assigned_detection[j]:
                continue
            if ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and (overlap > min_overlap) and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (
                compute_fp
                and (overlap > min_overlap)
                and (overlap > max_overlap or assigned_ignored_det)
                and ignored_det[j] == 0
            ):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (
                compute_fp
                and (overlap > min_overlap)
                and (valid_detection == NO_DETECTION)
                and ignored_det[j] == 1
            ):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if (valid_detection == NO_DETECTION) and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DETECTION) and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds[thresh_idx] = dt_scores[det_idx]
            thresh_idx += 1
            if compute_aos:
                delta[delta_idx] = gt_alphas[i] - dt_alphas[det_idx]
                delta_idx += 1
            assigned_detection[det_idx] = True

    if compute_fp:
        for i in range(det_size):
            if not (
                assigned_detection[i]
                or ignored_det[i] == -1
                or ignored_det[i] == 1
                or ignored_threshold[i]
            ):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            dc = np.asarray(dc_bboxes, dtype=np.float64).reshape(-1, 4)
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc, 0)
            for i in range(dc.shape[0]):
                for j in range(det_size):
                    if assigned_detection[j]:
                        continue
                    if ignored_det[j] == -1 or ignored_det[j] == 1:
                        continue
                    if ignored_threshold[j]:
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            # summed in order, as the reference's numba loop and the native
            # matcher sum (the JAX package's np.sum adds pairwise, which can
            # differ in the last bit)
            similarity = 0.0
            for i in range(delta_idx):
                similarity += (1.0 + np.cos(delta[i])) / 2.0
            similarity = similarity if (tp > 0 or fp > 0) else -1
    return tp, fp, fn, similarity, thresholds[:thresh_idx]


def calculate_iou(gt_annos, dt_annos, metric):
    """Per-image overlaps as DT x GT matrices (reference partitions for
    speed :338-412; one pass per image is fine in vectorized numpy)."""
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(dt["bbox"].astype(np.float64), gt["bbox"].astype(np.float64))
        elif metric == 1:
            def bev(a):
                return np.concatenate(
                    [a["location"][:, [0, 2]], a["dimensions"][:, [0, 2]],
                     a["rotation_y"][..., None]], axis=1)
            o = bev_box_overlap(bev(dt), bev(gt)).astype(np.float64)
        elif metric == 2:
            def full(a):
                return np.concatenate(
                    [a["location"], a["dimensions"], a["rotation_y"][..., None]], axis=1)
            o = d3_box_overlap(full(dt), full(gt)).astype(np.float64)
        else:
            raise ValueError(metric)
        overlaps.append(o)
    return overlaps


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt, dt, current_class, difficulty
        )
        ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
        ignored_dets.append(np.array(ignored_det, dtype=np.int64))
        dontcares.append(
            np.stack(dc_bboxes, 0).astype(np.float64) if dc_bboxes else np.zeros((0, 4))
        )
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate([gt["bbox"], gt["alpha"][..., None]], 1))
        dt_datas_list.append(
            np.concatenate([dt["bbox"], dt["alpha"][..., None], dt["score"][..., None]], 1)
        )
    return gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares, total_num_valid_gt


def eval_class(
    gt_annos,
    dt_annos,
    current_classes,
    difficultys,
    metric,
    min_overlaps,
    compute_aos=False,
    use_native=True,
):
    assert len(gt_annos) == len(dt_annos)
    overlaps = calculate_iou(gt_annos, dt_annos, metric)
    N_SAMPLE_PTS = 41
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    aos = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (
                gt_datas_list,
                dt_datas_list,
                ignored_gts,
                ignored_dets,
                dontcares,
                total_num_valid_gt,
            ) = _prepare_data(gt_annos, dt_annos, current_class, difficulty)
            # precompute det-vs-DontCare overlaps once per image (used by
            # the native fused matcher; threshold/min_overlap independent)
            dt_dc_overlaps = [
                image_box_overlap(
                    dt_datas_list[i][:, :4].astype(np.float64), dontcares[i], 0
                )
                if use_native and metric == 0 and dontcares[i].shape[0] > 0
                else None
                for i in range(len(gt_annos))
            ]
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    if use_native:
                        th = native.kitti_match_scores(
                            overlaps[i], dt_datas_list[i][:, -1],
                            ignored_gts[i], ignored_dets[i], min_overlap,
                        )
                    else:
                        _, _, _, _, th = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=0.0, compute_fp=False,
                        )
                    thresholdss += th.tolist()
                thresholds = np.array(get_thresholds(np.array(thresholdss), total_num_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    if use_native:
                        native.kitti_fused_statistics(
                            overlaps[i], dt_datas_list[i][:, -1], dt_datas_list[i][:, 4],
                            gt_datas_list[i][:, 4], dt_dc_overlaps[i],
                            ignored_gts[i], ignored_dets[i], metric, min_overlap,
                            thresholds, compute_aos, pr,
                        )
                        continue
                    for t, thr in enumerate(thresholds):
                        tp, fp, fn, similarity, _ = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=thr,
                            compute_fp=True, compute_aos=compute_aos,
                        )
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if similarity != -1:
                            pr[t, 3] += similarity
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:], axis=-1)
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False, metric="R40",
            use_native=True):
    difficultys = [0, 1, 2]
    get_mAP_fnc = get_mAP_R40 if metric == "R40" else get_mAP
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0, min_overlaps, compute_aos,
                     use_native=use_native)
    mAP_bbox = get_mAP_fnc(ret["precision"])
    mAP_aos = get_mAP_fnc(ret["orientation"]) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps,
                     use_native=use_native)
    mAP_bev = get_mAP_fnc(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps,
                     use_native=use_native)
    mAP_3d = get_mAP_fnc(ret["precision"])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


CLASS_TO_NAME = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van", 4: "Person_sitting", 5: "Truck"}


def get_official_eval_result(gt_annos, dt_annos, current_classes, metric="R40", use_native=True):
    """Returns (result string, ret_dict) like the reference (:644-...);
    ``use_native=False`` matches with the Python protocol loops."""
    overlap_0_7 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3
    )
    overlap_0_5 = np.array(
        [
            [0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
        ]
    )
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else c for c in current_classes
    ]
    min_overlaps = min_overlaps[:, :, current_classes]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos, metric=metric,
        use_native=use_native,
    )

    # result string and ret_dict keys mirror the reference exactly
    # (eval.py:691-727: "Car AP@0.70, 0.70, 0.70:" headers, Car_3d_0.70/easy
    # key style, bbox keyed as Car_image/*); the {name}_3d_{diff}_R40_{ov}
    # style keys are kept as extras for the rest of this codebase.
    result = ""
    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        name = CLASS_TO_NAME[curcls]
        for i in range(min_overlaps.shape[0]):
            result += "{} AP@{:.2f}, {:.2f}, {:.2f}:\n".format(
                name, *min_overlaps[i, :, j]
            )
            result += "bbox AP:{:.4f}, {:.4f}, {:.4f}\n".format(*mAPbbox[j, :, i])
            result += "bev  AP:{:.4f}, {:.4f}, {:.4f}\n".format(*mAPbev[j, :, i])
            result += "3d   AP:{:.4f}, {:.4f}, {:.4f}\n".format(*mAP3d[j, :, i])
            if compute_aos:
                result += "aos  AP:{:.2f}, {:.2f}, {:.2f}\n".format(*mAPaos[j, :, i])
                if i == 0:
                    ret_dict[f"{name}_aos/easy"] = mAPaos[j, 0, 0]
                    ret_dict[f"{name}_aos/moderate"] = mAPaos[j, 1, 0]
                    ret_dict[f"{name}_aos/hard"] = mAPaos[j, 2, 0]
            for d, diff in enumerate(["easy", "moderate", "hard"]):
                ret_dict["{}_3d_{:.2f}/{}".format(name, min_overlaps[i, 1, j], diff)] = mAP3d[j, d, i]
                ret_dict["{}_bev_{:.2f}/{}".format(name, min_overlaps[i, 2, j], diff)] = mAPbev[j, d, i]
                ret_dict["{}_image/{}".format(name, diff)] = mAPbbox[j, d, 0]
                ret_dict[f"{name}_3d_{diff}_{'R40' if metric=='R40' else 'R11'}_{min_overlaps[i,2,j]:.2f}"] = mAP3d[j, d, i]
                ret_dict[f"{name}_bev_{diff}_{'R40' if metric=='R40' else 'R11'}_{min_overlaps[i,1,j]:.2f}"] = mAPbev[j, d, i]
    return result, ret_dict


# ---------------------------------------------------------------------------
# Label IO (reference kitti_common.py get_label_annos)
# ---------------------------------------------------------------------------


def get_label_anno(path: str) -> Dict[str, np.ndarray]:
    annotations = {
        "name": [], "truncated": [], "occluded": [], "alpha": [], "bbox": [],
        "dimensions": [], "location": [], "rotation_y": [], "score": [],
    }
    with open(path, "r") as f:
        lines = [l.strip().split(" ") for l in f.readlines() if l.strip()]
    for x in lines:
        annotations["name"].append(x[0])
        annotations["truncated"].append(float(x[1]))
        annotations["occluded"].append(int(float(x[2])))
        annotations["alpha"].append(float(x[3]))
        annotations["bbox"].append([float(v) for v in x[4:8]])
        # KITTI labels store h, w, l; the eval layout uses l, h, w
        annotations["dimensions"].append([float(x[10]), float(x[8]), float(x[9])])
        annotations["location"].append([float(v) for v in x[11:14]])
        annotations["rotation_y"].append(float(x[14]))
        annotations["score"].append(float(x[15]) if len(x) == 16 else -1.0)
    n = len(lines)
    return {
        "name": np.array(annotations["name"]),
        "truncated": np.array(annotations["truncated"]),
        "occluded": np.array(annotations["occluded"]),
        "alpha": np.array(annotations["alpha"]),
        "bbox": np.array(annotations["bbox"]).reshape(n, 4) if n else np.zeros((0, 4)),
        "dimensions": np.array(annotations["dimensions"]).reshape(n, 3) if n else np.zeros((0, 3)),
        "location": np.array(annotations["location"]).reshape(n, 3) if n else np.zeros((0, 3)),
        "rotation_y": np.array(annotations["rotation_y"]),
        "score": np.array(annotations["score"]),
    }


def evaluate_from_files(
    label_path: str,
    result_path: str,
    label_split_file: str,
    current_class: int = 0,
    metric: str = "R40",
    use_native: bool = True,
):
    """Reference evaluate.py:15-32: read gt + dt txts and run the protocol."""
    with open(label_split_file, "r") as f:
        ids = [l.strip() for l in f if l.strip()]
    gt_annos = [get_label_anno(os.path.join(label_path, f"{i}.txt")) for i in ids]
    dt_annos = [get_label_anno(os.path.join(result_path, f"{i}.txt")) for i in ids]
    return get_official_eval_result(gt_annos, dt_annos, current_class, metric=metric,
                                    use_native=use_native)
