"""gen_data JSON interchange between DGDE (stage 1) and GMW (stage 2).

A copy of ``dcd_tpu/data/gen_data.py`` (numpy and JSON only): the port
writes and reads the same files, byte for byte.

Schema is bit-compatible with the reference so either stage can interop
with reference artifacts:

* train file (``gen_data_train.json``): columns of per-batch lists —
  kpts_2d, kpts_3d, pred_rot, gt_location, pred_location, weight_img,
  img_idx (reference detector_loss.py:96-104, dumped trainer.py:208-215).
* infer file (``gen_data_infer.json``): per-image lists of dicts with
  kpts_2d, kpts_3d, pred_rot, box, dim, pred_location, score, cat
  (reference engine/inference.py:59-84).

2D keypoints are stored *normalized by the intrinsics*:
``x_n = (u - cx) / fx`` (detector_loss.py:152-155).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def normalize_kpts_2d(kpts_2d_img: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Pixel keypoints (N, n, 2) -> intrinsics-normalized coords."""
    out = kpts_2d_img.astype(np.float64).copy()
    out[..., 0] = (kpts_2d_img[..., 0] - P[0, 2]) / P[0, 0]
    out[..., 1] = (kpts_2d_img[..., 1] - P[1, 2]) / P[1, 1]
    return out


def normalize_batch_kpts(
    kpts_2d_img: np.ndarray,
    sample_of_obj: np.ndarray,
    calib_Ps: Sequence[np.ndarray],
    per_sample_calib: bool = False,
) -> np.ndarray:
    """Normalize a masked batch of object keypoints (M, n, 2) by intrinsics.

    ``per_sample_calib=False`` reproduces the reference quirk of using
    sample 0's calibration for every object in the batch
    (detector_loss.py:150: ``calib[0].P``); ``True`` is the corrected mode
    where object j uses its own sample's P (``sample_of_obj[j]``).
    """
    if not per_sample_calib:
        return normalize_kpts_2d(kpts_2d_img, calib_Ps[0])
    if len(kpts_2d_img) == 0:
        return kpts_2d_img.astype(np.float64)
    return np.stack([
        normalize_kpts_2d(kp, calib_Ps[int(k)])
        for kp, k in zip(kpts_2d_img, sample_of_obj)
    ])


class GenDataTrainWriter:
    """Accumulates per-batch training interchange rows (reference
    Loss_Computation.generate_data, detector_loss.py:148-173)."""

    def __init__(self):
        self.data = {
            "kpts_2d": [],
            "kpts_3d": [],
            "pred_rot": [],
            "gt_location": [],
            "pred_location": [],
            "weight_img": [],
            "img_idx": [],
        }

    def add_batch(
        self,
        kpts_2d_norm: np.ndarray,  # (N, n, 2) already normalized
        kpts_3d: np.ndarray,  # (N, n, 3)
        pred_rot: np.ndarray,  # (N,)
        gt_location: np.ndarray,  # (N, 3)
        pred_location: np.ndarray,  # (N, 3)
        img_idx: Sequence[str],  # len N
    ):
        self.data["kpts_2d"].append(np.asarray(kpts_2d_norm).tolist())
        self.data["kpts_3d"].append(np.asarray(kpts_3d).tolist())
        self.data["pred_rot"].append(np.asarray(pred_rot).reshape(-1).tolist())
        self.data["gt_location"].append(np.asarray(gt_location).tolist())
        self.data["pred_location"].append(np.asarray(pred_location).tolist())
        self.data["img_idx"].append(list(img_idx))

    def dump(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.data, f, indent=4)


class GenDataInferWriter:
    """Per-image inference interchange (reference inference.py:59-84)."""

    def __init__(self):
        self.data: Dict[str, List[dict]] = {}

    def add_image(
        self,
        img_id: str,
        dets: np.ndarray,  # (K, 14) postprocess rows
        valid: np.ndarray,  # (K,)
        kpts_2d_norm: np.ndarray,  # (K, n, 2)
        kpts_3d: np.ndarray,  # (K, n, 3)
        cat: str = "Car",
    ):
        self.data[img_id] = []
        for k in range(dets.shape[0]):
            if not valid[k]:
                continue
            row = dets[k]
            self.data[img_id].append(
                {
                    "kpts_2d": np.asarray(kpts_2d_norm[k]).tolist(),
                    "kpts_3d": np.asarray(kpts_3d[k]).tolist(),
                    "pred_rot": [float(row[12])],
                    "box": np.asarray(row[2:6]).tolist(),
                    "dim": np.asarray(row[6:9]).tolist(),
                    "pred_location": np.asarray(row[9:12]).tolist(),
                    "score": [float(row[13])],
                    "cat": cat,
                }
            )

    def dump(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.data, f, indent=4)


def load_gen_data_train(path: str, num_kpts: int = 73):
    """Flatten the train interchange into arrays
    (reference GMW/utilities/dataset_utilities.py:21-36)."""
    with open(path, "r") as f:
        data = json.load(f)
    out = {"kpts_2d": [], "kpts_3d": [], "pred_rot": [], "gt_location": []}
    N = len(data["kpts_2d"])
    for i in range(N):
        K = len(data["kpts_2d"][i])
        for j in range(K):
            out["kpts_2d"].append(np.asarray(data["kpts_2d"][i][j], np.float32))
            out["kpts_3d"].append(np.asarray(data["kpts_3d"][i][j], np.float32))
            out["pred_rot"].append([data["pred_rot"][i][j]])
            out["gt_location"].append(np.asarray(data["gt_location"][i][j], np.float32))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def load_gen_data_infer(path: str, num_kpts: int = 73):
    """Flatten the infer interchange (reference dataset_utilities.py:38-54).

    Returns dict of arrays plus img_idx list of (img_id, det_idx)."""
    with open(path, "r") as f:
        data = json.load(f)
    out = {"kpts_2d": [], "kpts_3d": [], "pred_rot": [], "pred_location": [], "dim": []}
    img_idx: List[Tuple[str, int]] = []
    for img in data:
        for i, a in enumerate(data[img]):
            out["kpts_2d"].append(
                np.asarray(a["kpts_2d"], np.float32).reshape(-1, 2)[:num_kpts]
            )
            out["kpts_3d"].append(
                np.asarray(a["kpts_3d"], np.float32).reshape(-1, 3)[:num_kpts]
            )
            out["pred_rot"].append(np.asarray(a["pred_rot"], np.float32))
            out["pred_location"].append(np.asarray(a["pred_location"], np.float32))
            out["dim"].append(np.asarray(a["dim"], np.float32))
            img_idx.append((img, i))
    arrays = {k: np.asarray(v, np.float32) for k, v in out.items()}
    return arrays, img_idx
