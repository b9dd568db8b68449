"""Geometry decoders used by inference, fp32.

The counterpart of the decoders of ``dcd_tpu/ops/codec.py`` that
:func:`dcd_tpu_torch.engine.infer.postprocess` calls (reference
``DGDE/model/anno_encoder.py``). Per-object ``calib_P`` (N, 3, 4) arrays
stand in for per-image calibration loops, and the edge-pair depth solve
gathers over upper-triangle index pairs instead of building (n, n)
matrices.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

PI = float(np.pi)

# multi-bin orientation centres (reference anno_encoder.py:40)
ALPHA_CENTERS = (0.0, PI / 2, PI, -PI / 2)


@functools.lru_cache(maxsize=None)
def triu_pair_indices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(i, j) index arrays of all i<j pairs, in the order of the reference's
    ``get_up`` double loop (anno_encoder.py:313-324)."""
    i_idx, j_idx = np.triu_indices(n, k=1)
    return i_idx.astype(np.int64), j_idx.astype(np.int64)


def decode_depth(depths_offset: torch.Tensor, mode: str = "inv_sigmoid",
                 depth_ref: Tuple[float, float] = (26.494627, 16.05988),
                 depth_range: Optional[Tuple[float, float]] = (0.1, 100.0)) -> torch.Tensor:
    """Depth-head output -> metric depth (reference anno_encoder.py:130-145)."""
    if mode == "exp":
        depth = torch.exp(depths_offset)
    elif mode == "linear":
        depth = depths_offset * depth_ref[1] + depth_ref[0]
    elif mode == "inv_sigmoid":
        depth = 1.0 / torch.clamp(torch.sigmoid(depths_offset), min=1e-12) - 1.0
    else:
        raise ValueError(f"unknown depth mode {mode}")
    if depth_range is not None:
        depth = torch.clamp(depth, depth_range[0], depth_range[1])
    return depth


def project_image_to_rect(uv: torch.Tensor, depth: torch.Tensor, calib_P: torch.Tensor) -> torch.Tensor:
    """(N, 2) pixels + (N,) depth + (N, 3, 4) P -> (N, 3) camera XYZ."""
    c_u, c_v = calib_P[:, 0, 2], calib_P[:, 1, 2]
    f_u, f_v = calib_P[:, 0, 0], calib_P[:, 1, 1]
    b_x = calib_P[:, 0, 3] / (-f_u)
    b_y = calib_P[:, 1, 3] / (-f_v)
    x = (uv[:, 0] - c_u) * depth / f_u + b_x
    y = (uv[:, 1] - c_v) * depth / f_v + b_y
    return torch.stack([x, y, depth], dim=1)


def decode_location(points, offsets, depths, calib_P, pad_size, down_ratio: int = 4):
    """Feature-map points + sub-pixel offsets + depths -> camera locations
    (reference anno_encoder.py:147-161)."""
    uv = (points + offsets) * down_ratio - pad_size
    return project_image_to_rect(uv, depths, calib_P)


def decode_depth_from_keypoints(pred_keypoints, pred_dimensions, calib_P, down_ratio: int = 4,
                                eps: float = 1e-3,
                                depth_range: Tuple[float, float] = (0.1, 100.0)) -> torch.Tensor:
    """Keypoint vertical extents -> (N, 3) depths [centre, corners 0/2,
    corners 1/3] (reference anno_encoder.py:193-224)."""
    f_u = calib_P[:, 0, 0]
    h3d = pred_dimensions[:, 1]
    center_height = pred_keypoints[:, -2, 1] - pred_keypoints[:, -1, 1]
    corner_02_height = pred_keypoints[:, [0, 2], 1] - pred_keypoints[:, [4, 6], 1]
    corner_13_height = pred_keypoints[:, [1, 3], 1] - pred_keypoints[:, [5, 7], 1]
    fh = f_u * h3d
    center_depth = fh / (torch.relu(center_height) * down_ratio + eps)
    corner_02_depth = fh[:, None] / (torch.relu(corner_02_height) * down_ratio + eps)
    corner_13_depth = fh[:, None] / (torch.relu(corner_13_height) * down_ratio + eps)
    depths = torch.stack(
        [center_depth, corner_02_depth.mean(dim=1), corner_13_depth.mean(dim=1)], dim=1)
    return torch.clamp(depths, depth_range[0], depth_range[1])


def decode_dimension(cls_id, dims_offset, dim_mean, dim_std, modes=("exp", True, False)):
    """Dimension residuals -> metric l/h/w (reference anno_encoder.py:226-252)."""
    if modes[0] == "None":
        return dims_offset
    cls_id = cls_id.reshape(-1).long()
    mean = dim_mean[cls_id]
    if modes[0] == "exp":
        dims_offset = torch.exp(dims_offset)
    if modes[2]:
        return dims_offset * dim_std[cls_id] + mean
    return dims_offset * mean


def _wrap(a: torch.Tensor) -> torch.Tensor:
    a = torch.where(a > PI, a - 2 * PI, a)
    return torch.where(a < -PI, a + 2 * PI, a)


def decode_axes_orientation(vector_ori, locations, orien_bin_size: int = 4):
    """Multi-bin orientation + locations -> (roty, alpha)
    (reference anno_encoder.py:254-304)."""
    nb = orien_bin_size
    bin_logits = vector_ori[:, : nb * 2].reshape(-1, nb, 2)
    bin_prob = torch.softmax(bin_logits, dim=2)[..., 1]
    best_bin = torch.argmax(bin_prob, dim=1)
    offs = vector_ori[:, nb * 2:].reshape(-1, nb, 2)
    chosen = torch.gather(offs, 1, best_bin[:, None, None].expand(-1, 1, 2))[:, 0]
    centers = torch.tensor(ALPHA_CENTERS[:nb], dtype=vector_ori.dtype, device=vector_ori.device)
    alphas = torch.atan2(chosen[:, 0], chosen[:, 1]) + centers[best_bin]
    locations = locations.reshape(-1, 3)
    rays = torch.atan2(locations[:, 0], locations[:, 2])
    return _wrap(alphas + rays), _wrap(alphas)


def decode_kpts_2d_img(kpts_2d, bbox_points, offset_3d, pad_size, down_ratio: int = 4):
    """Keypoint offsets -> original-image pixels (reference anno_encoder.py:392-393)."""
    center = (bbox_points + offset_3d)[:, None, :]
    return (kpts_2d + center) * down_ratio - pad_size[:, None, :]


def decode_pairs_kpts_depth(kpts_2d_img, kpts_3d, rot_y, calib_P,
                            clamp: Tuple[float, float] = (2.0, 80.0)) -> torch.Tensor:
    """Closed-form depth from every keypoint pair, the paper's edge depths
    (reference anno_encoder.py:326-390, inference form).

    With normalised image rows y_k and object-local 3D keypoints rotated by
    roty, each pair (i, j) gives ``Z_ij = |h_i - h_j| / |y_i - y_j|`` where
    ``h_k = Y_k + y_k (X_k sin r - Z_k cos r)``. Returns (N, n(n-1)/2)
    depths, minus ``P[2, 3]``.
    """
    n = kpts_2d_img.shape[1]
    fy = calib_P[:, 1, 1:2]
    cy = calib_P[:, 1, 2:3]
    b3 = calib_P[:, 2, 3]
    y_n = (kpts_2d_img[:, :, 1] - cy) / fy
    X, Y, Z = kpts_3d[:, :, 0], kpts_3d[:, :, 1], kpts_3d[:, :, 2]
    rot = rot_y.reshape(-1, 1)
    h = Y + y_n * (X * torch.sin(rot) - Z * torch.cos(rot))
    i_np, j_np = triu_pair_indices(n)
    i_idx = torch.from_numpy(i_np).to(h.device)
    j_idx = torch.from_numpy(j_np).to(h.device)
    dH = h[:, i_idx] - h[:, j_idx]
    dV = y_n[:, i_idx] - y_n[:, j_idx]
    z = torch.abs(dH) / torch.clamp(torch.abs(dV), min=1e-10)
    return torch.clamp(z, clamp[0], clamp[1]) - b3[:, None]
