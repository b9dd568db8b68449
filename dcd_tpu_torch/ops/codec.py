"""Geometry codec of inference and the training loss, fp32.

The counterpart of ``dcd_tpu/ops/codec.py``: the decoders that
:func:`dcd_tpu_torch.engine.infer.postprocess` and
:func:`dcd_tpu_torch.engine.loss.compute_losses` call, and the 3D box
encoder of the loss (reference ``DGDE/model/anno_encoder.py``).
Per-object ``calib_P`` (N, 3, 4) arrays stand in for per-image calibration
loops, and the edge-pair depth solve gathers over upper-triangle index
pairs instead of building (n, n) matrices.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .nms import topk_like_jax

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


def decode_pairs_kpts_depth(kpts_2d_img, kpts_3d, rot_y, calib_P, training: bool = False,
                            kpts_2d_mask: Optional[torch.Tensor] = None, pairs_topk: int = 1500,
                            clamp: Tuple[float, float] = (2.0, 80.0)):
    """Closed-form depth from every keypoint pair, the paper's edge depths
    (reference anno_encoder.py:326-390).

    With normalised image rows y_k and object-local 3D keypoints rotated by
    roty, each pair (i, j) gives ``Z_ij = |h_i - h_j| / |y_i - y_j|`` where
    ``h_k = Y_k + y_k (X_k sin r - Z_k cos r)``, clamped to ``clamp``, minus
    ``P[2, 3]``.

    Inference form (``training=False``): returns the (N, n(n-1)/2) depths.
    Training form: keeps the ``pairs_topk`` pairs of largest ``|y_i - y_j|``
    (:377-382) and returns ``(depths, pair_mask)``, the mask the product of
    the two keypoints' ``kpts_2d_mask`` (None without one), as the JAX
    package's ``decode_pairs_kpts_depth`` does.
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
    z = torch.clamp(torch.abs(dH) / torch.clamp(torch.abs(dV), min=1e-10), clamp[0], clamp[1])
    if not training:
        return z - b3[:, None]
    pair_mask = None
    if kpts_2d_mask is not None:
        m = kpts_2d_mask.to(z.dtype)
        pair_mask = m[:, i_idx] * m[:, j_idx]
    good = topk_like_jax(torch.abs(dV), pairs_topk)[1]
    z = torch.gather(z, 1, good)
    if pair_mask is not None:
        pair_mask = torch.gather(pair_mask, 1, good)
    return z - b3[:, None], pair_mask


def rad_to_matrix(rotys: torch.Tensor) -> torch.Tensor:
    """(N,) yaw -> (N, 3, 3) rotation about camera Y (reference
    anno_encoder.py:53-71)."""
    cos, sin = torch.cos(rotys), torch.sin(rotys)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([cos, zeros, sin, zeros, ones, zeros, -sin, zeros, cos],
                       dim=-1).reshape(-1, 3, 3)


# corner gather index of encode_box3d (reference anno_encoder.py:119-121)
_BOX3D_INDEX = np.array([
    [4, 5, 0, 1, 6, 7, 2, 3],
    [0, 1, 2, 3, 4, 5, 6, 7],
    [4, 0, 1, 5, 6, 2, 3, 7],
])


def encode_box3d(rotys: torch.Tensor, dims: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """(N,) yaw, (N, 3) l/h/w, (N, 3) centres -> (N, 8, 3) corners
    (reference anno_encoder.py:93-128), fp32."""
    rotys = rotys.reshape(-1)
    dims = dims.reshape(-1, 3).float()
    locs = locs.reshape(-1, 3).float()
    N = rotys.shape[0]
    half = dims.reshape(-1, 1).repeat(1, 8) * 0.5  # (3N, 8)
    half = torch.cat([half[:, :4], -half[:, 4:]], dim=1)
    index = torch.from_numpy(_BOX3D_INDEX).to(dims.device).repeat(N, 1)
    corners = torch.gather(half, 1, index).reshape(N, 3, 8)
    box = torch.matmul(rad_to_matrix(rotys), corners) + locs[:, :, None]
    return box.transpose(1, 2)
