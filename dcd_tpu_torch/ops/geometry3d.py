"""3D pose geometry: angle-axis rotations, bearings, pose error measures.

The counterpart of ``dcd_tpu/ops/geometry3d.py`` (the reference's
``GMW/utilities/geometry_utilities.py``: Rodrigues angle-axis -> R :3-57,
transformed and normalised points, bearings :59-111; and the pose error
family of ``GMW/lib/losses.py`` :7-127). The shipped pipeline uses only the
correspondence loss; these are the declarative-PnP toolkit of the GMW code.
"""

from __future__ import annotations

import torch


def angle_axis_to_rotation_matrix(angle_axis: torch.Tensor) -> torch.Tensor:
    """(..., 3) angle-axis -> (..., 3, 3) rotation (Rodrigues), with the
    first-order Taylor branch I + skew(w) where theta^2 < 1e-12."""
    theta2 = (angle_axis ** 2).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    wxyz = angle_axis / theta
    wx, wy, wz = wxyz[..., 0], wxyz[..., 1], wxyz[..., 2]
    cos = torch.cos(theta[..., 0])
    sin = torch.sin(theta[..., 0])
    shape = angle_axis.shape[:-1] + (3, 3)
    r = torch.stack([
        cos + wx * wx * (1 - cos),
        wx * wy * (1 - cos) - wz * sin,
        wy * sin + wx * wz * (1 - cos),
        wz * sin + wx * wy * (1 - cos),
        cos + wy * wy * (1 - cos),
        -wx * sin + wy * wz * (1 - cos),
        -wy * sin + wx * wz * (1 - cos),
        wx * sin + wy * wz * (1 - cos),
        cos + wz * wz * (1 - cos),
    ], dim=-1).reshape(shape)
    ax, ay, az = angle_axis[..., 0], angle_axis[..., 1], angle_axis[..., 2]
    ones = torch.ones_like(ax)
    r_taylor = torch.stack([ones, -az, ay, az, ones, -ax, -ay, ax, ones], dim=-1).reshape(shape)
    use_taylor = (theta2[..., 0] < 1e-12)[..., None, None]
    return torch.where(use_taylor, r_taylor, r)


def transform_points(p: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points through (..., 3, 3) R and (..., 3) t."""
    return torch.einsum("...ij,...nj->...ni", R, p) + t[..., None, :]


def normalize_points(p: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=eps)


def points_to_bearings(p2d: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) normalised image points -> (..., N, 3) unit bearings."""
    ones = torch.ones(p2d.shape[:-1] + (1,), dtype=p2d.dtype, device=p2d.device)
    return normalize_points(torch.cat([p2d, ones], dim=-1))


def transform_and_normalise_points(p3d, R, t):
    return normalize_points(transform_points(p3d, R, t))


def correspondence_matrices(R, t, p2d, p3d, threshold: float) -> torch.Tensor:
    """Inlier matrix from a pose: bearing agreement within an angular
    threshold (losses.py:7-13), as 0/1 floats."""
    dot = torch.einsum("...md,...nd->...mn", points_to_bearings(p2d),
                       transform_and_normalise_points(p3d, R, t))
    return (dot >= torch.cos(torch.as_tensor(threshold, dtype=dot.dtype))).to(torch.float32)


def rotation_errors(R, R_gt, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle between rotations (losses.py:36-40)."""
    m = 1.0 - eps
    c = 0.5 * ((R * R_gt).sum(dim=(-2, -1)) - 1.0)
    return torch.arccos(torch.clamp(c, -m, m))


def translation_errors(t, t_gt) -> torch.Tensor:
    return torch.linalg.norm(t - t_gt, dim=-1)


def reprojection_errors(R, t, p2d, p3d, P) -> torch.Tensor:
    """Transport-weighted angular reprojection error:
    sum_mn P_mn (1 - <bearing_2d_m, bearing_3d_n>)."""
    dot = torch.einsum("...md,...nd->...mn", points_to_bearings(p2d),
                       transform_and_normalise_points(p3d, R, t))
    return ((1.0 - dot) * P).sum(dim=(-2, -1))


def reconstruction_errors(R, t, R_gt, t_gt, p) -> torch.Tensor:
    """Mean distance between points under the two poses."""
    return torch.linalg.norm(transform_points(p, R, t) - transform_points(p, R_gt, t_gt),
                             dim=-1).mean(-1)
