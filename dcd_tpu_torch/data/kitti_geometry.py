"""KITTI geometry the target encoder and the synthetic scenes use: the
calibration, the object, projections and the angle converters.

Copied from the JAX package (``dcd_tpu/data/kitti_geometry.py``), numpy
only; semantics follow the reference ``DGDE/data/datasets/kitti_utils.py``
(Calibration :186-445, Object3d :61-175, alpha<->roty :31-49,
approx_proj_center :1040-1077). The label and calibration file readers are
not copied: the port reads no KITTI tree yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


def convert_rot_to_alpha(ry3d: float, z3d: float, x3d: float) -> float:
    """Global yaw -> observation angle (reference kitti_utils.py:31-40)."""
    alpha = ry3d - math.atan2(x3d, z3d)
    while alpha > math.pi:
        alpha -= 2 * math.pi
    while alpha < -math.pi:
        alpha += 2 * math.pi
    return alpha


def convert_alpha_to_rot(alpha: float, z3d: float, x3d: float) -> float:
    """Observation angle -> global yaw (reference kitti_utils.py:42-49)."""
    ry3d = alpha + math.atan2(x3d, z3d) + 0.5 * math.pi
    while ry3d > math.pi:
        ry3d -= 2 * math.pi
    while ry3d < -math.pi:
        ry3d += 2 * math.pi
    return ry3d


def roty_matrix(ry: float) -> np.ndarray:
    """Rotation about the camera Y axis (reference kitti_utils.py:141-143)."""
    c, s = np.cos(ry), np.sin(ry)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


class Calibration:
    """KITTI camera calibration: P is the 3x4 rect-camera -> image
    projection (the reference's ``Calibration``, kitti_utils.py:186-445, of
    which the encoder and the scenes use the projection alone)."""

    def __init__(self, P: np.ndarray):
        self.P = np.asarray(P, dtype=np.float64).reshape(3, 4)

    def project_rect_to_image(self, pts_3d_rect: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(N,3) rect-camera points -> ((N,2) pixels, (N,) depth).

        Same math as reference kitti_utils.py:361-369.
        """
        pts = np.asarray(pts_3d_rect, dtype=np.float64)
        hom = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
        uvw = hom @ self.P.T
        uv = uvw[:, :2] / uvw[:, 2:3]
        return uv, uvw[:, 2]


@dataclass
class Object3d:
    """Parsed KITTI label row + attached extra (CAD) keypoints.

    Mirrors the reference's Object3d (kitti_utils.py:61-159); the extra
    keypoints are recentred to mid-height (``extra_kpts_3D[:,1] -= h/2``).
    """

    type: str
    truncation: float
    occlusion: int
    alpha_label: float
    box2d: np.ndarray  # (4,) [xmin, ymin, xmax, ymax]
    h: float
    w: float
    l: float
    t: np.ndarray  # (3,) bottom-center location (camera frame)
    ry: float
    extra_kpts_3D: np.ndarray  # (extra_kpts_num, 3), object-local, mid-height origin
    find_pcl: int
    level: int = -1

    @property
    def alpha(self) -> float:
        return convert_rot_to_alpha(self.ry, float(self.t[2]), float(self.t[0]))

    def get_kitti_obj_level(self) -> int:
        # reference kitti_utils.py:115-129
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 2
        return -1

    def generate_corners3d(self) -> np.ndarray:
        """8 corners of the 3D box in camera coords (kitti_utils.py:131-151).

        Corner order (object frame, before rotation):
        x: [l/2, l/2, -l/2, -l/2] * 2 ; y: [0]*4 + [-h]*4 ;
        z: [w/2, -w/2, -w/2, w/2] * 2.
        """
        l, h, w = self.l, self.h, self.w
        x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
        y = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
        z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
        corners = np.stack([x, y, z], axis=0)  # (3, 8)
        out = (roty_matrix(self.ry) @ corners).T + self.t
        return out

    def raw_kpts_3d(self) -> np.ndarray:
        """10 box keypoints in the *object* frame (8 corners + bottom/top
        centers), unrotated — the reference stashes this as ``raw_kpts_3d``
        inside generate_corners3d (kitti_utils.py:147)."""
        l, h, w = self.l, self.h, self.w
        x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
        y = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
        z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
        corners = np.stack([x, y, z], axis=1)  # (8, 3)
        centers = np.array([[0.0, 0.0, 0.0], [0.0, -h, 0.0]])
        return np.concatenate([corners, centers], axis=0)

    def generate_extra_kpts_3d_loc(self) -> np.ndarray:
        """Extra keypoints rotated+translated into camera coords
        (kitti_utils.py:153-159)."""
        return (roty_matrix(self.ry) @ self.extra_kpts_3D.T).T + self.t


def approx_proj_center(
    proj_center: np.ndarray, surface_centers: np.ndarray, img_size: Tuple[int, int]
):
    """Intersect the line (proj_center -> inside surface center) with the
    image border; return the closest valid intersection and its edge index.

    Reference: kitti_utils.py:1040-1077. Returns None when no surface center
    is inside the image.
    """
    img_w, img_h = img_size
    inside = (
        (surface_centers[:, 0] >= 0)
        & (surface_centers[:, 1] >= 0)
        & (surface_centers[:, 0] <= img_w - 1)
        & (surface_centers[:, 1] <= img_h - 1)
    )
    if inside.sum() == 0:
        return None
    target = surface_centers[int(np.argmax(inside))]
    # y = a x + b through the two points
    a, b = np.polyfit([proj_center[0], target[0]], [proj_center[1], target[1]], 1)
    candidates = []
    edges = []
    left_y = b
    if 0 <= left_y <= img_h - 1:
        candidates.append(np.array([0.0, left_y]))
        edges.append(0)
    right_y = (img_w - 1) * a + b
    if 0 <= right_y <= img_h - 1:
        candidates.append(np.array([img_w - 1.0, right_y]))
        edges.append(1)
    top_x = -b / a
    if 0 <= top_x <= img_w - 1:
        candidates.append(np.array([top_x, 0.0]))
        edges.append(2)
    bottom_x = (img_h - 1 - b) / a
    if 0 <= bottom_x <= img_w - 1:
        candidates.append(np.array([bottom_x, img_h - 1.0]))
        edges.append(3)
    candidates = np.stack(candidates)
    idx = int(np.argmin(np.linalg.norm(candidates - proj_center.reshape(1, 2), axis=1)))
    return candidates[idx], edges[idx]
