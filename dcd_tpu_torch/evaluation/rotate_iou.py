"""Rotated-rectangle IoU — vectorized, bit-faithful to the reference kernel.

A copy of the JAX package's ``dcd_tpu/evaluation/rotate_iou.py`` (numpy, no
JAX), with its float operations in the same order, so that both give the
same bits.

The reference computes BEV/3D AP through numba.cuda rotated-IoU kernels
(``GMW/evaluation/kitti_object_eval_python/rotate_iou.py:18-332``). This
module re-implements *that exact algorithm* as batched float32 NumPy so the
BEV (metric 1) and 3D (metric 2) AP paths bit-match the official protocol:

* ``rbbox_to_corners`` (:206-231): clockwise corners, same op order.
* ``point_in_quadrilateral`` (:162-179): strict projection tests, no eps.
* ``line_segment_intersection`` (:78-118, the *first* variant — the one
  ``quadrilateral_intersection`` :183-203 actually calls): sign tests via
  cross products, intersection point from the homogeneous-line formula
  Dx/DH, Dy/DH.
* candidate order (:183-203): for each i in 0..3, corner_i of box1 (if
  inside box2) then corner_i of box2 (if inside box1); then the 16 edge
  pairs in (i-major, j-minor) order.
* ``sort_vertex_in_convex_polygon`` (:35-72): pseudo-angle key
  (v0/d, reflected to -2-v0/d when v1<0) around the mean of the valid
  candidates, insertion sort (== stable ascending sort).
* ``area`` (:25-31): fan of |triangle| areas from the first sorted vertex,
  accumulated sequentially.

All arithmetic is float32 in the same operation order as the CUDA device
functions (sequential accumulation loops — NumPy's pairwise ``sum`` would
round differently), so results are bitwise equal to a plain-Python
transcription of the kernel (``tests/ref_rotate_iou_oracle.py``), which is
how ``tests/test_eval_vs_reference.py`` bit-checks metrics 1/2 end-to-end.

Known deviations (both unreachable for real boxes, both documented here):
* a candidate point exactly equal to the fp32 centroid yields a NaN sort
  key; the CUDA insertion sort treats NaN as an ordering barrier while
  stable argsort places NaN last.
* trig: the oracle and this module both use np.cos/np.sin on float32;
  numba-CUDA's cosf may differ by 1 ulp.

No CUDA/numba dependency; the whole (N, K) pair grid is evaluated with
array ops (fast enough for the KITTI protocol, ~50 dets/image).
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def rbbox_to_corners(rbboxes: np.ndarray) -> np.ndarray:
    """(..., 5) [cx, cy, w, l, angle] -> (..., 4, 2) clockwise corners.

    Mirrors ``rbbox_to_corners`` (reference rotate_iou.py:206-231) op
    order: (a_cos * cx_i + a_sin * cy_i) + center_x.
    """
    angle = rbboxes[..., 4]
    a_cos = np.cos(angle)
    a_sin = np.sin(angle)
    cx = rbboxes[..., 0]
    cy = rbboxes[..., 1]
    xd = rbboxes[..., 2]
    yd = rbboxes[..., 3]
    half = np.asarray(2.0, rbboxes.dtype)
    ox = np.stack([-xd / half, -xd / half, xd / half, xd / half], axis=-1)
    oy = np.stack([-yd / half, yd / half, yd / half, -yd / half], axis=-1)
    px = (a_cos[..., None] * ox + a_sin[..., None] * oy) + cx[..., None]
    py = (-a_sin[..., None] * ox + a_cos[..., None] * oy) + cy[..., None]
    return np.stack([px, py], axis=-1)


def _triangle_area(ax, ay, bx, by, cx, cy):
    # trangle_area (reference :18-21), including the /2.0
    return ((ax - cx) * (by - cy) - (ay - cy) * (bx - cx)) / _F32(2.0)


def _points_in_quad(pts: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """pts (..., P, 2) inside quad (..., 4, 2) -> (..., P) bool.

    ``point_in_quadrilateral`` (reference :162-179): strict projection
    tests along the quad's AB / AD edges, *no* epsilon.
    """
    A = corners[..., 0, :][..., None, :]
    ab = corners[..., 1, :][..., None, :] - A
    ad = corners[..., 3, :][..., None, :] - A
    ap = pts - A
    abab = ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1]
    abap = ab[..., 0] * ap[..., 0] + ab[..., 1] * ap[..., 1]
    adad = ad[..., 0] * ad[..., 0] + ad[..., 1] * ad[..., 1]
    adap = ad[..., 0] * ap[..., 0] + ad[..., 1] * ap[..., 1]
    return (abab >= abap) & (abap >= 0) & (adad >= adap) & (adap >= 0)


def _segment_intersections(c1: np.ndarray, c2: np.ndarray):
    """All 16 edge-pair intersections between quads c1, c2 (..., 4, 2).

    Returns (points (..., 16, 2), valid (..., 16)) in the reference's
    (i-major, j-minor) edge order, computed with the *first*
    ``line_segment_intersection`` (reference :78-118): cross-product sign
    tests and the homogeneous-line intersection Dx/DH, Dy/DH.
    """
    a = c1[..., :, None, :]  # (..., 4, 1, 2) edge starts of quad 1
    b = np.roll(c1, -1, axis=-2)[..., :, None, :]
    c = c2[..., None, :, :]
    d = np.roll(c2, -1, axis=-2)[..., None, :, :]

    A0, A1 = a[..., 0], a[..., 1]
    B0, B1 = b[..., 0], b[..., 1]
    C0, C1 = c[..., 0], c[..., 1]
    D0, D1 = d[..., 0], d[..., 1]

    BA0 = B0 - A0
    BA1 = B1 - A1
    DA0 = D0 - A0
    CA0 = C0 - A0
    DA1 = D1 - A1
    CA1 = C1 - A1
    acd = DA1 * CA0 > CA1 * DA0
    bcd = (D1 - B1) * (C0 - B0) > (C1 - B1) * (D0 - B0)
    abc = CA1 * BA0 > BA1 * CA0
    abd = DA1 * BA0 > BA1 * DA0
    valid = (acd != bcd) & (abc != abd)

    DC0 = D0 - C0
    DC1 = D1 - C1
    ABBA = A0 * B1 - B0 * A1
    CDDC = C0 * D1 - D0 * C1
    DH = BA1 * DC0 - BA0 * DC1
    Dx = ABBA * DC0 - BA0 * CDDC
    Dy = ABBA * DC1 - BA1 * CDDC
    with np.errstate(divide="ignore", invalid="ignore"):
        px = Dx / DH
        py = Dy / DH
    pts = np.stack([px, py], axis=-1)
    shape = pts.shape[:-3] + (16, 2)
    return pts.reshape(shape), valid.reshape(valid.shape[:-2] + (16,))


def _intersection_area(pts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Area of the convex polygon formed by the valid candidate points.

    pts: (..., M, 2); valid: (..., M), candidates already in the
    reference's collection order. Center mean and the fan-area sum are
    accumulated *sequentially over slots* (x + 0.0 is exact) to match the
    CUDA kernel's loop-order float32 rounding; sort is stable ascending on
    the pseudo-angle key, which equals the reference's insertion sort.
    """
    M = pts.shape[-2]
    nf = valid.sum(-1).astype(_F32)  # (...,)
    zero = np.zeros((), _F32)

    cx = np.zeros(valid.shape[:-1], _F32)
    cy = np.zeros(valid.shape[:-1], _F32)
    for m in range(M):  # sequential fp32 accumulation, reference :39-41
        cx = cx + np.where(valid[..., m], pts[..., m, 0], zero)
        cy = cy + np.where(valid[..., m], pts[..., m, 1], zero)
    with np.errstate(divide="ignore", invalid="ignore"):
        cx = cx / nf
        cy = cy / nf

    vx = pts[..., 0] - cx[..., None]
    vy = pts[..., 1] - cy[..., None]
    d = np.sqrt(vx * vx + vy * vy)
    with np.errstate(divide="ignore", invalid="ignore"):
        ux = vx / d
        uy = vy / d
    key = np.where(uy < 0, _F32(-2.0) - ux, ux)
    key = np.where(valid, key, np.inf)  # invalid slots sort last
    order = np.argsort(key, axis=-1, kind="stable")
    sx = np.take_along_axis(pts[..., 0], order, axis=-1)
    sy = np.take_along_axis(pts[..., 1], order, axis=-1)

    n = valid.sum(-1)
    area = np.zeros(valid.shape[:-1], _F32)
    with np.errstate(invalid="ignore"):  # slots past n hold inf/nan, masked
        for i in range(M - 2):  # sequential |fan triangle| sum, reference :25-31
            tri = np.abs(
                _triangle_area(sx[..., 0], sy[..., 0], sx[..., i + 1], sy[..., i + 1], sx[..., i + 2], sy[..., i + 2])
            )
            area = area + np.where(i < n - 2, tri, zero)
    return area


def rotate_iou_eval(boxes: np.ndarray, query_boxes: np.ndarray, criterion: int = -1) -> np.ndarray:
    """(N, 5) x (K, 5) -> (N, K) rotated IoU / normalized intersection.

    criterion: -1 IoU, 0 inter/area1, 1 inter/area2, else raw intersection
    — the ``devRotateIoUEval`` switch (reference :251-263). float32
    arithmetic bit-matching the CUDA kernel; a zero union yields NaN/Inf
    exactly as the hardware division would.

    NOTE the reference launcher swaps operands per thread
    (``devRotateIoUEval(block_qboxes[i], block_boxes[tx])``), so box1 of
    the device function is the *query* box; with criterion=-1/2 the result
    is symmetric in all the sign tests' strict inequalities only up to
    candidate ordering — we replicate the reference's operand order.
    """
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    query_boxes = np.ascontiguousarray(query_boxes, dtype=np.float32)
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=np.float32)

    # operand order per the kernel launch (rbox1 = query box, rbox2 = box;
    # reference rotate_iou_kernel_eval :289-291)
    b1 = np.broadcast_to(query_boxes[None, :, :], (N, K, 5))
    b2 = np.broadcast_to(boxes[:, None, :], (N, K, 5))
    c1 = rbbox_to_corners(b1)  # (N, K, 4, 2)
    c2 = rbbox_to_corners(b2)

    in2 = _points_in_quad(c1, c2)  # corners of quad1 inside quad2: (N, K, 4)
    in1 = _points_in_quad(c2, c1)
    seg_pts, seg_valid = _segment_intersections(c1, c2)  # (N, K, 16, 2)

    # candidate collection order (reference :183-203): for each corner
    # index i: quad1 corner, then quad2 corner; then the 16 edge pairs.
    corner_pts = np.empty(c1.shape[:-2] + (8, 2), np.float32)
    corner_valid = np.empty(in2.shape[:-1] + (8,), bool)
    corner_pts[..., 0::2, :] = c1
    corner_pts[..., 1::2, :] = c2
    corner_valid[..., 0::2] = in2
    corner_valid[..., 1::2] = in1
    cand_pts = np.concatenate([corner_pts, seg_pts], axis=-2)  # (N, K, 24, 2)
    cand_valid = np.concatenate([corner_valid, seg_valid], axis=-1)

    inter_area = _intersection_area(cand_pts, cand_valid)

    area1 = b1[..., 2] * b1[..., 3]
    area2 = b2[..., 2] * b2[..., 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        if criterion == -1:
            out = inter_area / (area1 + area2 - inter_area)
        elif criterion == 0:
            out = inter_area / area1
        elif criterion == 1:
            out = inter_area / area2
        else:
            out = inter_area
    return out.astype(np.float32)
