"""Detection visualization (PIL-based; the environment has no cv2).

A copy of the JAX package's ``dcd_tpu/utils/visualize.py`` (numpy and PIL
only): the same rows draw the same pixels. It covers the debug rendering the
reference provides in ``DGDE/engine/visualize_infer.py`` (image-plane 2D/3D
boxes, keypoints) and its BEV panel: 3D boxes are projected with the
calibration and drawn as wireframes; BEV renders rotated footprints on an
overhead grid.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data.kitti_geometry import Calibration, roty_matrix

BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),  # bottom face
    (4, 5), (5, 6), (6, 7), (7, 4),  # top face
    (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
]


def corners_from_det(row: np.ndarray) -> np.ndarray:
    """KITTI det row [cls, alpha, box2d(4), h, w, l, x, y, z, ry, score]
    -> (8, 3) camera-frame corners."""
    h, w, l = row[6], row[7], row[8]
    x, y, z = row[9], row[10], row[11]
    ry = row[12]
    xs = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    ys = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
    zs = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    pts = np.stack([xs, ys, zs], axis=0)
    return (roty_matrix(ry) @ pts).T + np.array([x, y, z])


def draw_detections(
    image: np.ndarray,
    dets: np.ndarray,  # (N, 14) postprocess rows
    valid: np.ndarray,
    calib: Calibration,
    kpts_2d: Optional[np.ndarray] = None,  # (N, n, 2) image pixels
    color=(0, 255, 80),
):
    """Returns a PIL Image with 2D boxes + 3D wireframes (+ keypoints)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.asarray(image, np.uint8))
    d = ImageDraw.Draw(img)
    for i, row in enumerate(np.asarray(dets)):
        if not valid[i]:
            continue
        x0, y0, x1, y1 = row[2:6]
        d.rectangle([x0, y0, x1, y1], outline=(255, 200, 0), width=1)
        corners = corners_from_det(row)
        uv, depth = calib.project_rect_to_image(corners)
        if (depth <= 0.1).any():
            continue
        for a, b in BOX_EDGES:
            d.line([tuple(uv[a]), tuple(uv[b])], fill=color, width=1)
        if kpts_2d is not None:
            for u, v in np.asarray(kpts_2d[i]):
                d.ellipse([u - 1, v - 1, u + 1, v + 1], fill=(255, 60, 60))
        d.text((x0, max(y0 - 10, 0)), f"{row[13]:.2f}", fill=(255, 255, 255))
    return img


def draw_bev(
    dets: np.ndarray,
    valid: np.ndarray,
    gt_dets: Optional[np.ndarray] = None,
    x_range: Tuple[float, float] = (-40, 40),
    z_range: Tuple[float, float] = (0, 80),
    scale: float = 8.0,
):
    """Overhead (bird's-eye) footprint rendering: predictions green, GT red."""
    from PIL import Image, ImageDraw

    W = int((x_range[1] - x_range[0]) * scale)
    H = int((z_range[1] - z_range[0]) * scale)
    img = Image.new("RGB", (W, H), (20, 20, 24))
    d = ImageDraw.Draw(img)

    def to_px(x, z):
        return ((x - x_range[0]) * scale, H - (z - z_range[0]) * scale)

    def footprint(row):
        w, l = row[7], row[8]
        x, z, ry = row[9], row[11], row[12]
        c, s = np.cos(ry), np.sin(ry)
        pts = []
        for dx, dz in [(l / 2, w / 2), (l / 2, -w / 2), (-l / 2, -w / 2), (-l / 2, w / 2)]:
            pts.append(to_px(x + c * dx + s * dz, z - s * dx + c * dz))
        return pts

    if gt_dets is not None:
        for row in np.asarray(gt_dets):
            d.polygon(footprint(row), outline=(230, 60, 60))
    for i, row in enumerate(np.asarray(dets)):
        if valid[i]:
            d.polygon(footprint(row), outline=(60, 230, 100))
    return img


def draw_heatmap(image: np.ndarray, heatmap: np.ndarray, alpha: float = 0.5):
    """Overlay a (H, W) heatmap (0..1) on the image (upscaled to match)."""
    from PIL import Image

    img = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    hm = np.asarray(heatmap, np.float32)
    hm = (np.clip(hm, 0, 1) * 255).astype(np.uint8)
    hm_img = Image.fromarray(hm).resize(img.size, Image.BILINEAR)
    red = Image.merge("RGB", (hm_img, Image.new("L", img.size, 0), Image.new("L", img.size, 0)))
    return Image.blend(img, red, alpha)


def gt_rows_from_objects(objs) -> np.ndarray:
    """Convert parsed KITTI ``Object3d`` labels into det-row layout
    ([cls, alpha, box2d(4), h, w, l, x, y, z, ry, score]) so GT can be
    drawn through the same paths as predictions."""
    rows = []
    for o in objs:
        if getattr(o, "type", "DontCare") == "DontCare":
            continue
        rows.append([
            0.0, o.alpha, *np.asarray(o.box2d, np.float64),
            o.h, o.w, o.l, *np.asarray(o.t, np.float64), o.ry, 1.0,
        ])
    return np.asarray(rows, np.float64).reshape(-1, 14)


def render_scene(
    image: np.ndarray,
    dets: np.ndarray,
    valid: np.ndarray,
    calib: Calibration,
    gt_rows: Optional[np.ndarray] = None,
    heatmap: Optional[np.ndarray] = None,
    kpts_2d: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Full debug panel (reference show_image_with_boxes,
    visualize_infer.py:190-321): the image with prediction wireframes
    (green) and GT wireframes (red), keypoints, plus the BEV footprint
    panel on the right and an optional class-heatmap overlay strip on
    top. Returns an RGB uint8 array sized to the composed panel."""
    from PIL import Image

    img = draw_detections(image, dets, valid, calib, kpts_2d=kpts_2d)
    if gt_rows is not None and len(gt_rows):
        img = draw_detections(
            np.asarray(img), gt_rows, np.ones(len(gt_rows), bool), calib,
            color=(230, 60, 60),
        )
    bev = draw_bev(dets, valid, gt_dets=gt_rows)
    H = img.size[1]
    bev = bev.resize((int(bev.size[0] * H / bev.size[1]), H))
    panel = Image.new("RGB", (img.size[0] + bev.size[0], H), (0, 0, 0))
    panel.paste(img, (0, 0))
    panel.paste(bev, (img.size[0], 0))
    if heatmap is not None:
        hm = draw_heatmap(image, heatmap)
        strip = Image.new("RGB", (panel.size[0], H + hm.size[1]), (0, 0, 0))
        strip.paste(hm, (0, 0))
        strip.paste(panel, (0, hm.size[1]))
        panel = strip
    return np.asarray(panel)


def save_scene_visualization(path: str, *args, **kwargs) -> None:
    """Render and write one scene panel as PNG (reference plt.imsave,
    visualize_infer.py:312)."""
    from PIL import Image

    Image.fromarray(render_scene(*args, **kwargs)).save(path)
