"""Head outputs -> KITTI rows, and the whole inference call: a frozen copy
for the benchmark's reference (DGDE reference ``PostProcessor``,
``model/head/detector_infer.py:27-243``): max-pool NMS + top-K + score
threshold, 2D boxes, class-mean dimensions, multi-bin orientation, the soft
depth ensemble, the final depth by ``output_depth`` ('edges': the mean of
the edge-pair depths), uncertainty as confidence, and rows
``[cls, alpha, box2d(4), dims hwl(3), locs(3), roty, score]`` with a
validity mask, K rows per image.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import codec
from .codec import nms_hm, select_point_of_interest, select_topk
from .predictor import Converter_key2channel


def postprocess(cfg, predictions: Dict[str, torch.Tensor], calib_P: torch.Tensor,
                pad_size: torch.Tensor, img_size: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Head outputs -> (B, K, 14) KITTI rows + validity (and the depth
    error that the confidence is taken from).

    calib_P: (B, 3, 4); pad_size: (B, 2); img_size: (B, 2) original (w, h).
    Takes either the lazy path's outputs (``reg_pois``) or the dense map
    (``reg``).
    """
    head = cfg.model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    down = cfg.model.backbone.down_ratio
    K = cfg.test.detections_per_img

    if "reg_pois" in predictions:
        B = predictions["cls"].shape[0]
        scores, clses = predictions["scores"], predictions["clses"]
        points = predictions["points_xy"]
        pois = predictions["reg_pois"].float()
    else:
        hm = nms_hm(predictions["cls"])
        B = hm.shape[0]
        scores, indexs, clses, ys, xs = select_topk(hm, K=K)
        points = torch.stack([xs, ys], dim=-1)
        pois = select_point_of_interest(indexs, predictions["reg"]).float()

    N = B * K
    pois = pois.reshape(N, -1)
    points = points.reshape(N, 2)
    scores = scores.reshape(N)
    clses = clses.reshape(N)
    valid = scores >= cfg.test.detections_threshold

    def per_det(x):
        return torch.repeat_interleave(x.float(), K, dim=0)

    P_det, pad_det, size_det = per_det(calib_P), per_det(pad_size), per_det(img_size)

    reg2d = torch.relu(pois[:, k2c("2d_dim")])
    offset3d = pois[:, k2c("3d_offset")]
    dims_off = pois[:, k2c("3d_dim")]
    orient = torch.cat([pois[:, k2c("ori_cls")], pois[:, k2c("ori_offset")]], dim=1)

    # 2D box in original-image pixels (anno_encoder.py:74-91)
    box2d = torch.cat([points - reg2d[:, :2], points + reg2d[:, 2:]], dim=1)
    box2d = box2d * down - pad_det.repeat(1, 2)
    wmax = size_det[:, 0] - 1
    hmax = size_det[:, 1] - 1
    zero = torch.zeros_like(wmax)
    box2d = torch.stack([
        torch.minimum(torch.maximum(box2d[:, 0], zero), wmax),
        torch.minimum(torch.maximum(box2d[:, 1], zero), hmax),
        torch.minimum(torch.maximum(box2d[:, 2], zero), wmax),
        torch.minimum(torch.maximum(box2d[:, 3], zero), hmax),
    ], dim=1)

    dev = pois.device
    dims = codec.decode_dimension(
        clses, dims_off, torch.tensor(head.dimension_mean, device=dev),
        torch.tensor(head.dimension_std, device=dev), head.dimension_reg)  # (N, 3) l/h/w

    direct_depth = codec.decode_depth(pois[:, k2c("depth")].squeeze(-1), head.depth_mode,
                                      head.depth_reference, head.depth_range)
    direct_unc = torch.exp(pois[:, k2c("depth_uncertainty")])
    kpt_offset = pois[:, k2c("corner_offset")].reshape(N, 10, 2)
    kpt_depths = codec.decode_depth_from_keypoints(kpt_offset, dims, P_det, down,
                                                   depth_range=head.depth_range)
    kpt_unc = torch.exp(pois[:, k2c("corner_uncertainty")])

    combined_depths = torch.cat([direct_depth[:, None], kpt_depths], dim=1)  # (N, 4)
    combined_unc = torch.cat([direct_unc, kpt_unc], dim=1)
    depth_weights = 1.0 / combined_unc
    depth_weights = depth_weights / depth_weights.sum(dim=1, keepdim=True)
    soft_depth = (combined_depths * depth_weights).sum(dim=1)
    estimated_depth_error = (depth_weights * combined_unc).sum(dim=1)

    coarse_loc = codec.decode_location(points, offset3d, soft_depth, P_det, pad_det, down)
    rotys, alphas = codec.decode_axes_orientation(orient, coarse_loc, cfg.input.orientation_bin_size)

    ek2 = pois[:, k2c("extra_kpts_2d")].reshape(N, -1, 2)
    ek3 = pois[:, k2c("extra_kpts_3d")].reshape(N, -1, 3)
    ek2_img = codec.decode_kpts_2d_img(ek2, points, offset3d, pad_det, down)
    mode = head.output_depth
    if mode == "edges":
        final_depth = codec.decode_pairs_kpts_depth(
            ek2_img, ek3, rotys, P_det, clamp=head.pairs_depth_clamp).mean(dim=1)
    elif mode == "soft":
        final_depth = soft_depth
    elif mode == "hard":
        final_depth = torch.gather(combined_depths, 1,
                                   torch.argmin(combined_unc, dim=1)[:, None]).squeeze(1)
    elif mode == "direct":
        final_depth = direct_depth
    else:
        raise ValueError(f"unknown OUTPUT_DEPTH mode {mode!r}")

    locations = codec.decode_location(points, offset3d, final_depth, P_det, pad_det, down)
    locations = torch.cat([locations[:, :1], locations[:, 1:2] + dims[:, 1:2] / 2.0,
                           locations[:, 2:]], dim=1)  # 3D centre -> bottom centre
    dims_hwl = torch.roll(dims, shifts=-1, dims=1)  # l,h,w -> h,w,l

    if cfg.test.uncertainty_as_confidence:
        conf = 1.0 - torch.clamp(estimated_depth_error, 0.01, 1.0)
        scores = scores * conf
        scores = torch.where(torch.isnan(scores), torch.zeros_like(scores), scores)

    result = torch.cat([clses[:, None], alphas[:, None], box2d, dims_hwl, locations,
                        rotys[:, None], scores[:, None]], dim=1)
    return {
        "dets": result.reshape(B, K, 14),
        "valid": (valid & (scores > 0)).reshape(B, K),
        "kpts_2d": ek2_img.reshape(B, K, -1, 2),
        "kpts_3d": ek3.reshape(B, K, -1, 3),
        "depth_error": estimated_depth_error.reshape(B, K),
    }


@torch.no_grad()
def infer(model: torch.nn.Module, images: torch.Tensor, edge_indices: torch.Tensor,
          edge_len: torch.Tensor, calib_P: torch.Tensor, pad_size: torch.Tensor,
          img_size: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Images (B, H, W, 3) -> KITTI rows, on the model's device; the heads
    take the lazy top-K path when ``cfg.test.lazy_reg_heads`` is set."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    preds = model(images.to(dev), edge_indices.to(dev), edge_len.to(dev),
                  lazy_topk=cfg.test.lazy_reg_heads)
    return postprocess(cfg, preds, calib_P.to(dev), pad_size.to(dev), img_size.to(dev))
