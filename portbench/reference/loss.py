"""DGDE training loss, static-shape and mask-weighted: a frozen copy for
the benchmark's reference (DGDE reference ``Loss_Computation``,
``model/head/detector_loss.py:23-642``). Every object slot (B x
max_objects) is computed and padded slots carry zero weight; object losses
divide by ``B * batch_weight_factor``, extra-keypoint and pair-depth losses
by their mask sums times ``instance_num / batch_weight``; invalid keypoint
and pair depths train their uncertainty only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import codec
from . import losses as L
from .codec import select_point_of_interest
from .predictor import Converter_key2channel

# calibration of padded object slots (fx = fy = 1, centred): their Calib_P
# rows are zero and would divide by zero inside the decoders
_SAFE_P = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0))


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum()


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.clamp(den, min=1.0)


def compute_losses(cfg, predictions: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(total loss, loss terms, log terms) of the dense head outputs
    ``predictions`` ({"cls": (B, Ho, Wo, C), "reg": (B, Ho, Wo, R)}) against
    the collated targets, tensors on the predictions' device."""
    head = cfg.model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    w = dict(zip(head.loss_names, head.init_loss_weight))
    down = cfg.model.backbone.down_ratio

    pred_hm = predictions["cls"]
    pred_reg = predictions["reg"]
    dev = pred_hm.device
    B = pred_hm.shape[0]
    M = cfg.datasets.max_objects
    K = B * M

    # ---------------- heatmap ----------------
    hm_target = targets["hm"].permute(0, 2, 3, 1)  # stored CHW
    hm_loss_raw, _ = L.penalty_reduced_focal_loss(pred_hm, hm_target, head.loss_penalty_alpha,
                                                  head.loss_beta)

    # ---------------- object slots ----------------
    def flat(name):
        x = targets[name]
        return x.reshape((K,) + tuple(x.shape[2:]))

    m3d = flat("reg_mask").float()
    centers = flat("target_centers").float()
    boxes2d = flat("bboxes_2d")
    cls_ids = flat("cls_ids")
    gt_depths = flat("locations")[:, 2]
    gt_rotys = flat("rotys")
    gt_offset3d = flat("offset_3D")
    gt_dims = flat("dimensions")
    gt_orient = flat("orientations")
    trunc = flat("trunc_mask").float()
    trunc_mask = trunc * m3d
    ori_mask = flat("ori_mask").float() * m3d
    find_pcl = flat("find_pcl").float()
    calib_P = flat("Calib_P")
    safe_P = torch.where(m3d[:, None, None] > 0, calib_P, torch.tensor(_SAFE_P, device=dev))
    pad_size = torch.repeat_interleave(targets["pad_size"], M, dim=0)
    kpts = flat("keypoints")
    kpts_depth_mask = flat("keypoints_depth_mask") * m3d[:, None]
    ek2 = flat("extra_kpts_2d")
    ek3 = flat("extra_kpts_3d")

    heights = boxes2d[:, 3] - boxes2d[:, 1]
    widths = boxes2d[:, 2] - boxes2d[:, 0]
    m2d = m3d * (heights > 0) * (widths > 0)

    # ---------------- predictions at the object centres ----------------
    pois = select_point_of_interest(targets["target_centers"], pred_reg).reshape(K, -1)

    pred_reg2d = torch.relu(pois[:, k2c("2d_dim")])
    pred_offset3d = pois[:, k2c("3d_offset")]
    pred_dims_off = pois[:, k2c("3d_dim")]
    pred_orient = torch.cat([pois[:, k2c("ori_cls")], pois[:, k2c("ori_offset")]], dim=1)
    pred_dims = codec.decode_dimension(
        cls_ids, pred_dims_off, torch.tensor(head.dimension_mean, device=dev),
        torch.tensor(head.dimension_std, device=dev), head.dimension_reg)

    pred_direct_depth = codec.decode_depth(pois[:, k2c("depth")].squeeze(-1), head.depth_mode,
                                           head.depth_reference, head.depth_range)
    lo, hi = head.uncertainty_range
    depth_unc = torch.clamp(pois[:, k2c("depth_uncertainty")].squeeze(-1), lo, hi)
    corner_unc = torch.clamp(pois[:, k2c("corner_uncertainty")], lo, hi)

    pred_kpts = pois[:, k2c("corner_offset")].reshape(K, 10, 2)
    pred_kpt_depths = codec.decode_depth_from_keypoints(pred_kpts, pred_dims, safe_P, down,
                                                        depth_range=head.depth_range)

    pred_ek2 = pois[:, k2c("extra_kpts_2d")].reshape(K, -1, 2)
    pred_ek3 = pois[:, k2c("extra_kpts_3d")].reshape(K, -1, 3)

    # image-space keypoints for the pair solve (detector_loss.py:365-371)
    pred_ek2_img = codec.decode_kpts_2d_img(pred_ek2, centers, gt_offset3d, pad_size, down)
    ek2_mask = ek2[..., 2] * find_pcl[:, None] * m3d[:, None]
    pairs_all, pairs_mask = codec.decode_pairs_kpts_depth(
        pred_ek2_img, pred_ek3, gt_rotys, safe_P, training=True, kpts_2d_mask=ek2_mask,
        pairs_topk=head.pairs_topk, clamp=head.pairs_depth_clamp)
    ek3_mask = find_pcl[:, None] * m3d[:, None] * torch.ones_like(ek3[..., 0])
    pm_valid = pairs_mask * find_pcl[:, None] * m3d[:, None]
    pm_invalid = (1.0 - pairs_mask) * find_pcl[:, None] * m3d[:, None]

    batch_weight = B * cfg.model.batch_weight_factor
    n2d, n3d, n_ek2, n_ek3 = m2d.sum(), m3d.sum(), ek2_mask.sum(), ek3_mask.sum()
    n_pv, n_pi = pm_valid.sum(), pm_invalid.sum()
    hm_loss = w["hm_loss"] * hm_loss_raw / batch_weight

    # ---------------- boxes ----------------
    gt_locations = codec.decode_location(centers, gt_offset3d, gt_depths, safe_P, pad_size, down)
    gt_corners = codec.encode_box3d(gt_rotys, gt_dims, gt_locations)
    # predicted box from the mean edge depth (corner_loss_depth 'edges', :387-398)
    pred_corner_depth = pairs_all.mean(dim=1)
    pred_locations = codec.decode_location(centers, pred_offset3d, pred_corner_depth, safe_P,
                                           pad_size, down)
    pred_rotys, _ = codec.decode_axes_orientation(pred_orient, pred_locations,
                                                  cfg.input.orientation_bin_size)
    pred_corners = codec.encode_box3d(pred_rotys, pred_dims, pred_locations)

    loss_dict: Dict[str, torch.Tensor] = {"hm_loss": hm_loss}
    log_dict: Dict[str, torch.Tensor] = {}

    # ---------------- 2D box ----------------
    tgt_reg2d = torch.cat([centers - boxes2d[:, :2], boxes2d[:, 2:] - centers], dim=1)
    reg2d_losses, ious2d = L.iou_loss(pred_reg2d, tgt_reg2d, head.loss_type[2])
    loss_dict["bbox_loss"] = w["bbox_loss"] * _masked_sum(reg2d_losses, m2d) / batch_weight
    log_dict["2D_IoU"] = _ratio(_masked_sum(ious2d, m2d), n2d)

    # ---------------- direct depth ----------------
    depth_loss = w["depth_loss"] * torch.abs(pred_direct_depth - gt_depths)
    log_dict["depth_loss"] = _masked_sum(depth_loss, m3d) / batch_weight
    depth_loss = depth_loss * torch.exp(-depth_unc) + depth_unc * w["depth_loss"]
    loss_dict["depth_loss"] = _masked_sum(depth_loss, m3d) / batch_weight

    # ---------------- 3D centre offsets, truncated and not ----------------
    offset_l1 = torch.abs(pred_offset3d - gt_offset3d).sum(dim=1)
    trunc_off = torch.log1p(offset_l1) if head.truncation_offset_loss == "log" else offset_l1
    loss_dict["trunc_offset_loss"] = (
        w["trunc_offset_loss"] * _masked_sum(trunc_off, trunc_mask) / batch_weight)
    nontrunc = m3d * (1.0 - trunc)
    loss_dict["offset_loss"] = w["offset_loss"] * _masked_sum(offset_l1, nontrunc) / batch_weight

    # ---------------- orientation, dimensions, corners ----------------
    loss_dict["orien_loss"] = w["orien_loss"] * L.multibin_orientation_loss(
        pred_orient, gt_orient, ori_mask, cfg.input.orientation_bin_size) / batch_weight
    dims_l1 = torch.abs(pred_dims - gt_dims) * torch.tensor(head.dimension_weight, device=dev)
    loss_dict["dims_loss"] = w["dims_loss"] * _masked_sum(dims_l1.sum(1), m3d) / batch_weight
    corner_l1 = torch.abs(pred_corners - gt_corners).sum(dim=(1, 2))
    loss_dict["corner_loss"] = w["corner_loss"] * _masked_sum(corner_l1, m3d) / batch_weight

    # ---------------- 10 keypoints ----------------
    kpt_l1 = torch.abs(pred_kpts - kpts[..., :2]).sum(dim=2) * kpts[..., 2] * m3d[:, None]
    loss_dict["keypoint_loss"] = w["keypoint_loss"] * kpt_l1.sum() / batch_weight

    # keypoint depths: valid ones train depth and uncertainty, invalid ones
    # the uncertainty only (detached depth, detector_loss.py:511)
    tgt_kd = gt_depths[:, None]
    wkd = w["keypoint_depth_loss"]
    kd_valid = kpts_depth_mask
    kd_invalid = (1.0 - kpts_depth_mask) * m3d[:, None]
    kd_l1_valid = torch.abs(pred_kpt_depths - tgt_kd) * wkd
    kd_l1_invalid = torch.abs(pred_kpt_depths.detach() - tgt_kd) * wkd
    log_dict["keypoint_depth_loss"] = _masked_sum(kd_l1_valid, kd_valid) / batch_weight
    kd_valid_term = kd_l1_valid * torch.exp(-corner_unc) + wkd * corner_unc
    kd_invalid_term = kd_l1_invalid * torch.exp(-corner_unc)
    keypoint_depth_loss = _masked_sum(kd_valid_term, kd_valid)
    if head.modify_invalid_keypoint_depth:
        keypoint_depth_loss = keypoint_depth_loss + _masked_sum(kd_invalid_term, kd_invalid)
    loss_dict["keypoint_depth_loss"] = keypoint_depth_loss / batch_weight

    # ---------------- extra keypoints ----------------
    scale = n3d / batch_weight  # instance_num / batch_weight
    ek2_l1 = L.reg_weighted_l1_loss(pred_ek2, ek2[..., :2], gt_depths)
    ek2_sum = _masked_sum(w["extra_kpts_2d_loss"] * ek2_l1, ek2_mask)
    loss_dict["extra_kpts_2d_loss"] = _ratio(ek2_sum, n_ek2) * scale
    ek3_l1 = torch.abs(pred_ek3 - ek3).sum(dim=2)
    ek3_sum = _masked_sum(w["extra_kpts_3d_loss"] * ek3_l1, ek3_mask)
    loss_dict["extra_kpts_3d_loss"] = _ratio(ek3_sum, n_ek3) * scale

    # ---------------- pair depths ----------------
    wpd = w["pairs_kpts_depth_loss"]
    pd_l1_valid = torch.abs(pairs_all - tgt_kd) * wpd
    pd_l1_invalid = torch.abs(pairs_all.detach() - tgt_kd) * wpd
    valid_term = _ratio(_masked_sum(pd_l1_valid, pm_valid), n_pv)
    invalid_term = _ratio(_masked_sum(pd_l1_invalid, pm_invalid), n_pi)
    if head.modify_invalid_keypoint_depth:
        loss_dict["pairs_kpts_depth_loss"] = (valid_term + invalid_term) * scale
    else:
        loss_dict["pairs_kpts_depth_loss"] = valid_term * scale
    log_dict["pairs_kpts_depth_loss"] = valid_term * scale

    # ---------------- MAE observables (detector_loss.py:546-580) ----------------
    safe_gt = torch.clamp(gt_depths, min=1e-3)
    log_dict["depth_MAE"] = _ratio(_masked_sum(torch.abs(pred_direct_depth - gt_depths) / safe_gt,
                                               m3d), n3d)
    kpt_mae = torch.abs(pred_kpt_depths - tgt_kd) / safe_gt[:, None]
    for j, name in enumerate(["center_MAE", "keypoint_02_MAE", "keypoint_13_MAE"]):
        log_dict[name] = _ratio(_masked_sum(kpt_mae[:, j], m3d), n3d)
    pairs_mae = torch.abs(pairs_all - tgt_kd) / safe_gt[:, None]
    log_dict["extra_all_MAE"] = _ratio(_masked_sum(pairs_mae, pm_valid), n_pv)
    edge_mae = torch.abs(pred_corner_depth - gt_depths) / safe_gt
    log_dict["edges_MAE"] = _ratio(_masked_sum(edge_mae, m3d), n3d)

    total = sum(loss_dict.values())
    for k, v in loss_dict.items():
        log_dict.setdefault(k, v)
    return total, loss_dict, log_dict
