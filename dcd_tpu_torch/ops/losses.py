"""Loss functions of the DGDE detector, mask-based.

The counterpart of ``dcd_tpu/ops/losses.py`` (reference: penalty-reduced
focal ``DGDE/model/layers/focal_loss.py:29-86``, IoU/GIoU
``layers/iou_loss.py:7-49``, depth losses ``head/depth_losses.py:50-104``,
multi-bin orientation ``head/detector_loss.py:644-666`` vectorised over
bins). Padded object slots carry zero weight instead of being indexed away.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def penalty_reduced_focal_loss(prediction: torch.Tensor, target: torch.Tensor,
                               alpha: float = 2.0, beta: float = 4.0,
                               eps: float = 1e-10) -> Tuple[torch.Tensor, torch.Tensor]:
    """CenterNet focal loss on a gaussian-splatted heatmap: target == 1 are
    positives, 0 <= target < 1 negatives weighted by (1 - t)^beta, -1 is
    ignored. Returns (summed loss, number of positives).

    The clamp runs in fp32 with a representable upper bound,
    ``1 - max(eps, 1e-7)``: the reference's ``1 - 1e-10`` rounds to 1.0 in
    fp32 and ``log(1 - p)`` then gives -inf at a saturated sigmoid.
    """
    prediction = torch.clamp(prediction.float(), eps, 1.0 - max(eps, 1e-7))
    target = target.float()
    positive = (target == 1.0).float()
    negative = ((target < 1.0) & (target >= 0.0)).float()
    negative_weights = torch.pow(1.0 - torch.clamp(target, 0.0, 1.0), beta)
    positive_loss = torch.log(prediction) * torch.pow(1.0 - prediction, alpha) * positive
    negative_loss = (torch.log(1.0 - prediction) * torch.pow(prediction, alpha)
                     * negative_weights * negative)
    return -(positive_loss + negative_loss).sum(), positive.sum()


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_type: str = "giou") -> Tuple[torch.Tensor, torch.Tensor]:
    """IoU family on (K, 4) l/t/r/b distances; returns (losses, ious)."""
    pl, pt, pr, pb = pred.unbind(1)
    tl, tt, tr, tb = target.unbind(1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_intersect = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    g_w_intersect = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    h_intersect = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_h_intersect = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w_intersect * g_h_intersect + 1e-7
    area_intersect = w_intersect * h_intersect
    area_union = target_area + pred_area - area_intersect
    ious = (area_intersect + 1.0) / (area_union + 1.0)
    gious = ious - (ac_union - area_union) / ac_union
    if loss_type == "iou":
        losses = -torch.log(ious)
    elif loss_type == "linear_iou":
        losses = 1.0 - ious
    elif loss_type == "giou":
        losses = 1.0 - gious
    else:
        raise NotImplementedError(loss_type)
    return losses, ious


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def log_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 in log-depth space (reference depth_losses.py:82-92)."""
    return torch.abs(torch.log(pred) - torch.log(target))


def berhu_loss(pred: torch.Tensor, target: torch.Tensor, c_factor: float = 0.2) -> torch.Tensor:
    """Reverse Huber (reference depth_losses.py:31-48), elementwise."""
    differ = torch.abs(pred - target)
    c = torch.clamp(differ.max() * c_factor, min=1e-4)
    return torch.where(differ <= c, differ, (differ ** 2 / c + c) / 2.0)


def depth_reweight(dep: torch.Tensor) -> torch.Tensor:
    """Depth weight of the extra-keypoint 2D loss (reference
    depth_losses.py:61-64): near objects linear, far ones ~log10(d - 4)."""
    return torch.where(dep < 5.0, dep * 0.01, torch.log10(torch.clamp(dep, min=5.0) - 4.0) + 0.1)


def reg_weighted_l1_loss(pred: torch.Tensor, target: torch.Tensor, dep: torch.Tensor) -> torch.Tensor:
    """Per-keypoint L1 over xy, reweighted by object depth: (K, n, 2),
    (K, n, 2), (K,) -> (K, n) (reference depth_losses.py:50-67)."""
    return torch.abs(pred - target).sum(-1) * depth_reweight(dep)[:, None]


def multibin_orientation_loss(vector_ori: torch.Tensor, gt_ori: torch.Tensor,
                              weight: Optional[torch.Tensor] = None,
                              num_bin: int = 4) -> torch.Tensor:
    """Multi-bin orientation loss, masked per object: vector_ori (K, 4 nb)
    = per-bin 2-way logits then per-bin sin/cos; gt_ori (K, 2 nb) = per-bin
    membership then offsets. Returns cls_losses / nb + reg_losses."""
    K = vector_ori.shape[0]
    if weight is None:
        weight = torch.ones(K, dtype=vector_ori.dtype, device=vector_ori.device)
    logits = vector_ori[:, : num_bin * 2].reshape(K, num_bin, 2)
    gt_cls = gt_ori[:, :num_bin]
    gt_offset = gt_ori[:, num_bin: num_bin * 2]
    logp = torch.log_softmax(logits, dim=-1)
    ce = -(gt_cls * logp[..., 1] + (1.0 - gt_cls) * logp[..., 0])
    cls_losses = (ce * weight[:, None]).sum()
    offs = vector_ori[:, num_bin * 2:].reshape(K, num_bin, 2)
    offs = offs / torch.clamp(torch.linalg.norm(offs, dim=-1, keepdim=True), min=1e-12)
    valid = (gt_cls == 1.0).to(vector_ori.dtype) * weight[:, None]
    reg = (torch.abs(offs[..., 0] - torch.sin(gt_offset))
           + torch.abs(offs[..., 1] - torch.cos(gt_offset)))
    return cls_losses / num_bin + (reg * valid).sum()


def wing_loss(prediction: torch.Tensor, target: torch.Tensor, w: float = 10.0,
              eps: float = 2.0) -> torch.Tensor:
    """Wing loss (reference model/utils.py:51-66)."""
    C = w - w * math.log(1.0 + w / eps)
    differ = torch.abs(prediction - target)
    return torch.where(differ < w, w * torch.log1p(differ / eps), differ - C)


def laplace_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """|1 - pred / target| (reference model/utils.py:18-25)."""
    return torch.abs(1.0 - pred / target)


def uncertainty_reg_loss(reg_loss: torch.Tensor, uncertainty: torch.Tensor) -> torch.Tensor:
    """loss * exp(-u) + 0.5 u (reference model/utils.py:7-15)."""
    return reg_loss * torch.exp(-uncertainty) + 0.5 * uncertainty


def multitask_uncertainty_weighting(loss_dict, log_vars, uncertainty_keys):
    """Learned log-variance task weighting (reference
    layers/uncert_wrapper.py:17-56): ``loss * exp(-s_i) + s_i`` for each
    named term. Returns (new loss dict, weight dict). With fewer log
    variances than keys, the last one serves the rest, as ``jnp`` indexing
    clamps an index past the end."""
    out = dict(loss_dict)
    weights = {}
    for i, key in enumerate(uncertainty_keys):
        s = log_vars[min(i, len(log_vars) - 1)]
        if key in out:
            out[key] = out[key] * torch.exp(-s) + s
        weights[key.replace("_loss", "") + "_w"] = torch.exp(-s)
    return out, weights
