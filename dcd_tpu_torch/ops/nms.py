"""Heatmap NMS, top-K and point-of-interest gather, NHWC.

The counterpart of ``dcd_tpu/ops/nms.py`` (reference
``DGDE/model/layers/utils.py``: sigmoid_hm :39, nms_hm :45, select_topk
:61, select_point_of_interest :120), and :func:`topk_like_jax`, the top-k
that every top-k of the port goes through.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def sigmoid_hm(hm_features: torch.Tensor) -> torch.Tensor:
    """Sigmoid clamped away from {0, 1}."""
    return torch.clamp(torch.sigmoid(hm_features), 1e-4, 1.0 - 1e-4)


def nms_hm(heat_map: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Max-pool NMS on (B, H, W, C): keep only the local maxima."""
    pad = (kernel - 1) // 2
    nchw = heat_map.permute(0, 3, 1, 2)
    hmax = F.max_pool2d(nchw, kernel, stride=1, padding=pad).permute(0, 2, 3, 1)
    return heat_map * (hmax == heat_map).to(heat_map.dtype)


def topk_like_jax(x: torch.Tensor, k: int, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along ``dim``, in
    descending order and, among equal values, lower index first, as
    ``jax.lax.top_k`` gives them. ``torch.topk`` orders ties otherwise and
    may even keep another set at the k-th place; a stable descending sort
    keeps ties in index order."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)


def select_topk(heat_map: torch.Tensor, K: int = 100) -> Tuple[torch.Tensor, ...]:
    """Top-K peaks across all classes of a (B, H, W, C) map.

    Returns (scores, flat_hw_index, cls, ys, xs), each (B, K): per-class
    top-K, then the top-K of the C*K candidates, as the reference does.
    """
    B, H, W, C = heat_map.shape
    hm = heat_map.permute(0, 3, 1, 2).reshape(B, C, H * W)
    topk_scores_all, topk_inds_all = topk_like_jax(hm, K)  # (B, C, K)
    topk_ys = torch.div(topk_inds_all, W, rounding_mode="floor").float()
    topk_xs = (topk_inds_all % W).float()

    topk_scores, topk_inds = topk_like_jax(topk_scores_all.reshape(B, C * K), K)
    topk_clses = torch.div(topk_inds, K, rounding_mode="floor").float()

    def gather_bk(x):
        return torch.gather(x.reshape(B, C * K), 1, topk_inds)

    return (topk_scores, gather_bk(topk_inds_all), topk_clses,
            gather_bk(topk_ys), gather_bk(topk_xs))


def select_point_of_interest(index: torch.Tensor, feature_maps: torch.Tensor) -> torch.Tensor:
    """Feature rows at feature-map points: index (B, K, 2) as (x, y) points
    or (B, K) flat indices, feature_maps (B, H, W, C) -> (B, K, C) in fp32."""
    B, H, W, C = feature_maps.shape
    if index.dim() == 3:
        index = index[:, :, 1] * W + index[:, :, 0]
    index = index.reshape(B, -1).long()
    flat = feature_maps.reshape(B, H * W, C)
    return torch.gather(flat, 1, index[:, :, None].expand(B, index.shape[1], C)).float()
