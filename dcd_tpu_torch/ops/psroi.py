"""Deformable position-sensitive ROI pooling.

The counterpart of ``dcd_tpu/ops/psroi.py``, which completes the DCNv2
extension's public API (``dcn_v2_psroi_pooling_forward/backward``, exposed
as ``DCNPooling``/``DCNv2Pooling`` in the reference's DCN/dcn_v2.py:132-303)
although the pipeline never calls it: plain PyTorch, vectorised over rois,
bins and samples, with autograd for the backward, following the deformable
PSROI pooling of Dai et al., "Deformable Convolutional Networks" (2017).
No path of the port runs it, so it has no CUDA kernel.

Layout: NHWC features, rois (N, 5) = [batch_idx, x1, y1, x2, y2].
"""

from __future__ import annotations

from typing import Optional

import torch


def deform_psroi_pooling(
    features: torch.Tensor,  # (B, H, W, C)
    rois: torch.Tensor,  # (N, 5) [batch, x1, y1, x2, y2] in image coords
    trans: Optional[torch.Tensor],  # (N, part, part, 2) normalised offsets or None
    spatial_scale: float,
    out_size: int,  # pooled P
    out_dim: int,  # output channels
    group_size: int = 1,
    part_size: Optional[int] = None,
    sample_per_part: int = 4,
    trans_std: float = 0.0,
) -> torch.Tensor:
    """Returns (N, P, P, out_dim).

    For each roi bin, samples ``sample_per_part^2`` points bilinearly from
    the position-sensitive channel group of that bin and averages the
    in-bounds ones; ``trans`` shifts each part by a fraction of the roi
    size (the deformable variant; ``no_trans`` == trans None/zeros).
    """
    B, H, W, C = features.shape
    P, s = out_size, sample_per_part
    part = part_size or P
    N = rois.shape[0]
    dev, dt = features.device, features.dtype

    batch_idx = rois[:, 0].long()
    # roi corners in feature coords (the CUDA kernel rounds and pads by 0.5)
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    bin_w = torch.clamp(x2 - x1, min=0.1) / P  # (N,)
    bin_h = torch.clamp(y2 - y1, min=0.1) / P
    sub_w, sub_h = bin_w / s, bin_h / s

    bins = torch.arange(P, device=dev)
    part_idx = torch.floor(bins.to(dt) / P * part).long()  # the part of each bin
    if trans is None:
        trans = torch.zeros((N, part, part, 2), dtype=dt, device=dev)
    t = trans[:, part_idx][:, :, part_idx] * trans_std  # (N, P[h], P[w], 2)

    def col(v):  # (N,) -> (N, 1, 1)
        return v[:, None, None]

    pw, ph = bins.to(dt)[None, None, :], bins.to(dt)[None, :, None]
    start_x = col(x1) + pw * col(bin_w) + t[..., 0] * col(bin_w) * P  # (N, P, P)
    start_y = col(y1) + ph * col(bin_h) + t[..., 1] * col(bin_h) * P
    r = torch.arange(s, device=dev).to(dt) + 0.5
    # (N, P, P, s[ih], s[iw]): x varies along the last axis, y along the one before
    sx = (start_x[..., None, None] + r[None, :] * sub_w[:, None, None, None, None]).expand(
        N, P, P, s, s)
    sy = (start_y[..., None, None] + r[:, None] * sub_h[:, None, None, None, None]).expand(
        N, P, P, s, s)
    inb = (sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5) & (sy <= H - 0.5)
    sxc = torch.clamp(sx, 0, W - 1)
    syc = torch.clamp(sy, 0, H - 1)
    x0 = torch.floor(sxc).long()
    y0 = torch.floor(syc).long()
    x1i = torch.clamp(x0 + 1, max=W - 1)
    y1i = torch.clamp(y0 + 1, max=H - 1)
    fx = (sxc - x0.to(dt))[..., None]
    fy = (syc - y0.to(dt))[..., None]

    # the position-sensitive channel group of each bin: (P, P, out_dim)
    g = torch.clamp(bins * group_size // P, 0, group_size - 1)
    cbase = (g[:, None] * group_size + g[None, :]) * out_dim
    ch = (cbase[..., None] + torch.arange(out_dim, device=dev)).view(1, P, P, 1, 1, out_dim)
    ch = ch.expand(N, P, P, s, s, out_dim)
    b = batch_idx.view(N, 1, 1, 1, 1).expand(N, P, P, s, s)

    def corner(yy, xx):
        return torch.gather(features[b, yy, xx], -1, ch)  # (N, P, P, s, s, out_dim)

    val = (corner(y0, x0) * ((1 - fy) * (1 - fx)) + corner(y0, x1i) * ((1 - fy) * fx)
           + corner(y1i, x0) * (fy * (1 - fx)) + corner(y1i, x1i) * (fy * fx))
    val = val * inb[..., None].to(dt)
    count = torch.clamp(inb.sum(dim=(3, 4)), min=1).to(dt)[..., None]
    return val.sum(dim=(3, 4)) / count
