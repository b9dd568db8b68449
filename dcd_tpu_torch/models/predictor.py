"""Detection heads: class heatmap, grouped regression heads, edge fusion.

The counterpart of ``dcd_tpu/models/predictor.py`` with the reference's
module names (``DGDE/model/head/detector_predictor.py:19-207``):

* ``class_head``: 3x3 conv + BN + act, then a 1x1 conv whose bias starts at
  ``-log(1/p - 1)`` (:60-66);
* ``reg_features[g]``: one 3x3 conv + BN + act per regression group, and
  ``reg_heads[g][k]``: a 1x1 conv per key (:80-102);
* ``trunc_heatmap_conv`` / ``trunc_offset_conv``: edge fusion (:113-125,
  :172-196). Features on the boundary ring of the valid image go through
  replicate-padded 1-D convs and are added back at the ring's pixels.

Features come in as NCHW; the outputs are NHWC, as the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..ops.nms import nms_hm, select_topk, sigmoid_hm
from .layers import BatchNorm1d, Conv1d, Conv2d, conv_bn_act


class Converter_key2channel:
    """Key -> channel slice of the concatenated regression map
    (reference model/layers/utils.py:22-37)."""

    def __init__(self, keys, channels):
        self.keys = [k for group in keys for k in group]
        self.channels = [c for group in channels for c in group]

    def __call__(self, key: str) -> slice:
        index = self.keys.index(key)
        s = sum(self.channels[:index])
        return slice(s, s + self.channels[index], 1)


def _act(name: str) -> nn.Module:
    return nn.ReLU() if name == "relu" else nn.LeakyReLU(0.01)


def edge_fusion(head_conv: int, out_channels: int, kernel_size: int, use_bn: bool,
                use_relu: bool) -> nn.Sequential:
    """1-D conv tower over the boundary ring, children ``0`` conv, ``1`` BN,
    ``2`` act, ``3`` conv, as the reference's (:113-125)."""
    return nn.Sequential(
        Conv1d(head_conv, head_conv, kernel_size, padding=kernel_size // 2,
                  padding_mode="replicate"),
        BatchNorm1d(head_conv, eps=1e-5, momentum=0.1) if use_bn else nn.Identity(),
        nn.ReLU() if use_relu else nn.Identity(),
        Conv1d(head_conv, out_channels, 1),
    )


class Predictor(nn.Module):
    def __init__(self, cfg: Config, in_channels: int):
        super().__init__()
        head = cfg.model.head
        if head.deeper_head:
            raise NotImplementedError("the deeper head variant is not ported")
        self.cfg = cfg
        classes = cfg.datasets.max_classes_num
        hc = head.num_channel
        self.class_head = conv_bn_act(in_channels, hc, 3, act=_act(head.active_func))
        self.class_head.append(Conv2d(hc, classes, 1, bias=True))
        nn.init.constant_(self.class_head[3].bias, -float(np.log(1.0 / head.init_p - 1.0)))
        self.reg_features = nn.ModuleList()
        self.reg_heads = nn.ModuleList()
        for group, chans in zip(head.regression_heads, head.regression_channels):
            self.reg_features.append(conv_bn_act(in_channels, hc, 3, act=_act(head.active_func)))
            self.reg_heads.append(nn.ModuleList(Conv2d(hc, c, 1, bias=True) for c in chans))
        self.offset_group = next(
            gi for gi, g in enumerate(head.regression_heads) if "3d_offset" in g
        )
        self.offset_key = head.regression_heads[self.offset_group].index("3d_offset")
        self.enable_edge_fusion = head.enable_edge_fusion
        if head.enable_edge_fusion:
            use_bn = head.edge_fusion_norm == "BN"
            ks = head.edge_fusion_kernel_size
            self.trunc_heatmap_conv = edge_fusion(hc, classes, ks, use_bn, head.edge_fusion_relu)
            self.trunc_offset_conv = edge_fusion(hc, 2, ks, use_bn, head.edge_fusion_relu)

    def _edge_fuse(self, feature_cls, output_cls, offset_feat, offset_out, edge_indices, edge_len):
        """Add the edge towers' outputs into the heatmap logits and the
        3d_offset map at the ring pixels (reference :172-196; its
        ``grid_sample`` at integer pixels is a gather)."""
        B, _, H, W = feature_cls.shape
        L = edge_indices.shape[1]
        flat = (edge_indices[..., 1] * W + edge_indices[..., 0]).long()  # (B, L)
        valid = (torch.arange(L, device=flat.device)[None, :] < edge_len[:, None]).to(output_cls.dtype)

        def fuse(feat, out, tower):
            idx = flat[:, None, :].expand(B, feat.shape[1], L)
            ring = torch.gather(feat.reshape(B, feat.shape[1], H * W), 2, idx)  # (B, C, L)
            upd = tower(ring) * valid[:, None, :]
            oidx = flat[:, None, :].expand(B, out.shape[1], L)
            return out.reshape(B, out.shape[1], H * W).scatter_add(2, oidx, upd).view(out.shape)

        return (fuse(feature_cls, output_cls, self.trunc_heatmap_conv),
                fuse(offset_feat, offset_out, self.trunc_offset_conv))

    def forward(self, features: torch.Tensor, edge_indices: Optional[torch.Tensor] = None,
                edge_len: Optional[torch.Tensor] = None,
                lazy_topk: bool = False) -> Dict[str, torch.Tensor]:
        B, C, H, W = features.shape
        feature_cls = self.class_head[:3](features)
        output_cls = self.class_head[3](feature_cls)
        do_fusion = self.enable_edge_fusion and edge_indices is not None
        og, ok = self.offset_group, self.offset_key
        offset_feat = self.reg_features[og](features)
        offset_out = self.reg_heads[og][ok](offset_feat)
        if do_fusion:
            output_cls, offset_out = self._edge_fuse(
                feature_cls, output_cls, offset_feat, offset_out, edge_indices, edge_len)
        hm = sigmoid_hm(output_cls.permute(0, 2, 3, 1)).float()  # NHWC

        if not lazy_topk:
            outs = []
            for gi, heads in enumerate(self.reg_heads):
                feat = offset_feat if gi == og else self.reg_features[gi](features)
                for ki, conv in enumerate(heads):
                    outs.append(offset_out if (gi, ki) == (og, ok) else conv(feat))
            reg = torch.cat(outs, dim=1).permute(0, 2, 3, 1)  # NHWC
            return {"cls": hm, "reg": reg}

        # Lazy top-K inference path: only the class branch and the 3d_offset
        # group (the edge-fusion target) run densely; every other group runs
        # on the 3x3 neighbourhoods of the top-K peaks, where the centre of a
        # padded 3x3 conv equals the dense conv at the peak.
        if self.training:
            raise RuntimeError("lazy_topk is an inference-only path")
        K = self.cfg.test.detections_per_img
        scores, indexs, clses, ys, xs = select_topk(nms_hm(hm), K=K)
        xi, yi = xs.long(), ys.long()
        fpad = nn.functional.pad(features, (1, 1, 1, 1))  # (B, C, H+2, W+2)
        Wp = W + 2
        r3 = torch.arange(3, device=features.device)
        nb_idx = ((yi[:, :, None] + r3) * Wp)[:, :, :, None] + (xi[:, :, None] + r3)[:, :, None, :]
        nb = torch.gather(
            fpad.reshape(B, C, (H + 2) * Wp), 2,
            nb_idx.reshape(B, 1, K * 9).expand(B, C, K * 9),
        )  # (B, C, K*9)
        nb = nb.view(B, C, K, 3, 3).permute(0, 2, 1, 3, 4).reshape(B * K, C, 3, 3)

        pois = []
        for gi, heads in enumerate(self.reg_heads):
            feat = None if gi == og else self.reg_features[gi](nb)[:, :, 1:2, 1:2]
            for ki, conv in enumerate(heads):
                if gi == og:
                    full = offset_out if ki == ok else conv(offset_feat)
                    poi = torch.gather(
                        full.reshape(B, full.shape[1], H * W), 2,
                        indexs[:, None, :].expand(B, full.shape[1], K),
                    ).permute(0, 2, 1)  # (B, K, ch)
                else:
                    poi = conv(feat).reshape(B, K, -1)
                pois.append(poi)
        return {
            "cls": hm,
            "reg_pois": torch.cat(pois, dim=-1).float(),
            "scores": scores,
            "clses": clses,
            "points_xy": torch.stack([xs, ys], dim=-1),
        }
