"""DGDE detector: backbone -> heads.

The counterpart of ``dcd_tpu/models/detector.py`` (reference
``KeypointDetector``, DGDE/model/detector.py:12-45). The reference nests the
heads one module deeper (``heads.predictor.*``); here they are ``heads.*``,
the flat form that ``dcd_tpu.utils.checkpoint.import_torch_dgde`` also
reads.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import Config
from ..utils.profiling import span
from .dla import DLASeg
from .predictor import Predictor


class KeypointDetector(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        bb = cfg.model.backbone
        if bb.conv_body != "dla34" or cfg.model.head.predictor != "Base_Predictor":
            raise NotImplementedError(f"{bb.conv_body} / {cfg.model.head.predictor} not ported")
        self.cfg = cfg
        # activations in bf16 with cfg.model.fp16, parameters fp32 either way
        # (the JAX package's build_model, dcd_tpu/engine/train.py:47)
        self.dtype = torch.bfloat16 if cfg.model.fp16 else torch.float32
        self.backbone = DLASeg(bb.levels, bb.channels, bb.down_ratio, bb.last_level,
                               bb.dcn_impl, bb.dcn_radius)
        self.heads = Predictor(cfg, self.backbone.out_channels)

    def forward(self, images: torch.Tensor, edge_indices: Optional[torch.Tensor] = None,
                edge_len: Optional[torch.Tensor] = None,
                lazy_topk: bool = False) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) NHWC, cast to the model's activation type.
        The NCHW view of NHWC memory keeps every activation channels-last,
        the layout the DCN kernel reads."""
        with span("dcd.model"):
            features = self.backbone(images.to(self.dtype).permute(0, 3, 1, 2))
            return self.heads(features, edge_indices, edge_len, lazy_topk=lazy_topk)
