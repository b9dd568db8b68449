"""The full-size forward with example arguments, the counterpart of
``__graft_entry__.entry`` in the JAX package."""

from __future__ import annotations

import torch

from .config import dgde_run_config
from .engine.infer import build_detector, resolve_device


def entry(device=None):
    """(fn, args): the shipped DGDE detector (DLA-34 + deformable decoder +
    heads) at 384x1280 with random weights, and example arguments for it.
    Runs on ``cuda`` unless ``device`` names another device; TF32 is turned
    off, so that fp32 convolutions stay fp32."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dgde_run_config()
    model = build_detector(cfg, dev)
    H, W = cfg.input.height_train, cfg.input.width_train
    L = cfg.max_edge_length
    images = torch.zeros((1, H, W, 3), device=dev)
    edge_idx = torch.zeros((1, L, 2), dtype=torch.long, device=dev)
    edge_len = torch.full((1,), 16, dtype=torch.long, device=dev)

    @torch.no_grad()
    def fn(images, edge_idx, edge_len):
        return model(images, edge_idx, edge_len)

    return fn, (images, edge_idx, edge_len)
