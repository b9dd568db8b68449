"""The lower precisions that the controls compute in.

A bf16 configuration's control is the reference with every convolution's
input and kernel rounded to fp8 (e4m3, one scale per tensor: its largest
magnitude maps to e4m3's largest finite value, 448), products and sums as
before. An fp32 configuration's control is the reference with bf16
activations (``KeypointDetector.dtype``)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import DCN, Conv1d, Conv2d, ConvTranspose2d

E4M3_MAX = 448.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in its type."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def set_quantizer(model: nn.Module, fn) -> None:
    """Every convolution of ``model`` rounds its input and kernel by ``fn``
    (None: not at all)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Conv1d, ConvTranspose2d, DCN)):
            m.quantizer = fn
