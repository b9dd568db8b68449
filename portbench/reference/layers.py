"""Building blocks of the reference detector: convolutions that compute in
their input's type, BN whose training-mode running variance is the biased
batch variance, the modulated deformable convolution with its offsets
clipped to ``[-radius, radius]`` in plain PyTorch, and the bilinear
upsampling. Module and parameter names are those of the DGDE reference
model, so that one state dict loads into this detector and the program's.

``quantizer`` (None, or a function of a tensor) is the control's lower
precision: every convolution, deformable or not, rounds its input and its
kernel through it before the product (``precision.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

Quantizer = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(module: nn.Module, t: torch.Tensor) -> torch.Tensor:
    fn = getattr(module, "quantizer", None)
    return t if fn is None else fn(t)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(_q(self, x), _q(self, self.weight.to(x.dtype)), bias)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(_q(self, x), _q(self, self.weight.to(x.dtype)), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(_q(self, x), _q(self, self.weight.to(x.dtype)), None,
                                  self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class _BiasedRunningVar:
    """Training-mode BN normalising with the batch's moments and moving the
    running variance with the biased batch variance, statistics in fp32;
    eval mode is torch's own. The output takes the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            dims = [0, *range(2, x.dim())]
            var, mean = torch.var_mean(x.float(), dims, correction=0)
            self.num_batches_tracked += 1
            m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
            self.running_mean.lerp_(mean, m)
            self.running_var.lerp_(var, m)
        return out


class BatchNorm2d(_BiasedRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm1d(_BiasedRunningVar, nn.BatchNorm1d):
    pass


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_bn_act(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                act: nn.Module = None) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(cin, cout, kernel_size, stride, (kernel_size - 1) // 2, bias=False),
        batch_norm(cout),
        nn.ReLU() if act is None else act,
    )


def deform_conv2d_clamped(x, offset, mask, weight, bias, radius):
    """Modulated deformable 3x3 conv, stride 1, padding 1, NHWC, offsets
    interleaved per tap (dy, dx) and clipped to ``[-radius, radius]``; a tap
    whose dy or dx is NaN is dropped. Sampling and the product's sums in
    fp32; the samples rounded once to x's type before the product; the
    output in x's type."""
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = weight.shape
    K = kh * kw
    dev = x.device
    xf = x.float().reshape(B * H * W, Cin)
    off = offset.float().reshape(B, H, W, K, 2).clamp(-radius, radius)
    drop = off.isnan().any(-1)
    off = torch.where(drop[..., None], torch.zeros_like(off), off)
    iy = torch.floor(off[..., 0])
    ix = torch.floor(off[..., 1])
    fy = off[..., 0] - iy
    fx = off[..., 1] - ix
    taps = torch.arange(K, device=dev)
    row = torch.arange(H, device=dev).view(1, H, 1, 1)
    col = torch.arange(W, device=dev).view(1, 1, W, 1)
    y0 = row + (taps // kw) - 1 + iy.long()
    x0 = col + (taps % kw) - 1 + ix.long()
    img = (torch.arange(B, device=dev) * (H * W)).view(B, 1, 1, 1)
    m = mask.float()
    sampled = None
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yc, xc = y0 + dy, x0 + dx
        valid = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W) & ~drop
        idx = img + yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)
        coef = torch.where(valid, wgt * m, torch.zeros_like(wgt))
        term = xf.index_select(0, idx.reshape(-1)).view(B, H, W, K, Cin) * coef[..., None]
        sampled = term if sampled is None else sampled + term
    sampled = sampled.to(x.dtype).float()
    out = sampled.reshape(B * H * W, K * Cin) @ weight.float().reshape(K * Cin, Cout)
    if bias is not None:
        out = out + bias.float()
    return out.view(B, H, W, Cout).to(x.dtype)


class DCN(nn.Module):
    """Offsets and mask logits from an ordinary conv (27 channels: 18
    interleaved offsets, 9 mask logits), then the clamped deformable conv.
    ``block`` > 0 computes the deformable conv over that many images at a
    time (the plain sampling holds nine taps of every input channel)."""

    block = 0

    def __init__(self, cin: int, cout: int, radius: int = 3):
        super().__init__()
        self.radius = radius
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = Conv2d(cin, 27, 3, padding=1)
        bound = 1.0 / math.sqrt(cin * 9)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype)
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)
        offset = om[..., :18].float().contiguous()
        mask = torch.sigmoid(om[..., 18:]).contiguous()
        x_nhwc = _q(self, x.permute(0, 2, 3, 1).contiguous())
        weight = _q(self, self.weight.to(x.dtype).permute(2, 3, 1, 0).contiguous())
        n = self.block or x.shape[0]
        out = torch.cat([deform_conv2d_clamped(x_nhwc[i:i + n], offset[i:i + n], mask[i:i + n],
                                               weight, bias, self.radius)
                         for i in range(0, x.shape[0], n)])
        return out.permute(0, 3, 1, 2)


class DeformConv(nn.Module):
    """DCN + BN + ReLU."""

    def __init__(self, cin: int, cout: int, radius: int = 3):
        super().__init__()
        self.actf = nn.Sequential(batch_norm(cout), nn.ReLU())
        self.conv = DCN(cin, cout, radius)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.actf(self.conv(x))


def bilinear_kernel_1d(f: int) -> np.ndarray:
    size = f * 2
    fc = np.ceil(size / 2)
    c = (2 * fc - 1 - fc % 2) / (2.0 * fc)
    i = np.arange(size)
    return 1 - np.abs(i / fc - c)


def bilinear_up(channels: int, f: int) -> ConvTranspose2d:
    """Depthwise transposed conv holding the bilinear upsampling kernel."""
    up = ConvTranspose2d(channels, channels, f * 2, stride=f, padding=f // 2,
                         groups=channels, bias=False)
    k1 = torch.from_numpy(bilinear_kernel_1d(f)).float()
    with torch.no_grad():
        up.weight.copy_(torch.outer(k1, k1).expand_as(up.weight))
    return up
