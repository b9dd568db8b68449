"""The weights of a run, drawn on the device from the run's seed.

The distributions are a frozen copy of the program's initialisation (flax's
defaults, as the JAX package draws them): every conv of the trunk, the
projections, the heads and edge fusion a truncated LeCun normal (std
sqrt(1 / fan_in), cut at two standard deviations), every DCN kernel uniform
in +-1/sqrt(fan_in), the uncertainty heads a normal of variance
1e-4 / fan_avg, zero biases but the class head's focal prior, unit BN, and
the bilinear upsampling kernels kept. Then the offset convs get the
statistics of trained checkpoints (a bias of std 0.45 px and kernel noise
of std 0.3 / sqrt(fan_in) on the offset channels; with zero offset convs
every DCN would be a plain conv), and every BN's running statistics are
set to the batch statistics of one training-mode forward of the reference
on the calibration images (random weights would otherwise grow the
activations layer by layer). Each distribution is one draw on the device,
sliced over the layers in module order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..reference import config as ref_config
from ..reference.layers import DCN, BatchNorm1d, BatchNorm2d, ConvTranspose2d, bilinear_kernel_1d
from ..reference.predictor import KeypointDetector

TRUNCATED_STD = 0.87962566103423978  # std of a unit normal cut at +-2
OFFSET_BIAS_STD = 0.45
OFFSET_NOISE = 0.3


def reference_model(tree, device) -> KeypointDetector:
    """The reference detector on ``device`` with every parameter and buffer
    allocated and unset (built on the meta device, so no host draw)."""
    with torch.device("meta"):
        model = KeypointDetector(ref_config.load(tree))
    return model.to_empty(device=device)


@torch.no_grad()
def draw(model: KeypointDetector, seed: int) -> None:
    """Fill every parameter and buffer of the reference ``model`` from
    ``seed`` (module docstring)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = model.cfg
    head = cfg.model.head
    heads = model.heads
    small = {}
    for group, convs in zip(head.regression_heads, heads.reg_heads):
        for key, conv in zip(group, convs):
            if "uncertainty" in key and head.uncertainty_init:
                small[id(conv)] = math.sqrt(1e-4 / ((conv.in_channels + conv.out_channels) / 2))
    offset_convs = {id(m.conv_offset_mask) for m in model.modules() if isinstance(m, DCN)}

    lecun: List[Tuple[torch.Tensor, float]] = []
    uniform: List[Tuple[torch.Tensor, float]] = []
    normal: List[Tuple[torch.Tensor, float]] = []
    for mod in model.modules():
        if isinstance(mod, ConvTranspose2d):
            f = mod.stride[0]
            k1 = torch.from_numpy(bilinear_kernel_1d(f)).float().to(dev)
            mod.weight.copy_(torch.outer(k1, k1).expand_as(mod.weight))
        elif isinstance(mod, (BatchNorm2d, BatchNorm1d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.reset_running_stats()
        elif isinstance(mod, DCN):
            uniform.append((mod.weight, 1.0 / math.sqrt(mod.weight[0].numel())))
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Conv1d)):
            if mod.bias is not None:
                mod.bias.zero_()
            if id(mod) in offset_convs:
                mod.weight.zero_()
                n_off = 2 * mod.out_channels // 3
                normal.append((mod.bias[:n_off], OFFSET_BIAS_STD))
                normal.append((mod.weight[:n_off], OFFSET_NOISE / math.sqrt(mod.weight[0].numel())))
            elif id(mod) in small:
                normal.append((mod.weight, small[id(mod)]))
            else:
                lecun.append((mod.weight, math.sqrt(1.0 / mod.weight[0].numel())))
    heads.class_head[3].bias.fill_(-float(np.log(1.0 / head.init_p - 1.0)))

    def fill(items, sample):
        total = sum(t.numel() for t, _ in items)
        flat = sample(torch.empty(total, device=dev))
        at = 0
        for t, scale in items:
            t.copy_(flat[at:at + t.numel()].view_as(t) * scale)
            at += t.numel()

    fill(lecun, lambda x: nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen))
    fill(uniform, lambda x: x.uniform_(-1.0, 1.0, generator=gen))
    fill(normal, lambda x: x.normal_(0.0, 1.0, generator=gen))


@torch.no_grad()
def calibrate(model: KeypointDetector, images, edge_indices, edge_len) -> None:
    """Every BN's running statistics := the batch statistics of one
    training-mode forward on these inputs; the model back in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, (BatchNorm2d, BatchNorm1d))]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: after one batch, its statistics
    model.train()
    try:
        model(images, edge_indices, edge_len)
    finally:
        for m in bns:
            m.momentum = 0.1
        model.eval()


def state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of every parameter and buffer."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
