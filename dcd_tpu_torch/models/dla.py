"""DLA-34 backbone with the DLAUp/IDAUp deformable decoder, NCHW.

The counterpart of ``dcd_tpu/models/dla.py``, with the reference's module
names (``DGDE/model/backbone/dla_dcn.py``):

* DLA([1,1,1,2,2,1], [16,32,64,128,256,512], BasicBlock), :361-368;
* hierarchical Tree/Root aggregation, :186-260;
* DLAUp + IDAUp decoder with DCN proj/node blocks and bilinear depthwise
  transposed-conv upsampling, :398-465;
* output: the stride-4 feature map with 64 channels (DLASeg, :31-59).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.profiling import span
from .layers import Conv2d, DeformConv, batch_norm, bilinear_up, conv_bn_act


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(cout)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + residual)


class Root(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, 1, 0, bias=False)
        self.bn = batch_norm(cout)

    def forward(self, *children):
        return torch.relu(self.bn(self.conv(torch.cat(children, 1))))


class Tree(nn.Module):
    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout, 1)
            self.root = Root(root_dim, cout)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, root_dim=0)
            self.tree2 = Tree(levels - 1, cout, cout, root_dim=root_dim + cout)
        self.levels = levels
        self.level_root = level_root
        self.downsample = nn.MaxPool2d(stride, stride) if stride > 1 else None
        self.project = (
            nn.Sequential(Conv2d(cin, cout, 1, bias=False), batch_norm(cout))
            if cin != cout else None
        )

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample is not None else x
        # only a leaf uses the residual, but an inner tree computes it as
        # well, as the reference does: in training its BN's running
        # statistics move
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    def __init__(self, levels: Sequence[int], channels: Sequence[int]):
        super().__init__()
        ch = channels
        self.base_layer = conv_bn_act(3, ch[0], 7)
        self.level0 = self._conv_level(ch[0], ch[0], levels[0], 1)
        self.level1 = self._conv_level(ch[0], ch[1], levels[1], 2)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True)

    @staticmethod
    def _conv_level(cin: int, cout: int, convs: int, stride: int) -> nn.Sequential:
        """Reference _make_conv_level (:313-323): children 3i, 3i+1, 3i+2."""
        mods = []
        for i in range(convs):
            mods.extend(conv_bn_act(cin if i == 0 else cout, cout, 3, stride if i == 0 else 1))
        return nn.Sequential(*mods)

    def forward(self, x) -> List[torch.Tensor]:
        y = self.base_layer(x)
        outs = []
        for i in range(6):
            y = getattr(self, f"level{i}")(y)
            outs.append(y)
        return outs


class IDAUp(nn.Module):
    """Iterative deep aggregation (reference dla_dcn.py:412-438): project each
    finer level with a DCN block, upsample it, and merge with a DCN node."""

    def __init__(self, out_channels: int, channels: Sequence[int], up_factors: Sequence[int],
                 dcn_impl: str, dcn_radius: int):
        super().__init__()
        for i in range(1, len(channels)):
            f = int(up_factors[i])
            setattr(self, f"proj_{i}", DeformConv(channels[i], out_channels, dcn_impl, dcn_radius))
            setattr(self, f"up_{i}", bilinear_up(out_channels, f))
            setattr(self, f"node_{i}", DeformConv(out_channels, out_channels, dcn_impl, dcn_radius))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(startp + 1, endp):
            k = i - startp
            proj = getattr(self, f"proj_{k}")(layers[i])
            with span("dcd.upsample"):  # the upsampling and the add, one kernel
                up = getattr(self, f"up_{k}")(proj, skip=layers[i - 1])
            layers[i] = getattr(self, f"node_{k}")(up)
        return layers


class DLAUp(nn.Module):
    """Fuse levels coarse to fine (reference dla_dcn.py:442-465)."""

    def __init__(self, channels: Sequence[int], scales: Sequence[int], dcn_impl: str,
                 dcn_radius: int):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        scales = np.array(scales, dtype=int)
        self.n = len(channels)
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(channels[j], in_channels[j:],
                                            (scales[j:] // scales[j]).tolist(),
                                            dcn_impl, dcn_radius))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n - 1):
            layers = getattr(self, f"ida_{i}")(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA trunk -> DLAUp -> final IDAUp; the stride-4 feature map with
    ``channels[log2(down_ratio)]`` channels (reference DLASeg, :31-59)."""

    def __init__(self, levels: Sequence[int], channels: Sequence[int], down_ratio: int = 4,
                 last_level: int = 5, dcn_impl: str = "auto", dcn_radius: int = 3):
        super().__init__()
        self.first_level = int(np.log2(down_ratio))
        self.last_level = last_level
        fl = self.first_level
        self.base = DLA(levels, channels)
        dec = list(channels[fl:])
        self.dla_up = DLAUp(dec, [2 ** i for i in range(len(dec))], dcn_impl, dcn_radius)
        self.ida_up = IDAUp(channels[fl], list(channels[fl:last_level]),
                            [2 ** i for i in range(last_level - fl)], dcn_impl, dcn_radius)
        self.out_channels = channels[fl]

    def forward(self, x) -> torch.Tensor:
        with span("dcd.trunk"):
            feats = self.base(x)
        with span("dcd.decoder"):
            outs = self.dla_up(feats[self.first_level:])
            y = outs[: self.last_level - self.first_level]
            return self.ida_up(y, 0, len(y))[-1]
