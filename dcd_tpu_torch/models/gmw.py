"""GMW — the graph-matching weighting network of stage 2.

The counterpart of ``dcd_tpu/models/gmw.py`` (reference ``GMW/model/model.py``
and ``GMW/model/yi2018cvpr``):

* keypoints -> edges: every i<j pair concatenates both endpoints' features
  (``edge_expand``, model.py:153-163): 73 keypoints -> 2628 edges of 4 (2D)
  and 6 (3D) features;
* two residual towers of 1x1 convolutions with global-context normalisation
  (yi2018cvpr/ops.py:7-19 ``gcn``: per-channel standardisation over the
  edges, unbiased variance), computed as matrix products on (B, E, C);
* the pairwise-L2 cost matrix (model.py:17-36) -> the Sinkhorn transport
  ``P`` and ``reg_weights = 1 / diag(M)`` (graph_extract :165-168).

Parameter names are the reference's (``FeatureExtractor4d.conv_in.0.weight``,
``FeatureExtractor4d.conv_3.conv1.0.weight``, ...; Conv1d weights (out, in,
1)), the layout ``dcd_tpu.utils.checkpoint.import_torch_gmw`` reads. The
initial weights are flax ``Dense``'s: LeCun normal truncated at two
standard deviations, zero biases.

Plus the stage-2 loss pieces (GMW/main.py): ``compute_z``, the closed-form
edge depths (:373-416), ``compute_reg_loss`` (:364-371) and
``correspondence_loss`` (lib/losses.py:22-26,115).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.codec import triu_pair_indices
from ..ops.nms import topk_like_jax
from ..ops.sinkhorn import RegularisedTransport
from ..utils.profiling import span

# flax's truncated normal at +-2 std has std 0.8796...: lecun_normal divides it out
_TRUNCATED_STD = 0.87962566103423978


def gcn_norm(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Global-context norm over the edge axis of (B, N, C), unbiased
    variance (yi2018cvpr/ops.py:13-19)."""
    m = x.mean(dim=1, keepdim=True)
    v = x.var(dim=1, keepdim=True, unbiased=True)
    return (x - m) / torch.sqrt(v + eps)


def _conv1x1(cin: int, cout: int) -> nn.Sequential:
    """The reference's ``Sequential(Conv1d(cin, cout, 1))``."""
    return nn.Sequential(nn.Conv1d(cin, cout, 1))


def _dense(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv1d applied to channels-last (B, N, Cin) features."""
    conv = seq[0]
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class Conv1dResnetBlock(nn.Module):
    """preconv -> conv1 + gcn -> conv2 + gcn -> relu -> + residual
    (yi2018cvpr/ops.py:72-131 with the shipped config: ksize 1, no BN)."""

    def __init__(self, features: int):
        super().__init__()
        self.preconv = _conv1x1(features, features)
        self.conv1 = _conv1x1(features, features)
        self.conv2 = _conv1x1(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _dense(self.preconv, x)
        y = gcn_norm(_dense(self.conv1, y))
        y = gcn_norm(_dense(self.conv2, y))
        return torch.relu(y) + x


class FeatureTower(nn.Module):
    """conv_in + ``depth`` residual blocks (yi2018cvpr/model.py:6-69;
    shipped: depth 12, 128 channels), on channels-last (B, N, C)."""

    def __init__(self, in_features: int, features: int = 128, depth: int = 12):
        super().__init__()
        self.conv_in = _conv1x1(in_features, features)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"conv_{i}", Conv1dResnetBlock(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _dense(self.conv_in, x)
        for i in range(self.depth):
            x = getattr(self, f"conv_{i}")(x)
        return x


def pairwise_l2_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """res[b, i, j] = ||x1[b, i] - x2[b, j]|| (model.py:17-36)."""
    x1n = (x1 ** 2).sum(-1, keepdim=True)
    x2n = (x2 ** 2).sum(-1, keepdim=True)
    d2 = x1n + x2n.transpose(1, 2) - 2.0 * torch.bmm(x1, x2.transpose(1, 2))
    return torch.sqrt(torch.clamp(d2, min=1e-30))


def _pair_index(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    i_idx, j_idx = triu_pair_indices(n)
    return torch.from_numpy(i_idx).to(device), torch.from_numpy(j_idx).to(device)


def edge_expand(f: torch.Tensor) -> torch.Tensor:
    """(B, n, c) -> (B, n(n-1)/2, 2c): concat(f_i, f_j) for i<j
    (model.py:153-163)."""
    i_idx, j_idx = _pair_index(f.shape[1], f.device)
    return torch.cat([f[:, i_idx], f[:, j_idx]], dim=-1)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``lecun_normal`` drawn from ``gen`` into ``weight`` (out
    channels first, so fan_in = ``weight[0].numel()``): a normal of std
    sqrt(1 / fan_in) / 0.8796 truncated at two standard deviations, which
    leaves std sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / weight[0].numel()) / _TRUNCATED_STD
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    weight.copy_(w)


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """flax ``Dense``'s initialisation drawn from ``gen``: every 1x1 conv's
    weight :func:`lecun_normal_`, every bias zero."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv1d):
            lecun_normal_(mod.weight, gen)
            mod.bias.zero_()


class GMW(nn.Module):
    """(kpts_2d (B, n, 2) normalised image coordinates, kpts_3d (B, n, 3))
    -> (reg_weights (B, E), P (B, E, E)), as model.py:195-207. After each
    forward, ``sinkhorn_iterations`` holds the scaling iterations it ran (a
    device tensor)."""

    def __init__(self, num_kpts: int = 73, features: int = 128, depth: int = 12,
                 sinkhorn_lambda: float = 10.0, sinkhorn_tolerance: float = 1e-9):
        super().__init__()
        self.num_kpts = num_kpts
        self.sinkhorn_lambda = sinkhorn_lambda
        self.sinkhorn_tolerance = sinkhorn_tolerance
        self.FeatureExtractor4d = FeatureTower(4, features, depth)
        self.FeatureExtractor6d = FeatureTower(6, features, depth)
        self.sinkhorn_iterations: Optional[torch.Tensor] = None

    def cost(self, kpts_2d: torch.Tensor, kpts_3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(reg_weights (B, E), the cost matrix M (B, E, E)): the forward
        without the transport, all that depth refinement needs. The two
        parts run in profiler spans ``gmw.towers`` and ``gmw.cost_matrix``."""
        with span("gmw.towers"):
            f4 = self.FeatureExtractor4d(edge_expand(kpts_2d))
            f6 = self.FeatureExtractor6d(edge_expand(kpts_3d))
            f4 = f4 / torch.clamp(torch.linalg.norm(f4, dim=-1, keepdim=True), min=1e-12)
            f6 = f6 / torch.clamp(torch.linalg.norm(f6, dim=-1, keepdim=True), min=1e-12)
        with span("gmw.cost_matrix"):
            M = pairwise_l2_dist(f4.float(), f6.float())
            return 1.0 / torch.diagonal(M, dim1=-2, dim2=-1), M

    def forward(self, kpts_2d: torch.Tensor, kpts_3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        reg_weights, M = self.cost(kpts_2d, kpts_3d)
        b, m, n = M.shape
        r = torch.full((b, m), 1.0 / m, dtype=M.dtype, device=M.device)
        c = torch.full((b, n), 1.0 / n, dtype=M.dtype, device=M.device)
        P, self.sinkhorn_iterations = RegularisedTransport.apply(
            M, r, c, self.sinkhorn_lambda, self.sinkhorn_tolerance, 100)
        return reg_weights, P


def compute_z(kpts_2d: torch.Tensor, kpts_3d: torch.Tensor, pred_rot: torch.Tensor,
              topk: int = 1500) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form edge depths from normalised 2D keypoints (GMW/main.py:
    373-416): (depths (B, E) clamped to [0.1, 80], the indices (B, topk)
    of the edges of largest |dV|, ties in index order as JAX's top-k)."""
    y_n = kpts_2d[..., 1]
    X, Y, Z = kpts_3d[..., 0], kpts_3d[..., 1], kpts_3d[..., 2]
    rot = pred_rot.reshape(-1, 1)
    h = Y + y_n * (X * torch.sin(rot) - Z * torch.cos(rot))
    i_idx, j_idx = _pair_index(kpts_2d.shape[1], kpts_2d.device)
    dH = h[:, i_idx] - h[:, j_idx]
    dV = y_n[:, i_idx] - y_n[:, j_idx]
    z = torch.clamp(torch.abs(dH) / torch.clamp(torch.abs(dV), min=1e-10), 0.1, 80.0)
    return z, topk_like_jax(torch.abs(dV), topk)[1]


def compute_reg_loss(pre_depths: torch.Tensor, edge_weight: torch.Tensor, gt_depth: torch.Tensor,
                     good_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-weighted depth over the selected edges (GMW/main.py:364-371):
    (the mean absolute depth error, the predicted depth (B,))."""
    d = torch.gather(pre_depths, -1, good_idx)
    w = torch.softmax(torch.gather(edge_weight, -1, good_idx), dim=-1)
    z = (d * w).sum(-1)
    return torch.abs(z - gt_depth).mean(), z


def correspondence_loss(P: torch.Tensor, C_gt: torch.Tensor) -> torch.Tensor:
    """((1 - 2C) * P) summed over the matrix, batch mean
    (GMW/lib/losses.py:22-26,115); C_gt broadcasts against P."""
    return ((1.0 - 2.0 * C_gt) * P).sum(dim=(-2, -1)).mean()
