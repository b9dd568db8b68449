"""Building blocks: conv + BN + activation, the DCN module, bilinear up.

Modules take and return NCHW tensors, as ``torch.nn.Conv2d`` does; the
detector hands them NHWC memory viewed as NCHW (channels-last), so the DCN
module's move to the kernel's NHWC layout is a view, not a copy. Parameter
names follow the reference torch model, so that a state dict of the
reference (``DGDE/model/backbone/dla_dcn.py``, ``DCNv2/DCN/dcn_v2.py``)
loads as it is.

Precision follows the JAX package's flax modules: parameters stay fp32 and
every layer computes in the type of its input activations. The convs
(:class:`Conv2d`, :class:`Conv1d`, :class:`ConvTranspose2d`) cast their
kernel and bias to that type, as a flax ``nn.Conv`` with ``dtype`` does; BN
normalises with fp32 statistics and parameters and returns the input's
type, as flax's ``BatchNorm`` does. With fp32 inputs every cast is a no-op.

In data-parallel training (:func:`use_process_group`) BN takes its batch
moments over the global batch, summed over the process group, as flax's
``BatchNorm(axis_name="data")`` does over the JAX package's mesh.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import deform_conv2d_clamped, deform_conv2d_gather
from ..ops.dcn_cuda import DeformConv2dFunction
from ..ops.upsample_cuda import UpsampleAddFunction
from ..parallel.mesh import all_reduce_sum
from ..utils.profiling import span

BN_EPS = 1e-5
DCN_IMPLS = ("auto", "pallas", "dense", "gather", "plain")
BN_MOMENTUM = 0.1  # reference dla_dcn.py:18


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's type (kernel and bias cast)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` that computes in its input's type (kernel and bias cast)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """The depthwise f-fold upsampling of :func:`bilinear_up`:
    ``nn.ConvTranspose2d(C, C, 2f, stride=f, padding=f // 2, groups=C,
    bias=False)``, computed in its input's type, as the JAX package's
    ``BilinearUp`` casts its kernel. ``forward(x, skip)`` returns
    ``up(x) + skip``, the decoder's upsampling and the add after it, in one
    pass of the upsampling kernel
    (:class:`~dcd_tpu_torch.ops.upsample_cuda.UpsampleAddFunction`; on the
    CPU its plain version)."""

    def __init__(self, channels: int, f: int):
        super().__init__(channels, channels, 2 * f, stride=f, padding=f // 2, groups=channels,
                         bias=False)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return UpsampleAddFunction.apply(x, self.weight, skip, self.stride[0])


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module) -> Iterator[None]:
    """Training-mode BN of ``model`` inside the body normalises with the
    batch's moments as always but leaves its running statistics and
    ``num_batches_tracked`` as they are. ``engine/train.py`` runs the forward
    that ``torch.utils.checkpoint`` recomputes in the backward (``remat``) in
    it, so that each step updates the statistics once, as the JAX package's
    functional ``jax.checkpoint`` does."""
    bns = [m for m in model.modules() if isinstance(m, _BiasedRunningVar)]
    for m in bns:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m in bns:
            m.stats_frozen = False


def use_process_group(model: nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Every BN of ``model`` takes its training-mode moments over ``group``
    (None: over its own batch, as before)."""
    for m in model.modules():
        if isinstance(m, _BiasedRunningVar):
            m.process_group = group


class _BiasedRunningVar:
    """Training-mode BN whose running variance takes the *biased* batch
    variance, as flax's ``BatchNorm`` (the JAX package's) does; torch's own
    takes the unbiased one, a factor n/(n-1) apart. The output, the
    parameters, the buffers and their names are torch's; eval mode is
    torch's own. ``momentum=None`` keeps torch's cumulative average. A bf16
    input is normalised in fp32 and its statistics taken in fp32 (flax's
    ``force_float32_reductions``); the output is bf16. Under
    :func:`frozen_running_stats` the running statistics stay as they are.

    With a ``process_group`` (:func:`use_process_group`) the training-mode
    moments are those of the global batch, as flax's ``axis_name`` gives
    them: each rank sums x and x^2 over its batch in fp32, one differentiable
    all-reduce sums them (and the counts) over the group, so the gradient
    carries the other ranks' terms, and the layer normalises with the global
    mean and biased variance E[x^2] - E[x]^2 (flax's fast variance) and
    moves the running statistics with them. Without a group, or in eval
    mode, the layer is as above. (``nn.SyncBatchNorm`` keeps the unbiased
    variance in its running statistics, so it is not used.)"""

    stats_frozen = False
    process_group: Optional[dist.ProcessGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._global_batch_norm(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if self.stats_frozen:
            return out
        with torch.no_grad():
            dims = [0, *range(2, x.dim())]
            var, mean = torch.var_mean(x.float(), dims, correction=0)
            self._update_running(mean, var)
        return out

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.num_batches_tracked += 1
        m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        self.running_mean.lerp_(mean, m)
        self.running_var.lerp_(var, m)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, C) + (1,) * (x.dim() - 2)
        x32 = x.float()
        count = x32.new_full((1,), x32.numel() // C)
        sums = all_reduce_sum(torch.cat([x32.sum(dims), (x32 * x32).sum(dims), count]),
                              self.process_group, differentiable=True)
        n = sums[2 * C]
        mean = sums[:C] / n
        var = torch.clamp(sums[C:2 * C] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = (x32 - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        if not self.stats_frozen:
            with torch.no_grad():
                self._update_running(mean.detach(), var.detach())
        return out.to(x.dtype)


class BatchNorm2d(_BiasedRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm1d(_BiasedRunningVar, nn.BatchNorm1d):
    pass


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_bn_act(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                act: nn.Module = None) -> nn.Sequential:
    """Conv (no bias) + BN + activation (ReLU unless given) as the
    reference's ``Sequential``: children ``0`` conv, ``1`` BN, ``2`` act."""
    return nn.Sequential(
        Conv2d(cin, cout, kernel_size, stride, (kernel_size - 1) // 2, bias=False),
        batch_norm(cout),
        nn.ReLU() if act is None else act,
    )


class DCN(nn.Module):
    """Modulated deformable conv: an ordinary conv predicts per-tap offsets
    and mask logits, the deformable conv applies them.

    Reference ``DCN`` (DCNv2/DCN/dcn_v2.py:97-128): ``conv_offset_mask``
    emits 3K channels; the first 2K are the offsets, read interleaved
    (dy_t = ch[2t], dx_t = ch[2t+1]), the last K the mask logits. The JAX
    package reads its offset conv in block layout instead; the weight carry
    permutes (:func:`dcd_tpu_torch.utils.weights.from_jax_variables`).

    ``impl`` takes the JAX package's values with their meanings
    (``dcd_tpu/models/layers.py::DCN``):

    * ``"auto"`` and ``"pallas"``: the hand-written kernels through
      :class:`DeformConv2dFunction` (on CPU tensors, their plain versions);
    * ``"dense"``: autograd of the plain clamped form;
    * ``"gather"``: the plain unbounded form (offsets not clipped);
    * ``"plain"``: an ordinary conv that ignores offsets and mask.

    Offsets reach the deformable conv in fp32, mask, weight and bias in the
    input's type, as the JAX package hands them to its Pallas kernel.
    """

    def __init__(self, cin: int, cout: int, impl: str = "auto", radius: int = 3):
        super().__init__()
        if impl not in DCN_IMPLS:
            raise ValueError(f"unknown dcn_impl {impl!r}; one of {DCN_IMPLS}")
        self.impl = impl
        self.radius = radius
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = Conv2d(cin, 27, 3, padding=1)
        bound = 1.0 / math.sqrt(cin * 9)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("dcd.dcn"):
            bias = self.bias.to(x.dtype)
            if self.impl == "plain":  # the JAX package's diagnostic lower bound
                return F.conv2d(x, self.weight.to(x.dtype), bias, padding=1)
            om = self.conv_offset_mask(x).permute(0, 2, 3, 1)  # NHWC view
            offset = om[..., :18].float().contiguous()
            mask = torch.sigmoid(om[..., 18:]).contiguous()
            x_nhwc = x.permute(0, 2, 3, 1).contiguous()
            weight = self.weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()  # (3, 3, Cin, Cout)
            if self.impl in ("auto", "pallas"):
                out = DeformConv2dFunction.apply(x_nhwc, offset, mask, weight, bias, self.radius)
            elif self.impl == "dense":
                out = deform_conv2d_clamped(x_nhwc, offset, mask, weight, bias, self.radius)
            else:
                out = deform_conv2d_gather(x_nhwc, offset, mask, weight, bias)
            return out.permute(0, 3, 1, 2)


class DeformConv(nn.Module):
    """DCN + BN + ReLU (reference DeformConv, dla_dcn.py:398-410)."""

    def __init__(self, cin: int, cout: int, impl: str = "auto", radius: int = 3):
        super().__init__()
        self.actf = nn.Sequential(batch_norm(cout), nn.ReLU())
        self.conv = DCN(cin, cout, impl, radius)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.actf(self.conv(x))


def bilinear_kernel_1d(f: int) -> np.ndarray:
    """1-D factor of the bilinear upsampling kernel of size 2f
    (reference fill_up_weights, dla_dcn.py:386-395)."""
    size = f * 2
    fc = np.ceil(size / 2)
    c = (2 * fc - 1 - fc % 2) / (2.0 * fc)
    i = np.arange(size)
    return 1 - np.abs(i / fc - c)


def bilinear_up(channels: int, f: int) -> ConvTranspose2d:
    """Depthwise transposed conv initialised to bilinear upsampling
    (reference dla_dcn.py:422-425 + fill_up_weights). The JAX package
    computes the same operator by its polyphase decomposition, as the
    port's kernel does."""
    up = ConvTranspose2d(channels, f)
    k1 = torch.from_numpy(bilinear_kernel_1d(f)).float()
    with torch.no_grad():
        up.weight.copy_(torch.outer(k1, k1).expand_as(up.weight))
    return up
