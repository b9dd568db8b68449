"""Deformable-conv forward through the hand-written CUDA kernel.

The kernel is ``dcd_tpu_torch/csrc/dcn_fwd.cu`` (it replaces the TPU kernel
``dcd_tpu/ops/dcn_pallas.py::_kernel_cw``); its source note says how it is
laid out. The wrapper checks its arguments, allocates the output and
launches on PyTorch's current stream. A tensor on the CPU goes to the plain
version, :func:`dcd_tpu_torch.ops.dcn.deform_conv2d_clamped`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import cuda_build
from .dcn import deform_conv2d_clamped

_KERNELS = {torch.float32: "dcn_fwd_f32", torch.bfloat16: "dcn_fwd_bf16"}


def _check(x, offset, mask, weight, bias) -> None:
    if x.dim() != 4 or x.dtype not in _KERNELS:
        raise TypeError(f"x must be (B, H, W, Cin) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    B, H, W, Cin = x.shape
    if weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, Cin):
        raise ValueError(f"weight must be (3, 3, {Cin}, Cout), got {tuple(weight.shape)}")
    specs = [("x", x, tuple(x.shape), x.dtype),
             ("offset", offset, (B, H, W, 18), torch.float32),
             ("mask", mask, (B, H, W, 9), x.dtype),
             ("weight", weight, tuple(weight.shape), x.dtype)]
    if bias is not None:
        specs.append(("bias", bias, (weight.shape[3],), x.dtype))
    for name, t, shape, dtype in specs:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")


def deform_conv2d(
    x: torch.Tensor,  # (B, H, W, Cin) float32 or bfloat16
    offset: torch.Tensor,  # (B, H, W, 18) float32, interleaved (dy, dx) per tap
    mask: torch.Tensor,  # (B, H, W, 9) x's type, post-sigmoid
    weight: torch.Tensor,  # (3, 3, Cin, Cout) x's type
    bias: Optional[torch.Tensor],  # (Cout,) x's type
    radius: int = 3,
) -> torch.Tensor:
    """3x3 stride-1 modulated deformable conv with offsets clipped to
    ``[-radius, radius]``, NHWC; fp32 sums for fp32 and bf16 inputs.

    ``deform_conv2d.launches`` counts the kernel launches.
    """
    if x.device.type == "cpu":
        return deform_conv2d_clamped(x, offset, mask, weight, bias, radius)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, offset, mask, weight, bias)
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    fn = getattr(cuda_build.library(), _KERNELS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, W, Cin, Cout, int(radius), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{_KERNELS[x.dtype]} launch failed with CUDA error {rc}")
    deform_conv2d.launches += 1
    return out


deform_conv2d.launches = 0
