"""Deformable conv through the hand-written CUDA kernels, and its autograd.

The kernels are ``dcd_tpu_torch/csrc/dcn_fwd.cu`` (the forward, replacing the
TPU kernel ``dcd_tpu/ops/dcn_pallas.py::_kernel_cw``) and
``dcd_tpu_torch/csrc/dcn_bwd.cu`` (the backward, replacing
``_bwd_pom_kernel_cw`` and ``_bwd_x_kernel_cw``); their source notes say how
they are laid out. Each wrapper checks its arguments, allocates outputs and
scratch, launches on PyTorch's current stream and counts its launches in
``<wrapper>.launches`` (the forward's by C entry point, in
``deform_conv2d.launches_by_kernel``). A tensor on the CPU goes to the plain version
(:mod:`dcd_tpu_torch.ops.dcn`); a CUDA tensor launches the kernel or raises.

:class:`DeformConv2dFunction` is the counterpart of the JAX package's custom
VJP ``deform_conv2d_pallas``: forward by :func:`deform_conv2d`, backward by
:func:`dcn_bwd_pom` (grad offset, mask and weight) and :func:`dcn_bwd_x`
(grad x), the bias gradient the sum of the cotangent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import cuda_build
from .dcn import deform_conv2d_clamped, dcn_bwd_pom_plain, dcn_bwd_x_plain

_KERNELS = {torch.float32: "dcn_fwd_f32", torch.bfloat16: "dcn_fwd_bf16"}


def _check_specs(specs) -> None:
    dev = specs[0][1].device
    for name, t, shape, dtype in specs:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")


def _check_vectors(x, weight, *more) -> None:
    """The kernels read channels in 16-byte vectors (of x, weight and
    ``more``) and index pixels in int32."""
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    if Cin % 8 or Cout % 8:
        raise ValueError(f"Cin and Cout must be multiples of 8, got {Cin} and {Cout}")
    if any(t.data_ptr() % 16 for t in (x, weight, *more)):
        raise ValueError("the kernels' inputs must start on a 16-byte boundary")
    if B * H * W >= 2 ** 31:
        raise ValueError(f"B*H*W must be below 2^31, got {B * H * W}")


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
    _check_specs(specs)
    _check_vectors(x, weight)


def _check_bwd(x, offset, mask, weight, g) -> None:
    """The backward kernels take fp32 only, the type of the port's training."""
    for name, t in (("x", x), ("offset", offset), ("mask", mask), ("weight", weight), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the backward kernels, got {t.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"x must be (B, H, W, Cin) and weight (3, 3, Cin, Cout), "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    _check_specs([("x", x, (B, H, W, Cin), torch.float32),
                  ("offset", offset, (B, H, W, 18), torch.float32),
                  ("mask", mask, (B, H, W, 9), torch.float32),
                  ("weight", weight, (3, 3, Cin, Cout), torch.float32),
                  ("g", g, (B, H, W, Cout), torch.float32)])


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(cuda_build.library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


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

    ``deform_conv2d.launches_by_kernel`` counts the kernel launches by C
    entry point (``dcn_fwd_f32``, ``dcn_fwd_bf16``).
    """
    if _device_of(x) == "cpu":
        return deform_conv2d_clamped(x, offset, mask, weight, bias, radius)
    _check(x, offset, mask, weight, bias)
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    name = _KERNELS[x.dtype]
    _launch(name, x.device,
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, W, Cin, Cout, int(radius))
    deform_conv2d.launches_by_kernel[name] += 1
    return out


# The largest radius of K3: bwd_x_kernel's halo and its 32-bit masks of
# candidate sources are sized for MAX_R of csrc/dcn_bwd.cu.
BWD_X_MAX_RADIUS = 4


def _check_bwd_kernel(x, offset, weight, g, radius, max_radius=None) -> None:
    """What the backward kernels take beyond :func:`_check_bwd`: 16-byte
    vectors of x, g and W, offsets in 8-byte pairs, int32 pixel indices,
    and a radius of at least 0 (and at most ``max_radius``)."""
    _check_vectors(x, weight, g)
    if offset.data_ptr() % 8:
        raise ValueError("offset must start on an 8-byte boundary")
    if int(radius) < 0 or (max_radius is not None and int(radius) > max_radius):
        top = "" if max_radius is None else f", {max_radius}"
        raise ValueError(f"radius must be in [0{top}] for this backward kernel, got {radius}")


def dcn_bwd_pom(
    x: torch.Tensor,  # (B, H, W, Cin) float32
    offset: torch.Tensor,  # (B, H, W, 18) float32
    mask: torch.Tensor,  # (B, H, W, 9) float32
    weight: torch.Tensor,  # (3, 3, Cin, Cout) float32
    g: torch.Tensor,  # (B, H, W, Cout) float32, the cotangent of the output
    radius: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (grad_offset, grad_mask, grad_weight) of the clamped deformable
    conv.

    ``dcn_bwd_pom.launches`` counts the calls that launched the kernels.
    """
    _check_bwd(x, offset, mask, weight, g)
    if _device_of(x) == "cpu":
        return dcn_bwd_pom_plain(x, offset, mask, weight, g, radius)
    _check_bwd_kernel(x, offset, weight, g, radius)
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    splits = cuda_build.library().dcn_bwd_weight_splits(B, H, W, Cin, Cout)
    go = torch.empty((B, H, W, 18), dtype=torch.float32, device=x.device)
    gm = torch.empty((B, H, W, 9), dtype=torch.float32, device=x.device)
    gw = torch.empty((3, 3, Cin, Cout), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, 9 * Cin * Cout), dtype=torch.float32, device=x.device)
    _launch("dcn_bwd_pom_f32", x.device,
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), g.data_ptr(), weight.data_ptr(),
            go.data_ptr(), gm.data_ptr(), gw.data_ptr(), part.data_ptr(),
            B, H, W, Cin, Cout, int(radius), splits)
    dcn_bwd_pom.launches += 1
    return go, gm, gw


def dcn_bwd_x(
    x: torch.Tensor,  # (B, H, W, Cin) float32; its shape and device are what count
    offset: torch.Tensor,  # (B, H, W, 18) float32
    mask: torch.Tensor,  # (B, H, W, 9) float32
    weight: torch.Tensor,  # (3, 3, Cin, Cout) float32
    g: torch.Tensor,  # (B, H, W, Cout) float32
    radius: int = 3,
) -> torch.Tensor:
    """K3: grad_x of the clamped deformable conv, sum_k W_k G_k with G_k the
    transposed gather of mask * g over the source pixels each input pixel
    feeds.

    ``dcn_bwd_x.launches`` counts the calls that launched the kernel.
    """
    _check_bwd(x, offset, mask, weight, g)
    if _device_of(x) == "cpu":
        return dcn_bwd_x_plain(x, offset, mask, weight, g, radius)
    _check_bwd_kernel(x, offset, weight, g, radius, BWD_X_MAX_RADIUS)
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    gx = torch.empty((B, H, W, Cin), dtype=torch.float32, device=x.device)
    _launch("dcn_bwd_x_f32", x.device, offset.data_ptr(), mask.data_ptr(), g.data_ptr(),
            weight.data_ptr(), gx.data_ptr(), B, H, W, Cin, Cout, int(radius))
    dcn_bwd_x.launches += 1
    return gx


def reset_launch_counts() -> None:
    for fn in (dcn_bwd_pom, dcn_bwd_x):
        fn.launches = 0
    deform_conv2d.launches_by_kernel = dict.fromkeys(_KERNELS.values(), 0)


reset_launch_counts()


class DeformConv2dFunction(torch.autograd.Function):
    """Clamped deformable conv with the kernels' backward.

    ``apply(x, offset, mask, weight, bias, radius)`` with the layouts of
    :func:`deform_conv2d`; the backward returns grad_x (K3), grad_offset,
    grad_mask and grad_weight (K2) and grad_bias = the sum of the cotangent,
    as the JAX package's ``_bwd`` does outside its kernels. CUDA tensors go
    through the kernels, CPU tensors through the plain versions.
    """

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, radius):
        ctx.radius = radius
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, offset, mask, weight)
        return deform_conv2d(x, offset, mask, weight, bias, radius)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        g = g.contiguous()
        go, gm, gw = dcn_bwd_pom(x, offset, mask, weight, g, ctx.radius)
        gx = dcn_bwd_x(x, offset, mask, weight, g, ctx.radius)
        gb = g.sum((0, 1, 2)) if ctx.has_bias else None
        return gx, go, gm, gw, gb, None
