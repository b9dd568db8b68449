"""Deformable conv through the hand-written CUDA kernels, and its autograd.

The kernels are ``dcd_tpu_torch/csrc/dcn_fwd.cu`` (the forward, replacing the
TPU kernel ``dcd_tpu/ops/dcn_pallas.py::_kernel_cw``) and
``dcd_tpu_torch/csrc/dcn_bwd.cu`` (the backward, replacing
``_bwd_pom_kernel_cw`` and ``_bwd_x_kernel_cw``); their source notes say how
they are laid out. Each wrapper checks its arguments, allocates outputs and
scratch, launches on PyTorch's current stream and counts its launches by C
entry point in ``<wrapper>.launches_by_kernel``. Each takes fp32 or bf16
inputs (x, mask, weight, and the cotangent for the backward; offsets fp32)
and launches the entry point of that type (``dcn_fwd_f32`` or
``dcn_fwd_bf16``, ``dcn_bwd_pom_f32`` or ``dcn_bwd_pom_bf16``,
``dcn_bwd_x_f32`` or ``dcn_bwd_x_bf16``). A tensor on the CPU goes to the
plain version (:mod:`dcd_tpu_torch.ops.dcn`); a CUDA tensor launches the
kernel or raises.

:class:`DeformConv2dFunction` is the counterpart of the JAX package's custom
VJP ``deform_conv2d_pallas``: forward by :func:`deform_conv2d`, backward by
:func:`dcn_bwd_pom` (grad offset, mask and weight) and :func:`dcn_bwd_x`
(grad x), the bias gradient the sum of the cotangent. As the JAX package's
``_bwd`` does, each gradient comes back in its input's type: grad_offset
fp32, grad_x, grad_mask, grad_weight and grad_bias in the type of x, mask,
weight and bias (the backward kernels compute in fp32 and write fp32; the
wrappers cast).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import cuda_build
from .dcn import deform_conv2d_clamped, dcn_bwd_pom_plain, dcn_bwd_x_plain

_KERNELS = {torch.float32: "dcn_fwd_f32", torch.bfloat16: "dcn_fwd_bf16"}
_BWD_POM_KERNELS = {torch.float32: "dcn_bwd_pom_f32", torch.bfloat16: "dcn_bwd_pom_bf16"}
_BWD_X_KERNELS = {torch.float32: "dcn_bwd_x_f32", torch.bfloat16: "dcn_bwd_x_bf16"}


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
    """The backward kernels take x, mask, weight and g all fp32 or all bf16
    (the types of the port's fp32 and bf16 training), offsets fp32."""
    if x.dtype not in _BWD_POM_KERNELS:
        raise TypeError(f"x must be float32 or bfloat16 for the backward kernels, got {x.dtype}")
    for name, t in (("offset", offset), ("mask", mask), ("weight", weight), ("g", g)):
        want = torch.float32 if name == "offset" else x.dtype
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} for the backward kernels with x {x.dtype}, "
                            f"got {t.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"x must be (B, H, W, Cin) and weight (3, 3, Cin, Cout), "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    _check_specs([("x", x, (B, H, W, Cin), x.dtype),
                  ("offset", offset, (B, H, W, 18), torch.float32),
                  ("mask", mask, (B, H, W, 9), x.dtype),
                  ("weight", weight, (3, 3, Cin, Cout), x.dtype),
                  ("g", g, (B, H, W, Cout), x.dtype)])


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


# The largest radius of K3 (MAX_R of csrc/dcn_bwd.cu). Its halo and source
# lists take 212 (2R + 11)^2 bytes of shared memory per block beside its
# static tiles: radius 9 is the largest whose block fits in the 232,448 bytes
# (227 KiB) an sm_90 block may have, the only target the library is built for.
BWD_X_MAX_RADIUS = 9


def _check_bwd_kernel(x, offset, weight, g, radius, max_radius=None) -> None:
    """What the backward kernels take beyond :func:`_check_bwd`: 16-byte
    vectors of x, g and W, offsets in 8-byte pairs, int32 pixel indices,
    and a radius of at least 0 (and at most ``max_radius``)."""
    _check_vectors(x, weight, g)
    if offset.data_ptr() % 8:
        raise ValueError("offset must start on an 8-byte boundary")
    if int(radius) < 0:
        raise ValueError(f"radius must be at least 0 for the backward kernels, got {radius}")
    if max_radius is not None and int(radius) > max_radius:
        raise ValueError(f"radius {radius}: the grad_x kernel (bwd_x_kernel) takes radius 0 to "
                         f"{max_radius}; beyond it its halo and source lists need more shared "
                         f"memory per block than the 232,448 bytes an sm_90 block may have")


def dcn_bwd_pom_fp32_out(x, offset, mask, weight, g, radius: int = 3):
    """K2 on CUDA tensors with its fp32 outputs as the kernels write them,
    before :func:`dcn_bwd_pom` casts grad_mask and grad_weight to their
    inputs' type (for comparing the bf16 kernels with the fp32 ones)."""
    _check_bwd(x, offset, mask, weight, g)
    if _device_of(x) != "cuda":
        raise ValueError("the backward kernels run on CUDA tensors")
    _check_bwd_kernel(x, offset, weight, g, radius)
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    splits = cuda_build.library().dcn_bwd_weight_splits(B, H, W, Cin, Cout)
    go = torch.empty((B, H, W, 18), dtype=torch.float32, device=x.device)
    gm = torch.empty((B, H, W, 9), dtype=torch.float32, device=x.device)
    gw = torch.empty((3, 3, Cin, Cout), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, 9 * Cin * Cout), dtype=torch.float32, device=x.device)
    name = _BWD_POM_KERNELS[x.dtype]
    _launch(name, x.device,
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), g.data_ptr(), weight.data_ptr(),
            go.data_ptr(), gm.data_ptr(), gw.data_ptr(), part.data_ptr(),
            B, H, W, Cin, Cout, int(radius), splits)
    dcn_bwd_pom.launches_by_kernel[name] += 1
    return go, gm, gw


def dcn_bwd_pom(
    x: torch.Tensor,  # (B, H, W, Cin) float32 or bfloat16
    offset: torch.Tensor,  # (B, H, W, 18) float32
    mask: torch.Tensor,  # (B, H, W, 9) x's type
    weight: torch.Tensor,  # (3, 3, Cin, Cout) x's type
    g: torch.Tensor,  # (B, H, W, Cout) x's type, the cotangent of the output
    radius: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (grad_offset, grad_mask, grad_weight) of the clamped deformable
    conv: grad_offset fp32, grad_mask and grad_weight in x's type.

    ``dcn_bwd_pom.launches_by_kernel`` counts the calls that launched the
    kernels by C entry point (``dcn_bwd_pom_f32``, ``dcn_bwd_pom_bf16``).
    """
    _check_bwd(x, offset, mask, weight, g)
    if _device_of(x) == "cpu":
        return dcn_bwd_pom_plain(x, offset, mask, weight, g, radius)
    go, gm, gw = dcn_bwd_pom_fp32_out(x, offset, mask, weight, g, radius)
    return go, gm.to(mask.dtype), gw.to(weight.dtype)


def dcn_bwd_x_fp32_out(x, offset, mask, weight, g, radius: int = 3):
    """K3 on CUDA tensors with its fp32 output as the kernel writes it,
    before :func:`dcn_bwd_x` casts it to x's type."""
    _check_bwd(x, offset, mask, weight, g)
    if _device_of(x) != "cuda":
        raise ValueError("the backward kernels run on CUDA tensors")
    _check_bwd_kernel(x, offset, weight, g, radius, BWD_X_MAX_RADIUS)
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    gx = torch.empty((B, H, W, Cin), dtype=torch.float32, device=x.device)
    name = _BWD_X_KERNELS[x.dtype]
    _launch(name, x.device, offset.data_ptr(), mask.data_ptr(), g.data_ptr(),
            weight.data_ptr(), gx.data_ptr(), B, H, W, Cin, Cout, int(radius))
    dcn_bwd_x.launches_by_kernel[name] += 1
    return gx


def dcn_bwd_x(
    x: torch.Tensor,  # (B, H, W, Cin) float32 or bfloat16; its shape, type and device count
    offset: torch.Tensor,  # (B, H, W, 18) float32
    mask: torch.Tensor,  # (B, H, W, 9) x's type
    weight: torch.Tensor,  # (3, 3, Cin, Cout) x's type
    g: torch.Tensor,  # (B, H, W, Cout) x's type
    radius: int = 3,
) -> torch.Tensor:
    """K3: grad_x of the clamped deformable conv, sum_k W_k G_k with G_k the
    transposed gather of mask * g over the source pixels each input pixel
    feeds; in x's type.

    ``dcn_bwd_x.launches_by_kernel`` counts the calls that launched the
    kernel by C entry point (``dcn_bwd_x_f32``, ``dcn_bwd_x_bf16``).
    """
    _check_bwd(x, offset, mask, weight, g)
    if _device_of(x) == "cpu":
        return dcn_bwd_x_plain(x, offset, mask, weight, g, radius)
    return dcn_bwd_x_fp32_out(x, offset, mask, weight, g, radius).to(x.dtype)


def reset_launch_counts() -> None:
    deform_conv2d.launches_by_kernel = dict.fromkeys(_KERNELS.values(), 0)
    dcn_bwd_pom.launches_by_kernel = dict.fromkeys(_BWD_POM_KERNELS.values(), 0)
    dcn_bwd_x.launches_by_kernel = dict.fromkeys(_BWD_X_KERNELS.values(), 0)


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
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(x, offset, mask, weight)
        return deform_conv2d(x, offset, mask, weight, bias, radius)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        g = g.contiguous()
        go, gm, gw = dcn_bwd_pom(x, offset, mask, weight, g, ctx.radius)
        gx = dcn_bwd_x(x, offset, mask, weight, g, ctx.radius)
        gb = None
        if ctx.bias_dtype is not None:  # summed in fp32, in the bias's type
            gb = g.sum((0, 1, 2), dtype=torch.float32).to(ctx.bias_dtype)
        return gx, go, gm, gw, gb, None
