"""The decoder's bilinear upsampling fused with its skip add, through the
hand-written CUDA kernel, and its autograd.

The operator is the depthwise ``ConvTranspose2d(C, C, 2f, stride=f,
padding=f // 2, groups=C, bias=False)`` of ``models/layers.py::bilinear_up``
(f = 2 or 4), whose output the decoder adds to the finer level:
``out = up_f(x; w) + skip``. The kernel is ``dcd_tpu_torch/csrc/upsample.cu``
(``upsample_add_f32``, ``upsample_add_bf16``); its source note says how it is
laid out. It replaces no TPU kernel: the JAX package computes ``BilinearUp``
in XLA by its polyphase decomposition.

:func:`upsample_add` takes NCHW tensors, as the module does. A tensor on the
CPU goes to the plain version (:func:`upsample_add_plain`); a CUDA tensor
launches the kernel or raises. The kernel takes x and skip in fp32 or bf16
with channels-last memory (the wrapper copies a map in another layout into
it), C a multiple of 8 and 16-byte aligned pointers, and the fp32 weight of
the module as it is (cast to x's type inside the kernel, as
``weight.to(x.dtype)`` rounds it). It writes a channels-last output, so the
node DCN's move to NHWC after it stays a view.
``upsample_add.launches_by_kernel`` shows the launches by C entry point;
``dcn_cuda.reset_launch_counts`` zeroes them with the DCN kernels' counts
(both read ``utils/cuda_build.py``'s counts).

:class:`UpsampleAddFunction` is the autograd around it: grad_skip is the
cotangent, and grad_x and grad_weight come from the call autograd makes for
``F.conv_transpose2d`` (``aten.convolution_backward``), so the training step's
backward is the one it had.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import cuda_build

_KERNELS = {torch.float32: "upsample_add_f32", torch.bfloat16: "upsample_add_bf16"}
FACTORS = (2, 4)
# the kernel's block holds C / 8 threads of one pixel (csrc/upsample.cu,
# MAX_THREADS), and the cast weights of 4 f^2 taps in shared memory, at most
# the 232,448 bytes an sm_90 block may have
MAX_CHANNELS = 8 * 256
MAX_SHARED_BYTES = 232_448


def upsample_add_plain(x: torch.Tensor, weight: torch.Tensor, skip: torch.Tensor,
                       f: int) -> torch.Tensor:
    """``conv_transpose2d(x, weight.to(x.dtype)) + skip`` in x's type."""
    return F.conv_transpose2d(x, weight.to(x.dtype), None, f, f // 2, 0, x.shape[1]) + skip


def _check(x: torch.Tensor, weight: torch.Tensor, skip: torch.Tensor, f: int) -> None:
    """What the kernel takes; raises on anything else."""
    if x.dim() != 4 or x.dtype not in _KERNELS:
        raise TypeError(f"x must be (B, C, H, W) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    if f not in FACTORS:
        raise ValueError(f"the upsampling factor must be one of {FACTORS}, got {f}")
    B, C, H, W = x.shape
    if C % 8 or C > MAX_CHANNELS:
        raise ValueError(f"C must be a multiple of 8 up to {MAX_CHANNELS}, got {C}")
    if 4 * f * f * C * x.element_size() > MAX_SHARED_BYTES:
        raise ValueError(f"the weights of {C} channels at f={f} need more shared memory per block "
                         f"than the {MAX_SHARED_BYTES} bytes an sm_90 block may have")
    if tuple(weight.shape) != (C, 1, 2 * f, 2 * f) or weight.dtype != torch.float32 or \
            not weight.is_contiguous():
        raise ValueError(f"weight must be contiguous ({C}, 1, {2 * f}, {2 * f}) float32, "
                         f"got {tuple(weight.shape)} {weight.dtype}")
    if tuple(skip.shape) != (B, C, f * H, f * W) or skip.dtype != x.dtype:
        raise ValueError(f"skip must be {(B, C, f * H, f * W)} {x.dtype}, "
                         f"got {tuple(skip.shape)} {skip.dtype}")
    for name, t in (("x", x), ("weight", weight), ("skip", skip)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if name != "weight" and not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be channels-last (NHWC memory)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if B * f * H * f * W * C >= 2 ** 31:
        raise ValueError(f"the output must have fewer than 2^31 elements, got {B * f * H * f * W * C}")


def upsample_add(
    x: torch.Tensor,  # (B, C, H, W) float32 or bfloat16
    weight: torch.Tensor,  # (C, 1, 2f, 2f) float32, the module's parameter
    skip: torch.Tensor,  # (B, C, fH, fW) x's type
    f: int,
) -> torch.Tensor:
    """``up_f(x; weight) + skip`` in x's type; channels-last on CUDA.

    ``upsample_add.launches_by_kernel`` shows the kernel launches by C entry
    point (``upsample_add_f32``, ``upsample_add_bf16``).
    """
    if x.device.type == "cpu":
        return upsample_add_plain(x, weight, skip, f)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    # the kernel reads NHWC memory: on the main path the DCN blocks and the
    # trunk hand over channels-last maps and this is no copy; a map in NCHW
    # memory (the trunk's, from an input that was not NHWC) is copied
    x = x.contiguous(memory_format=torch.channels_last)
    skip = skip.contiguous(memory_format=torch.channels_last)
    _check(x, weight, skip, f)
    B, C, H, W = x.shape
    out = torch.empty((B, C, f * H, f * W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    name = _KERNELS[x.dtype]
    cuda_build.launch(name, x.device, x.data_ptr(), weight.data_ptr(), skip.data_ptr(),
                      out.data_ptr(), B, H, W, C, f)
    return out


upsample_add.launches_by_kernel = cuda_build.LaunchCounts(_KERNELS.values())


class UpsampleAddFunction(torch.autograd.Function):
    """``apply(x, weight, skip, f)``: :func:`upsample_add` with its backward.

    The forward saves x and the fp32 weight; the backward casts the weight to
    x's type, as the forward's kernel did, and returns grad_x and
    grad_weight from ``aten.convolution_backward`` of the transposed conv
    (grad_weight cast back to the parameter's type, as autograd of
    ``weight.to(x.dtype)`` casts it) and grad_skip = the cotangent.
    """

    @staticmethod
    def forward(ctx, x, weight, skip, f):
        ctx.f = f
        ctx.save_for_backward(x, weight)
        return upsample_add(x, weight, skip, f)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        f = ctx.f
        need_x, need_w, need_skip = ctx.needs_input_grad[:3]
        gx = gw = None
        if need_x or need_w:
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, weight.to(x.dtype), None, (f, f), (f // 2, f // 2), (1, 1), True, (0, 0),
                x.shape[1], [need_x, need_w, False])
            if gw is not None:
                gw = gw.to(weight.dtype)
        return gx, gw, g if need_skip else None, None
