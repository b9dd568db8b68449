"""Modulated deformable convolution (DCNv2), plain PyTorch versions, NHWC.

Two forms of the same function, the counterparts of the JAX package's two
XLA forms (``dcd_tpu/ops/dcn.py``):

* :func:`deform_conv2d_clamped` clips every offset to ``[-radius, radius]``
  first. It is the function that the TPU kernel computed
  (``deform_conv2d_dense`` and ``dcn_pallas.deform_conv2d_pallas``) and that
  the port's CUDA kernel (:mod:`dcd_tpu_torch.ops.dcn_cuda`) is held to.
* :func:`deform_conv2d_gather` samples where the offsets point, unbounded,
  as ``deform_conv2d`` and the reference's CUDA extension do.

For output pixel p and kernel tap k at (i, j)::

    s_k(p)   = bilinear(x, p*stride - pad + (i, j)*dilation + off_k(p))
    out(p)   = sum_k W_k^T (mask_k(p) * s_k(p)) + bias

with zero padding per bilinear corner outside the image. Offsets are
interleaved per tap, ``off[..., 2k] = dy`` and ``off[..., 2k+1] = dx``.

:func:`dcn_bwd_pom_plain` and :func:`dcn_bwd_x_plain` are the backward of
the clamped form by autograd: the plain versions of the backward kernels.

Both forms are written as gathers (one ``index_select`` per bilinear corner)
rather than as the TPU's static window walk, which existed only because
gathers were slow there. The sample positions are split into an integer
part and a fraction of the offset itself (``dy - floor(dy)``), as the TPU
form does, so that the fraction keeps full precision far from the origin.
Sampling and the product's sums are fp32 whatever the input type; the
samples are rounded once to the input type before the product, and the
output takes ``x``'s type.
"""

from __future__ import annotations

from typing import Optional

import torch


def _deform_conv2d(
    x: torch.Tensor,  # (B, H, W, Cin)
    offset: torch.Tensor,  # (B, Ho, Wo, 2K)
    mask: torch.Tensor,  # (B, Ho, Wo, K)
    weight: torch.Tensor,  # (kh, kw, Cin, Cout)
    bias: Optional[torch.Tensor],  # (Cout,)
    stride: int,
    padding: int,
    dilation: int,
    radius: Optional[float],
) -> torch.Tensor:
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = weight.shape
    K = kh * kw
    Ho, Wo = offset.shape[1], offset.shape[2]
    dev = x.device
    xf = x.float().reshape(B * H * W, Cin)

    off = offset.float().reshape(B, Ho, Wo, K, 2)
    if radius is not None:
        off = off.clamp(-radius, radius)
    # a tap whose dy or dx is NaN is dropped, as the JAX forms and the TPU
    # kernel drop it; its offsets become 0 so that every index and
    # coefficient stays finite (and so does every gradient)
    drop = off.isnan().any(-1)  # (B, Ho, Wo, K)
    off = torch.where(drop[..., None], torch.zeros_like(off), off)
    iy = torch.floor(off[..., 0])
    ix = torch.floor(off[..., 1])
    fy = off[..., 0] - iy  # weight of the lower-right corner row
    fx = off[..., 1] - ix

    taps = torch.arange(K, device=dev)
    tap_y = (taps // kw) * dilation - padding  # (K,)
    tap_x = (taps % kw) * dilation - padding
    row = (torch.arange(Ho, device=dev) * stride).view(1, Ho, 1, 1)
    col = (torch.arange(Wo, device=dev) * stride).view(1, 1, Wo, 1)
    y0 = row + tap_y + iy.long()  # (B, Ho, Wo, K)
    x0 = col + tap_x + ix.long()
    img = (torch.arange(B, device=dev) * (H * W)).view(B, 1, 1, 1)
    m = mask.float()

    sampled = None
    for dy, dx, wgt in (
        (0, 0, (1 - fy) * (1 - fx)),
        (0, 1, (1 - fy) * fx),
        (1, 0, fy * (1 - fx)),
        (1, 1, fy * fx),
    ):
        yc = y0 + dy
        xc = x0 + dx
        valid = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W) & ~drop
        idx = img + yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)
        coef = torch.where(valid, wgt * m, torch.zeros_like(wgt))
        vals = xf.index_select(0, idx.reshape(-1)).view(B, Ho, Wo, K, Cin)
        term = vals * coef[..., None]
        sampled = term if sampled is None else sampled + term

    # the samples are rounded to the input type before the product, as the
    # JAX forms cast them to the compute type and the TPU kernel rounds its
    # walk to the weight type before the MXU (a no-op in fp32); the product
    # sums in fp32
    sampled = sampled.to(x.dtype).float()
    out = sampled.reshape(B * Ho * Wo, K * Cin) @ weight.float().reshape(K * Cin, Cout)
    if bias is not None:
        out = out + bias.float()
    return out.view(B, Ho, Wo, Cout).to(x.dtype)


def deform_conv2d_clamped(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    radius: float = 3,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """Deformable conv with offsets clipped to ``[-radius, radius]``.

    The counterpart of ``dcd_tpu.ops.dcn.deform_conv2d_dense``: equal to
    :func:`deform_conv2d_gather` wherever ``|offset| <= radius``.
    """
    return _deform_conv2d(x, offset, mask, weight, bias, stride, padding, dilation, radius)


def deform_conv2d_gather(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """Deformable conv with unbounded offsets, the counterpart of
    ``dcd_tpu.ops.dcn.deform_conv2d``."""
    return _deform_conv2d(x, offset, mask, weight, bias, stride, padding, dilation, None)


def _plain_vjp(x, offset, mask, weight, g, radius, wrt):
    """``torch.autograd.grad`` of :func:`deform_conv2d_clamped` (no bias) at
    cotangent ``g``, with respect to the arguments named in ``wrt``, taken
    in fp32 on the inputs widened to fp32 (as the backward kernels and the
    JAX package's Pallas backward walk and sum in fp32 whatever the input
    type), each gradient then cast to its input's type (as the JAX
    package's ``_bwd`` casts them)."""
    args = {"x": x, "offset": offset, "mask": mask, "weight": weight}
    with torch.enable_grad():
        leaves = {k: v.detach().float().requires_grad_(k in wrt) for k, v in args.items()}
        out = deform_conv2d_clamped(leaves["x"], leaves["offset"], leaves["mask"],
                                    leaves["weight"], None, radius)
        grads = torch.autograd.grad(out, [leaves[k] for k in wrt], g.float())
    return tuple(gr.to(args[k].dtype) for k, gr in zip(wrt, grads))


def dcn_bwd_pom_plain(x, offset, mask, weight, g, radius: float = 3):
    """(grad_offset, grad_mask, grad_weight) of the clamped deformable conv
    at cotangent ``g``: the plain version of the K2 kernel, and the same
    oracle as the JAX package's ``BACKWARD = "xla"`` (autodiff of the
    clamped form). grad_offset is zero where the clamp is active. Each
    gradient in its input's type, computed in fp32."""
    return _plain_vjp(x, offset, mask, weight, g, radius, ("offset", "mask", "weight"))


def dcn_bwd_x_plain(x, offset, mask, weight, g, radius: float = 3):
    """grad_x of the clamped deformable conv at cotangent ``g``: the plain
    version of the K3 kernel, computed in fp32, in x's type."""
    return _plain_vjp(x, offset, mask, weight, g, radius, ("x",))[0]
