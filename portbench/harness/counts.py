"""Operations and bytes counted from shapes, the bounds of the deformable
convolution's kernels, and the card's published peaks.

The counts are of the algorithm's own work at the shapes a forward runs,
whatever implements it: each input byte read once, each output byte written
once. A convolution is 2 * (output elements) * (Cin / groups) * kh * kw
operations, a transposed convolution 2 * (input elements) * (Cout / groups)
* kh * kw, a deformable convolution its contraction, 2 * 9 * Cin * Cout per
output pixel, plus its bilinear sampling, 4 FMAs (8 operations) per tap and
input channel; its offset conv is a convolution. They are read off the
reference detector run on the meta device at the run's batch, with forward
hooks, so no memory is touched.

The bounds of the deformable convolution's kernels are frozen copies of the
program's smoke script's arithmetic: the least time is the larger of the
bytes over HBM and the operations (fp32 contractions on the tensor cores as
three TF32 passes, the sampling at the fp32 rate outside them; bf16 all on
the tensor cores).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

from ..reference import config as ref_config
from ..reference.layers import DCN, Conv1d, Conv2d, ConvTranspose2d
from ..reference.predictor import KeypointDetector

# NVIDIA H100 SXM, dense, without sparsity (NVIDIA's data sheet), at the
# card's full power limit of 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 494.7e12
BF16_FLOP_PER_S = 989e12
TF32X3_FLOP_PER_S = TF32_FLOP_PER_S / 3


@dataclass
class ForwardCount:
    """One forward at ``batch``: operations by kind and the deformable
    convolutions' shapes (B, H, W, Cin, Cout) in forward order."""

    batch: int
    flops: Dict[str, float] = field(default_factory=dict)
    dcn_shapes: List[Tuple[int, int, int, int, int]] = field(default_factory=list)

    @property
    def flops_per_image(self) -> float:
        return sum(self.flops.values()) / self.batch


def _add(count: ForwardCount, kind: str, n: float) -> None:
    count.flops[kind] = count.flops.get(kind, 0.0) + float(n)


@torch.no_grad()
def count_modules(model: torch.nn.Module, run: Callable[[], object], batch: int) -> ForwardCount:
    """Operations of ``run()``, a forward of ``model`` (its convolutions and
    deformable convolutions, hooked) at ``batch``."""
    count = ForwardCount(batch)

    def conv(mod, inp, out):
        _add(count, "conv", 2 * out.numel() * mod.weight[0].numel())

    def convt(mod, inp, out):  # weight (Cin, Cout / groups, kh, kw)
        _add(count, "conv_transpose", 2 * inp[0].numel() * mod.weight[0].numel())

    def dcn(mod, inp, out):
        B, cin, H, W = inp[0].shape
        cout = out.shape[1]
        p = B * H * W
        _add(count, "dcn_contraction", 2 * p * 9 * cin * cout)
        _add(count, "dcn_sampling", 8 * p * 9 * cin)
        count.dcn_shapes.append((B, H, W, cin, cout))

    hooks = []
    for m in model.modules():
        if isinstance(m, (Conv2d, Conv1d)):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, ConvTranspose2d):
            hooks.append(m.register_forward_hook(convt))
        elif isinstance(m, DCN):
            hooks.append(m.register_forward_hook(dcn))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return count


def count_forward(tree, batch: int, lazy: bool) -> ForwardCount:
    """Operations of one forward of the detector of ``tree`` at ``batch``
    (``lazy``: the regression heads on the top-K peaks' neighbourhoods, as
    inference runs them; else dense, as training does), on the meta
    device."""
    cfg = ref_config.load(tree)
    with torch.device("meta"):
        model = KeypointDetector(cfg).eval()
    H, W = cfg.input.height_train, cfg.input.width_train
    L = cfg.max_edge_length
    images = torch.empty((batch, H, W, 3), device="meta")
    edges = torch.zeros((batch, L, 2), dtype=torch.int64, device="meta")
    edge_len = torch.zeros((batch,), dtype=torch.int64, device="meta")
    return count_modules(model, lambda: model(images, edges, edge_len, lazy_topk=lazy), batch)


def roofline_ms(nbytes: float, contraction: float, sampling: float,
                contraction_flop_per_s: float) -> float:
    """The larger of the bytes over HBM and the operations (the contraction
    at ``contraction_flop_per_s``, the sampling at the fp32 rate), in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = contraction / contraction_flop_per_s + sampling / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops)


def k1_work(batch: int, h: int, w: int, cin: int, cout: int, bf16: bool) -> Tuple[int, int, int]:
    """(bytes, contraction, sampling operations) of the forward kernel at
    this shape: x, offsets (fp32), mask and weight read once, bias read and
    the output written once; the contraction and 4 FMAs per sampled tap and
    input channel."""
    p = batch * h * w
    size = 2 if bf16 else 4
    nbytes = 4 * p * 18 + size * (p * (cin + 9 + cout) + 9 * cin * cout + cout)
    return nbytes, 2 * p * 9 * cin * cout, 8 * p * 9 * cin


def k1_bound_ms(batch: int, h: int, w: int, cin: int, cout: int, bf16: bool) -> float:
    """Least time of the forward kernel at this shape (:func:`k1_work`)."""
    nbytes, contraction, sampling = k1_work(batch, h, w, cin, cout, bf16)
    if bf16:
        return roofline_ms(nbytes, contraction + sampling, 0, BF16_FLOP_PER_S)
    return roofline_ms(nbytes, contraction, sampling, TF32X3_FLOP_PER_S)


def k2_k3_bound_ms(batch: int, h: int, w: int, cin: int, cout: int, bf16: bool) -> float:
    """Least time of the two backward functions together at this shape: K2
    (grad offset, mask and weight: two contractions and 22 operations per
    pixel, tap and input channel of sampling, derivatives and products) and
    K3 (grad x: one contraction and 8 per pixel, tap and output channel for
    the four corners' scatter); offsets and grad_offset fp32, the rest in
    the inputs' type."""
    p = batch * h * w
    contraction = 2 * p * 9 * cin * cout
    if bf16:
        k2 = roofline_ms(2 * (p * (cin + 9 + cout) + 9 * cin * cout) + 4 * p * 18 + 4 * p * 18
                         + 2 * (p * 9 + 9 * cin * cout), 2 * contraction, (21 + 1) * p * 9 * cin,
                         BF16_FLOP_PER_S)
        k3 = roofline_ms(4 * p * 18 + 2 * (p * (9 + cout) + 9 * cin * cout + p * cin),
                         contraction, 8 * p * 9 * cout, BF16_FLOP_PER_S)
        return k2 + k3
    k2 = roofline_ms(4 * (p * (cin + 18 + 9 + cout) + 9 * cin * cout + p * (18 + 9)
                          + 9 * cin * cout), 2 * contraction, (21 + 1) * p * 9 * cin,
                     TF32X3_FLOP_PER_S)
    k3 = roofline_ms(4 * (p * (18 + 9 + cout) + 9 * cin * cout + p * cin), contraction,
                     8 * p * 9 * cout, TF32X3_FLOP_PER_S)
    return k2 + k3
