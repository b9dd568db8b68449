"""The inference step's share of the card's dense bf16 peak: the model's
operations per image (counted from shapes: convolutions, the transposed
convolution, the deformable convolutions' contraction and sampling, the
heads; no postprocess) times the images per second of the run's untraced
window, over 989 TFLOP/s."""

from portbench.harness.counts import BF16_FLOP_PER_S


def read(r):
    if r.kind != "infer" or not r.device:
        return None
    return 100.0 * r.count.flops_per_image * r.images_per_s / BF16_FLOP_PER_S
