"""The training step's share of the card's dense TF32 peak, the fastest
tensor-core rate an fp32 step may use: three times the forward's operations
per image (counted from shapes, dense heads; no recomputed work) times the
images per second of the run's untraced window, over 494.7 TFLOP/s."""

from portbench.harness.counts import TF32_FLOP_PER_S


def read(r):
    if r.kind != "train" or not r.device:
        return None
    return 100.0 * 3 * r.count.flops_per_image * r.images_per_s / TF32_FLOP_PER_S
