"""The deformable convolution's backward kernels (K2: ``bwd_pom_kernel``,
``bwd_weight_kernel``, ``bwd_weight_reduce_kernel``; K3: ``bwd_x_kernel``)
against their roofline: the sum over the profiled steps of the least times
of both backward functions at each deformable convolution's shape and
precision, over the summed device time of the four kernels."""

from portbench.harness.counts import k2_k3_bound_ms

KERNELS = ("bwd_pom_kernel", "bwd_weight_kernel", "bwd_weight_reduce_kernel", "bwd_x_kernel")


def read(r):
    if r.kind != "train" or not r.device:
        return None
    ms = r.device_ms(cats=("kernel",), match=lambda name: any(k in name for k in KERNELS))
    if ms <= 0:
        return None
    bound = r.steps * sum(k2_k3_bound_ms(*shape, r.bf16) for shape in r.count.dcn_shapes)
    return 100.0 * bound / ms
