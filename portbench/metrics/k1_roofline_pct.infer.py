"""The deformable convolution's forward kernel (K1, ``dcn_fwd_kernel``)
against its roofline: the sum over the profiled launches of the least time
at each launch's shape and precision (bytes read and written once at 3.35
TB/s, or the contraction and sampling at the dense rates), over the summed
device time of the kernel."""

from portbench.harness.counts import k1_bound_ms

KERNEL = "dcn_fwd_kernel"


def read(r):
    if r.kind != "infer" or not r.device:
        return None
    ms = r.device_ms(cats=("kernel",), match=lambda name: KERNEL in name)
    if ms <= 0:
        return None
    bound = r.steps * sum(k1_bound_ms(*shape, r.bf16) for shape in r.count.dcn_shapes)
    return 100.0 * bound / ms
