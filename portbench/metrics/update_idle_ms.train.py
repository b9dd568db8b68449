"""Idle ms of the card per traced step while the host is inside the
program's ``dcd.train.grad_norm`` or ``dcd.optimizer`` spans (the two global
norms, the clip and AdamW): the traced window less the union of the card's
kernels, copies and memsets, as ``device.busy_s`` takes it, within those
spans. It is read in the traced window, whose host the profiler slows, so it
is larger than the same gap in an untraced step."""

from portbench.harness.spans import idle_ms_under, present

SPANS = ("dcd.train.grad_norm", "dcd.optimizer")


def read(r):
    if not present(r, "train", SPANS):
        return None
    return idle_ms_under(r, SPANS) / r.steps
