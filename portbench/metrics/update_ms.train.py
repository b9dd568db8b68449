"""Device ms per step launched under the program's ``dcd.train.grad_norm``
and ``dcd.optimizer`` spans: the logs' global norm, the clip's (a second
norm and the scaling) and AdamW's update."""

from portbench.harness.spans import device_ms_per_step

SPANS = ("dcd.train.grad_norm", "dcd.optimizer")


def read(r):
    return device_ms_per_step(r, "train", SPANS)
