"""Device ms per step launched under the program's ``dcd.train.forward``
span (``engine/train.py::compute_gradients``: the detector's train-mode
forward)."""

from portbench.harness.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "train", ("dcd.train.forward",))
