"""Device ms per step launched under the program's ``dcd.train.loss`` span
(``engine/loss.py::compute_losses`` on the forward's outputs)."""

from portbench.harness.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "train", ("dcd.train.loss",))
