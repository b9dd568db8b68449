"""Device ms per step launched under the program's ``dcd.train.backward``
span: the backward of the loss through the detector, K2 and K3 among it.
Autograd launches these kernels from its device thread while the calling
thread waits in the span; the launch time puts them in it."""

from portbench.harness.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "train", ("dcd.train.backward",))
