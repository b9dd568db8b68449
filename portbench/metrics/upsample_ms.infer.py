"""Device ms per batch launched under the program's ``dcd.upsample`` spans
(``models/dla.py::IDAUp``: the transposed conv of each of the decoder's 8
upsampling layers). It reads the program's layer, not a kernel's name, so it
holds when the transposed conv's kernel is replaced."""

from portbench.harness.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "infer", ("dcd.upsample",))
