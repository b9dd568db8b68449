"""Device ms per batch launched under the program's ``dcd.dcn`` spans
(``models/layers.py::DCN``: each deformable block's offset conv, the
sigmoid of its mask and the deformable conv, K1; 16 a forward, 18 with the
deeper head's stems)."""

from portbench.harness.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "infer", ("dcd.dcn",))
