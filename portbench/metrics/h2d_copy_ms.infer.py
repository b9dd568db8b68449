"""Device ms per batch of host-to-device copies inside the ``infer`` call
(the frames arrive in pinned host memory, as a loader hands them)."""


def read(r):
    if r.kind != "infer" or not r.device:
        return None
    ms = r.device_ms(cats=("gpu_memcpy",), match=lambda name: "HtoD" in name)
    return ms / r.steps if ms > 0 else None
