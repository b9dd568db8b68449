"""Device ms per batch inside the ``infer`` call and outside the detector's
forward (postprocess: NMS, top-K, the row decode), copies apart."""

MODEL = "portbench.model"


def read(r):
    if r.kind != "infer" or not r.device or MODEL not in r.spans:
        return None
    return r.device_ms(outside=(MODEL,), cats=("kernel", "gpu_memset")) / r.steps
