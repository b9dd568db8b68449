"""Device ms per batch under the decoder's span (``portbench.decoder``)."""

SPAN = "portbench.decoder"


def read(r):
    if r.kind != "infer" or not r.device or SPAN not in r.spans:
        return None
    return r.device_ms(within=SPAN) / r.steps
