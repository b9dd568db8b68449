"""Device ms per batch under the heads's span (``portbench.heads``)."""

SPAN = "portbench.heads"


def read(r):
    if r.kind != "infer" or not r.device or SPAN not in r.spans:
        return None
    return r.device_ms(within=SPAN) / r.steps
