"""Device ms per step under ``torch.optim.AdamW.step``'s own profiler range
(the optimizer's update; the gradient clip before it is not in it)."""

ADAMW = "Optimizer.step#AdamW.step"


def read(r):
    if r.kind != "train" or not r.device or ADAMW not in r.spans:
        return None
    return r.device_ms(within=ADAMW) / r.steps
