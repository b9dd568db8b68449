"""Share of the untraced window in which the card was idle: one less the
card's busy seconds per profiled step (a kernel, copy or memset running:
the union of their intervals) times the steps per second of the run's
untraced window. The profiler slows the host's side of a step and not the
card's work, so the busy seconds carry over, where the profiled window's
own idle share would read the profiler's cost."""


def read(r):
    if r.kind != "train" or not r.device or r.steps <= 0 or r.images_per_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.steps * r.images_per_s / r.batch)
