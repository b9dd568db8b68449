"""Kernel launch calls of the host per step inside the program's
``dcd.train_step`` span (``cudaLaunchKernel*`` and ``cuLaunchKernel*`` on
any thread, the backward's device thread too). A count: the profiler's
slowing of the host does not move it."""

from portbench.harness.spans import launch_calls, present

SPAN = "dcd.train_step"


def read(r):
    if not present(r, "train", (SPAN,)):
        return None
    return launch_calls(r, SPAN) / r.steps
