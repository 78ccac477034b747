"""Kernels launched inside the program span ``train.loss`` (the loss after
the nets' forward pass), per traced step."""

from portbench.core import program_spans as ps
from portbench.core.trace import is_kernel


def read(win):
    jobs = ps.jobs(win, "train.step", traced=True)
    if not jobs:
        return None
    n = ps.launched_under(win, [s for _, job in jobs for s in job], "train.loss", is_kernel)
    return n / len(jobs) if n is not None else None
