"""Kernels launched inside the program spans ``train.optimizer`` (the
gradients' reset, the learning rate and Adam's update), per traced step."""

from portbench.core import program_spans as ps
from portbench.core.trace import is_kernel


def read(win):
    jobs = ps.jobs(win, "train.step", traced=True)
    if not jobs:
        return None
    n = ps.launched_under(win, [s for _, job in jobs for s in job], "train.optimizer", is_kernel)
    return n / len(jobs) if n is not None else None
