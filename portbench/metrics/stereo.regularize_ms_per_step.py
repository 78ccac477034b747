"""Device milliseconds of the kernels launched inside the program span
``psmnet.regularize`` (the forward's dres0/dres1, three hourglasses and
classifiers), per traced step."""

from portbench.core.span_device import ms_per_traced_step


def read(win):
    return ms_per_traced_step(win, "psmnet.regularize")
