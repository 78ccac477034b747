"""Device milliseconds of the kernels launched inside the program span
``psmnet.features`` (the forward's two feature towers, left and right),
per traced step."""

from portbench.core.span_device import ms_per_traced_step


def read(win):
    return ms_per_traced_step(win, "psmnet.features")
