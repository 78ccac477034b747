"""Device milliseconds of the kernels launched inside the program span
``psmnet.regress`` (the forward's three trilinear upsamplings to full
resolution, softmaxes and regressions), per traced step."""

from portbench.core.span_device import ms_per_traced_step


def read(win):
    return ms_per_traced_step(win, "psmnet.regress")
