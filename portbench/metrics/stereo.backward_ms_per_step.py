"""Device milliseconds of the kernels launched inside the program span
``train.backward`` of the stereo step (autograd's backward of both towers,
the 3D part and the heads, launched from autograd's own thread while the
span is open), per traced step."""

from portbench.core.span_device import ms_per_traced_step


def read(win):
    return ms_per_traced_step(win, "train.backward")
