"""Seconds from process start to the first timed job: imports, the
kernels' load (or their build in a fresh checkout), the inputs, the
weights and the warm-up."""


def read(win):
    return win.setup_s
