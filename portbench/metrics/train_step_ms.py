"""The whole window, up to the device finishing its last step, over the
training steps taken in it."""


def read(win):
    return win.t_end / len(win.done) * 1e3 if win.done else None
