"""The training step's share of the card's float32 peak: the depth net on
the targets and the pose net on two pairs, forward and backward (three
times forward), counted from the published architecture
(`references/monodepth2.py`), over the untraced part of the window and 67
TFLOP/s, in %."""

from portbench.core.roofline import FLOPS_F32
from portbench.references.monodepth2 import train_step_flops


def read(win):
    jobs = win.untraced
    if not jobs or win.untraced_s <= 0:
        return None
    c = win.entry.ctx.config
    flops = sum(train_step_flops(r["work"], c["height"], c["width"]) for r in jobs)
    return 100.0 * flops / win.untraced_s / FLOPS_F32
