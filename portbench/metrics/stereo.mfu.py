"""The stereo training step's share of the card's float32 peak: both
towers and the 3D part, forward and backward (three times forward), counted
from the published architecture (`references/psmnet.py`), over the
untraced part of the window and 67 TFLOP/s, in %."""

from portbench.core.roofline import FLOPS_F32
from portbench.references.psmnet import train_step_flops


def read(win):
    jobs = win.untraced
    if not jobs or win.untraced_s <= 0:
        return None
    c = win.entry.ctx.config
    flops = sum(train_step_flops(r["work"], c["height"], c["width"], c["max_disp"],
                                 tuple(c["spp_pools"])) for r in jobs)
    return 100.0 * flops / win.untraced_s / FLOPS_F32
