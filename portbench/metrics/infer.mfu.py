"""Depth inference's share of the card's float32 peak: the depth net's
forward operations for the frames of each `infer_depth_maps` call, counted
from the published architecture (`references/monodepth2.py`), over the
host seconds of those calls (they end with the depth on the host) and 67
TFLOP/s, over the untraced jobs, in %."""

from portbench.core.roofline import FLOPS_F32
from portbench.references.monodepth2 import depth_forward_flops

SPANS = ["tpu3drec_torch.pipelines.monocular:infer_depth_maps"]


def read(win):
    if win.spans is None:
        return None
    secs, calls = win.spans.seconds["infer_depth_maps"], win.spans.calls["infer_depth_maps"]
    if not secs:
        return None
    flops = sum(depth_forward_flops(*c[1][:3]) for c in calls)
    return 100.0 * flops / sum(secs) / FLOPS_F32
