"""Fusion's device stages against their roofline: the bytes the job's
shapes need, each counted once (depth in 4 B, world points out 12 B,
validity out 1 B, voxel keys out 12 B, sorted keys out 12 B, first-
occurrence mask out 1 B: 42 B a pixel) at 3.35 TB/s, over the device time
of every kernel launched under the spans around `fuse_arrays`, `voxelize`
and `unique_voxels`, in the profiled slice, in %."""

import math

from portbench.core.roofline import bound_seconds

_MOD = "tpu3drec_torch.pipelines.rgbd:"
SPANS = [_MOD + "fuse_arrays", _MOD + "voxelize", _MOD + "unique_voxels"]
BYTES_PER_PIXEL = 4 + 12 + 1 + 12 + 12 + 1


def read(win):
    if win.trace is None:
        return None
    spent = win.trace.kernel_seconds_under(["fuse_arrays", "voxelize", "unique_voxels"])
    calls = win.spans.traced_calls["fuse_arrays"]
    if not spent or not calls:
        return None
    need = sum(bound_seconds(0, BYTES_PER_PIXEL * math.prod(c[0]))[0] for c in calls)
    return 100.0 * need / spent
