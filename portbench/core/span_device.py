"""Device time under a program span: the summed device seconds of the
profiled slice's kernels whose launching call lies inside a span of that
name (a kernel by its own start and end, so kernels that overlap count
each). Backward kernels launch from autograd's own thread, so a kernel is
placed by the time of its launch, as `program_spans.launched_under` does."""

from __future__ import annotations

import bisect

from portbench.core import program_spans as ps
from portbench.core.trace import is_kernel, merge


def kernel_seconds_under(win, spans, name: str) -> float | None:
    """Device seconds of the kernels launched inside a span named ``name``
    of ``spans``; None without a trace or without such a span."""
    t = win.trace
    if t is None or not t.device:
        return None
    ivs = merge((s.t0, s.t1) for s in spans if s.name == name)
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    total = 0
    for s, e, op, corr in t.device:
        at = t.runtime.get(corr)
        if at is None or not is_kernel(op):
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= ivs[i][1]:
            total += e - s
    return total * 1e-9


def ms_per_traced_step(win, name: str) -> float | None:
    """`kernel_seconds_under` the ``train.step`` jobs' spans named
    ``name``, in ms per traced step."""
    jobs = ps.jobs(win, "train.step", traced=True)
    if not jobs:
        return None
    s = kernel_seconds_under(win, [s for _, job in jobs for s in job], name)
    return 1e3 * s / len(jobs) if s is not None else None
