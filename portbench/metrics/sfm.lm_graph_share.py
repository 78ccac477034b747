"""Share of LM iterations run as a replay of a captured CUDA graph: the
untraced jobs' program counter ``ba.graph_replays`` over their
``ba.lm_iters`` (`sfm/ba.py::ba_solve`), in %. None against a program that
does not count replays."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "sfm.job")
    spans = [s for _, job in jobs or () for s in job]
    if not any("ba.graph_replays" in (s.counters or {}) for s in spans):
        return None
    iters = ps.counter(spans, "ba.lm_iters")
    return 100.0 * ps.counter(spans, "ba.graph_replays") / iters if iters else None
