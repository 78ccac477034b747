"""Milliseconds an LM iteration: the untraced jobs' ``ba.solve`` seconds
over their ``ba.lm_iters``."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "sfm.job")
    iters = sum(ps.counter(spans, "ba.lm_iters") for _, spans in jobs or ())
    if not iters:
        return None
    return 1e3 * sum(ps.seconds(spans, "ba.solve") for _, spans in jobs) / iters
