"""Seconds a job of bundle adjustment outside its LM loop: the program span
``sfm.ba`` (a `_run_ba` call: the observation arrays' assembly, the read
back, the outlier filter and the re-triangulation) less its ``ba.solve``,
mean over the untraced jobs."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "sfm.job")
    if not jobs:
        return None
    return ps.mean(ps.self_seconds(spans, "sfm.ba", "ba.solve") for _, spans in jobs)
