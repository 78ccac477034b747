"""Seconds a job in bundle adjustment's LM loop (the program span
``ba.solve`` in `sfm/ba.py::ba_solve`), mean over the untraced jobs."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "sfm.job")
    return ps.mean(ps.seconds(spans, "ba.solve") for _, spans in jobs) if jobs else None
