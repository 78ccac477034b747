"""LM iterations a job (the program counter ``ba.lm_iters`` of
`sfm/ba.py::ba_solve`), mean over the untraced jobs."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "sfm.job")
    return ps.mean(ps.counter(spans, "ba.lm_iters") for _, spans in jobs) if jobs else None
