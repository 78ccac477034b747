"""The 90th percentile of the window's map jobs, each from its start to its
`.bt` on disk (``statistics.quantiles``, inclusive method)."""

from portbench.core.readers import job_p90_ms


def read(win):
    return job_p90_ms(win.done)
