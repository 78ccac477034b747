"""Readers that several metrics share; each metric's own file re-exports
the one it reads, so a later cell family adds a file and no copy."""

from __future__ import annotations

import statistics


def work_rate(win):
    """All the work of the window's completed jobs over all its time."""
    return win.work_rate()


def idle_share(win):
    """The device's idle share of the profiled slice: 1 - the union of its
    operations' intervals over the slice's wall time, in %."""
    t = win.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def launches_per_job(win):
    """Kernel launches on the device in the profiled slice, per job."""
    t = win.trace
    return t.launches / t.jobs if t is not None and t.device else None


def job_p90_ms(jobs):
    """The 90th percentile of ``jobs``' times, each from its start to its
    end (``statistics.quantiles``, inclusive method), in ms; None under ten
    jobs."""
    ms = [(r["t1"] - r["t0"]) * 1e3 for r in jobs]
    if len(ms) < 10:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[-1]
