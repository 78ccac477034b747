"""Milliseconds a map job in copies back to the host: the program spans
``map.to_host`` (`pipelines/rgbd.py`) and ``infer.to_host``
(`pipelines/monocular.py`), each also waiting for the device work before
its copy, mean over the untraced jobs."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "map.job", "infer.depth")
    if not jobs:
        return None
    return 1e3 * ps.mean(ps.seconds(spans, "map.to_host") + ps.seconds(spans, "infer.to_host")
                         for _, spans in jobs)
