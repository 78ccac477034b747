"""Share of the map jobs' copies back that landed in page-locked host
memory: the untraced jobs' program counter ``bytes_to_host_pinned`` over
the ``bytes_to_host`` of their ``map.to_host`` spans
(`pipelines/rgbd.py::_to_host`), in %. None against a program that does
not count pinned bytes."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "map.job")
    spans = [s for _, job in jobs or () for s in job if s.name == "map.to_host"]
    if not any("bytes_to_host_pinned" in (s.counters or {}) for s in spans):
        return None
    total = ps.counter(spans, "bytes_to_host")
    return 100.0 * ps.counter(spans, "bytes_to_host_pinned") / total if total else None
