"""Device-to-host copies (``Memcpy DtoH`` in the device trace) launched inside
the program span ``sfm.register.frame``, nested bundle adjustment included,
per frame tried, over the traced jobs."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "sfm.job", traced=True)
    spans = [s for _, job in jobs or () for s in job]
    frames = sum(1 for s in spans if s.name == "sfm.register.frame")
    n = ps.launched_under(win, spans, "sfm.register.frame", ps.is_host_read)
    return n / frames if n is not None and frames else None
