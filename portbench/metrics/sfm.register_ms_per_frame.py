"""Milliseconds a frame tried by the SfM registration loop (the program span
``sfm.register.frame``: 2D-3D gathering, PnP, triangulation), less the
bundle adjustment nested in it (``sfm.ba``), over the untraced jobs."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "sfm.job")
    frames = sum(1 for _, spans in jobs or () for s in spans if s.name == "sfm.register.frame")
    if not frames:
        return None
    return 1e3 * sum(ps.self_seconds(spans, "sfm.register.frame", "sfm.ba")
                     for _, spans in jobs) / frames
