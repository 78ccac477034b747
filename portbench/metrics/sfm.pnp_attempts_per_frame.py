"""PnP registration ladders a registered frame (the program counter
``sfm.pnp.attempts``, one a `_try_pnp` call, each drawing 2,048 RANSAC
hypotheses a gate), over the frames the untraced jobs registered."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "sfm.job")
    frames = sum(r["work"] for r, _ in jobs or ())
    if not frames:
        return None
    return sum(ps.counter(spans, "sfm.pnp.attempts") for _, spans in jobs) / frames
