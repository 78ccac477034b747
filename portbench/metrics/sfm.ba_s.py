"""Host seconds a job of bundle adjustment (`Reconstruction.seconds["ba"]`),
mean over the untraced jobs."""


def read(win):
    jobs = win.untraced
    return sum(r["seconds"]["ba"] for r in jobs) / len(jobs) if jobs else None
