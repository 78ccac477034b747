"""Host seconds a job of the SfM driver's verification and registration
stages (`Reconstruction.seconds`), mean over the untraced jobs."""


def read(win):
    jobs = win.untraced
    if not jobs:
        return None
    return sum(r["seconds"]["verify"] + r["seconds"]["register"] for r in jobs) / len(jobs)
