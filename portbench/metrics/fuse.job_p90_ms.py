"""The 90th percentile of the untraced map jobs of a traced run, each from
its start to its `.bt` on disk: `map_job_p90_ms`, read per layer where the
host's drift between runs spreads it too widely for an end-to-end bound."""

from portbench.core.readers import job_p90_ms


def read(win):
    return job_p90_ms(win.untraced)
