"""Kernel launches on the device in the profiled slice, per training step."""

from portbench.core.readers import launches_per_job as read  # noqa: F401
