"""Kernel launches on the device in the profiled slice, per SfM job."""

from portbench.core.readers import launches_per_job as read  # noqa: F401
