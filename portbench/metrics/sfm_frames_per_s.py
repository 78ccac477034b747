"""Frames registered by the window's completed SfM jobs, over the time from
the window's start to the last of them ending."""

from portbench.core.readers import work_rate as read  # noqa: F401
