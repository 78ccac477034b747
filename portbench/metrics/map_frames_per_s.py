"""Depth frames fused into a map whose `.bt` was written, over the time from
the window's start to the last map job ending."""

from portbench.core.readers import work_rate as read  # noqa: F401
