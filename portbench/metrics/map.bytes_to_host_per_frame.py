"""Bytes copied from the device to the host a frame (the program counter
``bytes_to_host`` of the map and depth-inference jobs), over the untraced
jobs' frames."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "map.job", "infer.depth")
    frames = sum(r["work"] for r, _ in jobs or ())
    if not frames:
        return None
    return sum(ps.counter(spans, "bytes_to_host") for _, spans in jobs) / frames
