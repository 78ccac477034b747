"""Bytes of the cost volume and of the full-resolution volumes that the
forward makes (counter ``psmnet.volume_bytes`` of
`models/psmnet.py::StackHourglassPSMNet`, from their shapes), mean over the
untraced steps; None where the program counts none."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "train.step")
    if not jobs:
        return None
    counts = [ps.counter(spans, "psmnet.volume_bytes") for _, spans in jobs]
    return ps.mean(counts) if any(counts) else None
