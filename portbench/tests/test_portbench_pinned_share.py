"""The reader of ``map.pinned_to_host_share``
(`portbench/metrics/map.pinned_to_host_share.py`) on made-up windows: the
untraced map jobs' bytes copied back into page-locked memory over all the
bytes of their ``map.to_host`` spans, and None against a program that has
no tracer or does not count pinned bytes."""

from __future__ import annotations

import pytest

from portbench.core import program_spans as ps
from portbench.core.harness import metric_module
from test_portbench_program_spans import Jobs, _records, _window, tracer  # noqa: F401


def _job(made, T, copies, pinned):
    """A map job at T ms after a depth inference whose copy back is not
    pinned and must not count; ``copies`` are the bytes of its two
    ``map.to_host`` spans, ``pinned`` theirs in page-locked memory (None:
    not counted, as before the counter)."""
    d = made.add("infer.depth", T, T + 20)
    made.add("infer.to_host", T + 15, T + 19, d, {"bytes_to_host": 1000})
    m = made.add("map.job", T + 20, T + 40)
    for k, n in enumerate(copies):
        counters = {"bytes_to_host": n}
        if pinned is not None:
            counters["bytes_to_host_pinned"] = pinned[k]
        made.add("map.to_host", T + 30 + 5 * k, T + 33 + 5 * k, m, counters)


def _window_of(made, counted=True):
    """A warm-up job, then untraced, traced, untraced and failed jobs. The
    untraced jobs pin 100 + 200 of their 100 + 300 and 50 + 250 bytes; the
    warm-up, traced and failed jobs pin none, which the reader must not
    take."""
    c = counted
    _job(made, -500, (10, 90), (0, 0) if c else None)
    _job(made, 0, (100, 300), (100, 200) if c else None)
    _job(made, 1000, (70, 70), (0, 0) if c else None)
    _job(made, 2000, (50, 250), (0, 0) if c else None)
    _job(made, 3000, (80, 80), (0, 0) if c else None)
    return _window(_records("u", "t", "u", "f"))


def test_pinned_share_reads_the_made_up_window(tracer):
    got = metric_module("map.pinned_to_host_share").read(_window_of(tracer))
    assert got == pytest.approx(100 * 300 / 700)


@pytest.mark.parametrize("program", ["no_pinned_counter", "no_tracer"])
def test_pinned_share_finds_nothing_to_read(tracer, monkeypatch, program):
    """Copies that count their bytes but no pinned ones (the program before
    the counter), or a program without the tracer, read None, not 0."""
    if program == "no_tracer":
        monkeypatch.setattr(ps, "tracing", None)
        ps._cache.clear()
        w = _window_of(Jobs())
    else:
        w = _window_of(tracer, counted=False)
    assert metric_module("map.pinned_to_host_share").read(w) is None
