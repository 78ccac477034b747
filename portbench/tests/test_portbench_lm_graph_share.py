"""The reader of ``sfm.lm_graph_share`` (`portbench/metrics/sfm.lm_graph_share.py`)
on made-up windows: the untraced jobs' LM iterations replayed from a CUDA
graph over all their LM iterations, and None against a program that has no
tracer or whose solves count no replays."""

from __future__ import annotations

import pytest

from portbench.core import program_spans as ps
from portbench.core.harness import metric_module
from test_portbench_program_spans import Jobs, _records, _window, tracer  # noqa: F401


def _job(made, T, iters, replays):
    """An SfM job at T ms with one BA call a solve; ``replays`` None counts
    no graph replays, as the eager loop before graphs did."""
    job = made.add("sfm.job", T, T + 100)
    for k, n in enumerate(iters):
        counters = {"ba.lm_iters": n}
        if replays is not None:
            counters.update({"ba.graph_replays": replays[k],
                             "ba.graph_captures": int(replays[k] < n)})
        ba = made.add("sfm.ba", T + 10 + 40 * k, T + 40 + 40 * k, job)
        made.add("ba.solve", T + 12 + 40 * k, T + 38 + 40 * k, ba, counters)


def _window_of(made, graphs=True):
    """A warm-up job, then untraced, traced, untraced and failed jobs. The
    untraced jobs replay all but one iteration, the first job's first (a
    capture); the warm-up, traced and failed jobs replay none, which the
    reader must not take."""
    g = graphs
    _job(made, -500, (90, 90), (0, 0) if g else None)
    _job(made, 0, (5, 7), (4, 7) if g else None)
    _job(made, 1000, (50, 50), (0, 0) if g else None)
    _job(made, 2000, (5, 7), (5, 7) if g else None)
    _job(made, 3000, (70, 70), (0, 0) if g else None)
    return _window(_records("u", "t", "u", "f"))


def test_graph_share_reads_the_made_up_window(tracer):
    got = metric_module("sfm.lm_graph_share").read(_window_of(tracer))
    assert got == pytest.approx(100 * 23 / 24)


@pytest.mark.parametrize("program", ["no_replay_counter", "no_tracer"])
def test_graph_share_finds_nothing_to_read(tracer, monkeypatch, program):
    """Solves that count LM iterations but no graph replays (the eager loop
    before graphs), or a program without the tracer, read None, not 0."""
    if program == "no_tracer":
        monkeypatch.setattr(ps, "tracing", None)
        ps._cache.clear()
        w = _window_of(Jobs())
    else:
        w = _window_of(tracer, graphs=False)
    assert metric_module("sfm.lm_graph_share").read(w) is None
