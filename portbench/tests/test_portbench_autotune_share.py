"""The reader of ``train.autotune_share``
(`portbench/metrics/train.autotune_share.py`) on made-up windows: the
untraced training steps counted as run under cuDNN's autotuner over all
the untraced steps, and None against a program that has no tracer or does
not count tuned steps."""

from __future__ import annotations

import pytest

from portbench.core import program_spans as ps
from portbench.core.harness import metric_module
from test_portbench_program_spans import Jobs, _records, _window, tracer  # noqa: F401


def _step(made, T, tuned):
    """A training step at T ms with its phase spans; ``tuned`` is its
    ``train.autotuned_steps`` (None: not counted, as before the counter)."""
    step = made.add("train.step", T, T + 50,
                    counters=None if tuned is None else {"train.autotuned_steps": tuned})
    made.add("train.optimizer", T + 1, T + 2, step)
    made.add("train.forward", T + 3, T + 20, step)
    made.add("train.loss", T + 20, T + 30, step)
    made.add("train.backward", T + 30, T + 45, step)
    made.add("train.optimizer", T + 45, T + 49, step)


def _window_of(made, untraced):
    """A warm-up step, then untraced, traced, untraced and failed steps.
    The untraced steps count ``untraced``; the warm-up, traced and failed
    steps count 1 if the others count 0, and 0 if they count 1, which the
    reader must not take."""
    other = None if untraced is None else 1 - untraced
    _step(made, -100, other)
    for T, tuned in zip((0, 100, 200, 300), (untraced, other, untraced, other)):
        _step(made, T, tuned)
    return _window(_records("u", "t", "u", "f"))


@pytest.mark.parametrize("tuned,share", [(1, 100.0), (0, 0.0)])
def test_autotune_share_reads_the_made_up_window(tracer, tuned, share):
    assert metric_module("train.autotune_share").read(_window_of(tracer, tuned)) == share


@pytest.mark.parametrize("program", ["no_autotune_counter", "no_tracer"])
def test_autotune_share_finds_nothing_to_read(tracer, monkeypatch, program):
    """Steps that count nothing (the program before the counter), or a
    program without the tracer, read None, not 0."""
    if program == "no_tracer":
        monkeypatch.setattr(ps, "tracing", None)
        ps._cache.clear()
        w = _window_of(Jobs(), 1)
    else:
        w = _window_of(tracer, None)
    assert metric_module("train.autotune_share").read(w) is None
