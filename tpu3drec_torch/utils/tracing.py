"""The port's program spans and counters.

``with span("sfm.ba"):`` marks a stretch of host work; ``count(name, n)``
adds to the innermost open span's counters. Both cost one flag test when
tracing is off (the default): `span` then returns one shared no-op context
manager, allocates nothing and reads no clock. An operator turns tracing on
with `enable()` and collects the finished spans with `drain()`, or traces a
block together with the device through `utils/profiling.py::trace`, which
writes the spans into its Chrome trace as a track of their own.

Spans nest per thread. A span opened with none open on its thread is a
root and takes a fresh id; every span under it carries that id as its
``root``, so the spans of one job (an SfM run, a map job, a training step)
share an identifier. A span closes when an exception passes through it.

Times are read with ``time.perf_counter_ns`` and converted to the Unix
clock by one offset sampled in `enable()`: the clock of torch.profiler's
host events, so spans and the device trace line up. Nothing here
synchronises the device or reads from it: counters take only what the host
already holds (array sizes, loop counts).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

MAX_SPANS = 1 << 18  # finished spans kept until drained; the oldest go first

_enabled = False
_offset = 0
_finished: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of a disabled tracer: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One finished or open span: ``name``, ``id``, ``parent`` (the id of
    the span it opened under, or None), ``root`` (the id of its root span),
    ``thread`` (the native id of its thread), ``t0`` and ``t1`` (Unix ns)
    and ``counters`` (a dict, or None when nothing was counted)."""

    __slots__ = ("name", "id", "parent", "root", "thread", "t0", "t1", "counters")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)
        self.counters = None
        self.t1 = None

    def _place(self, stack: list) -> None:
        """Parent, root and thread from the innermost open span of ``stack``."""
        if not stack:
            self.parent, self.root, self.thread = None, self.id, threading.get_native_id()
        else:
            top = stack[-1]
            self.parent, self.root, self.thread = top.id, top.root, top.thread

    def __enter__(self):
        stack = _stack()
        self._place(stack)
        stack.append(self)
        self.t0 = time.perf_counter_ns() + _offset
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns() + _offset
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # spans left open above it close unrecorded
            del stack[stack.index(self):]
        _finished.append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"t0={self.t0}, t1={self.t1}, counters={self.counters})")


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context manager that records ``name``'s host interval when tracing
    is on, and the shared no-op when it is off."""
    if not _enabled:
        return _OFF
    return Span(name)


def record(name: str, t0_ns: int, t1_ns: int) -> None:
    """A finished span from two ``perf_counter_ns`` readings the caller
    already took (a stage clock's laps), under the innermost open span;
    nothing when tracing is off."""
    if not _enabled:
        return
    s = Span(name)
    s._place(_stack())
    s.t0, s.t1 = t0_ns + _offset, t1_ns + _offset
    _finished.append(s)


def count(name: str, n=1) -> None:
    """Adds ``n`` to counter ``name`` of the innermost span open on this
    thread; nothing when tracing is off or no span is open."""
    if not _enabled:
        return
    stack = getattr(_local, "stack", None)
    if not stack:
        return
    top = stack[-1]
    if top.counters is None:
        top.counters = {name: n}
    else:
        top.counters[name] = top.counters.get(name, 0) + n


def enable() -> None:
    """Turns tracing on and samples the offset from ``perf_counter_ns`` to
    the Unix clock."""
    global _enabled, _offset
    _offset = time.time_ns() - time.perf_counter_ns()
    _enabled = True


def disable() -> None:
    """Turns tracing off; spans still open finish and are kept."""
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def drain() -> list:
    """The finished spans, in the order they closed (a child before its
    parent), removed from the tracer."""
    out = []
    while True:
        try:
            out.append(_finished.popleft())
        except IndexError:
            return out
