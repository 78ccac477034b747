"""Spans at layer boundaries, from the benchmark's side.

In a traced run each named function of the port (``"module:attribute"``,
looked up where the layer above calls it) is wrapped for the run: every
call opens a ``torch.profiler.record_function`` span named
``portbench::<attribute>``, and, outside the profiled slice, adds its host
seconds and its arguments' shapes to a tally. Untraced runs install
nothing.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict

import torch

PREFIX = "portbench::"


def _shapes(args) -> list:
    return [tuple(a.shape) if hasattr(a, "shape") else None for a in args]


class Spans:
    def __init__(self, targets):
        self.targets = sorted(set(targets))
        self.tally = True            # False inside the profiled slice
        self.seconds = defaultdict(list)   # attribute -> host seconds per call
        self.calls = defaultdict(list)     # attribute -> shapes of each call's arguments
        self.traced_calls = defaultdict(list)
        self._saved = []

    def install(self) -> None:
        for target in self.targets:
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(attr, fn))

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(PREFIX + name):
                out = fn(*args, **kwargs)
            if self.tally:
                self.seconds[name].append(time.perf_counter() - t0)
                self.calls[name].append(_shapes(args))
            else:
                self.traced_calls[name].append(_shapes(args))
            return out

        wrapped.__wrapped__ = fn
        return wrapped
