"""The program's own spans and counters (`tpu3drec_torch/utils/tracing.py`),
read by the per-layer metrics that import this module.

Importing it turns the program's tracer on, and only the metric files that
read program spans import it; the harness loads per-layer metrics in
traced runs only, so untraced runs keep the tracer off. A program without
the tracer leaves every reader here with nothing to read: they return
None.

The window's jobs are found by their root spans: for each root name a job
opens (``sfm.job``, ``map.job``, ``infer.depth``, ``train.step``), the
last ``len(win.records)`` roots of that name, paired in order with
``win.records`` (the warm-up's roots come before them; a job that raised
still closed its root). Host-clock readers take the untraced jobs; trace
readers take the traced ones, and put a device operation under a span
when the runtime call that launched it lies inside the span (backward
kernels launch from autograd's own thread, so by time, not by thread).

Once a window, in traced runs, two lines go to standard error: the
device's idle gaps by the innermost program span open as each began, and
the clock's agreement with the harness's own spans at the same calls.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

from portbench.core.spans import PREFIX
from portbench.core.trace import is_kernel, merge

try:
    from tpu3drec_torch.utils import tracing
except ImportError:  # a program without the tracer
    tracing = None
else:
    tracing.enable()
# the Unix clock less perf_counter now, against which the conversion's drift is read
_OFFSET0 = time.time_ns() - time.perf_counter_ns()

# the harness's span at a call, and the program span around the same call
ALIGNED = {"match_pairs": "sfm.match", "write_bt_sharded": "map.write_bt"}
_cache: dict = {}


def _spans(win) -> list:
    """Every span the program finished up to the metrics' read, drained
    once a window."""
    if _cache.get("win") is not win:
        spans = tracing.drain() if tracing is not None else []
        _cache.clear()
        _cache.update(win=win, spans=spans, jobs={})
        if win.trace is not None and spans:
            _report(win, spans)
    return _cache["spans"]


def _roots(win, name: str) -> list | None:
    """(record, the spans of its root ``name``) for each of the window's
    records, or None where the program opened fewer such roots."""
    spans = _spans(win)
    paired = _cache["jobs"]
    if name not in paired:
        by_root = defaultdict(list)
        for s in spans:
            by_root[s.root].append(s)
        roots = sorted((s for s in spans if s.parent is None and s.name == name),
                       key=lambda s: s.t0)
        n = len(win.records)
        paired[name] = (None if len(roots) < n or n == 0 else
                        [(r, by_root[root.id]) for r, root in zip(win.records, roots[-n:])])
    return paired[name]


def jobs(win, *roots: str, traced: bool = False) -> list | None:
    """(record, the spans of the job's roots named ``roots``) for the
    window's completed jobs, traced or untraced; a root name the program
    never opened adds nothing; None where no root is found, or a name is
    found fewer times than the window has jobs."""
    found = []
    for name in roots:
        if not any(s.parent is None and s.name == name for s in _spans(win)):
            continue
        paired = _roots(win, name)
        if paired is None:
            return None
        found.append(paired)
    if not found:
        return None
    out = []
    for parts in zip(*found):
        rec = parts[0][0]
        if not rec.get("failed") and bool(rec["traced"]) == traced:
            out.append((rec, [s for _, spans in parts for s in spans]))
    return out


def seconds(spans, name: str) -> float:
    """The summed seconds of the spans named ``name``."""
    return sum(s.t1 - s.t0 for s in spans if s.name == name) * 1e-9


def counter(spans, key: str) -> float:
    """Counter ``key`` summed over ``spans``."""
    return sum((s.counters or {}).get(key, 0) for s in spans)


def self_seconds(spans, name: str, less: str) -> float:
    """The seconds of the spans named ``name``, less those of the spans
    named ``less`` nested in them."""
    by_id = {s.id: s for s in spans}
    inner = 0
    for s in spans:
        if s.name != less:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != name:
            p = by_id.get(p.parent)
        if p is not None:
            inner += s.t1 - s.t0
    return seconds(spans, name) - inner * 1e-9


def launched_under(win, spans, name: str, which) -> int | None:
    """Device operations of the profiled slice that ``which(op name)``
    keeps and whose launching call lies inside a span named ``name`` of
    ``spans``; None without a trace or without such a span."""
    t = win.trace
    if t is None or not t.device:
        return None
    ivs = merge((s.t0, s.t1) for s in spans if s.name == name)
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    n = 0
    for _, _, op, corr in t.device:
        at = t.runtime.get(corr)
        if at is None or not which(op):
            continue
        i = bisect.bisect_right(starts, at) - 1
        n += i >= 0 and at <= ivs[i][1]
    return n


def is_host_read(op: str) -> bool:
    return op.startswith("Memcpy DtoH")


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def _innermost(intervals, points):
    """For each sorted point, the innermost of the nested ``intervals``
    ((start, end, name), sorted) that holds it, or None."""
    out, stack, j = [], [], 0
    for p in points:
        while j < len(intervals) and intervals[j][0] <= p:
            while stack and stack[-1][1] < intervals[j][0]:
                stack.pop()
            stack.append(intervals[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def idle_by_span(win, n: int | None = 12):
    """The device's idle time in the profiled slice, summed by the
    innermost program span open as each gap began and the innermost host
    operation then: "<span> > <op>", in seconds, the largest ``n`` (None:
    all)."""
    t = win.trace
    if t is None:
        return []
    gaps, at = [], t.w0
    for s, e in t.busy():
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < t.w1:
        gaps.append((at, t.w1))
    outer_first = lambda iv: (iv[0], -iv[1])  # noqa: E731
    program = sorted(((s.t0, s.t1, s.name) for s in _spans(win)), key=outer_first)
    ops = sorted((h for h in t.host if not h[2].startswith(PREFIX)), key=outer_first)
    starts = [g0 for g0, _ in gaps]
    by = defaultdict(int)
    for (g0, g1), sp, op in zip(gaps, _innermost(program, starts), _innermost(ops, starts)):
        by[f"{sp[2] if sp else 'outside'} > {op[2] if op else 'python'}"] += g1 - g0
    return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def clock_check(win, spans) -> dict:
    """The program spans against the harness's spans at the same calls:
    for each pair of ``ALIGNED``, the least and the largest margin (us) by
    which the harness's span lies inside the program's at the start and at
    the end (negative: outside), and, for the matcher, the kernels launched
    under the harness's span and those of them also under the program's."""
    t, out = win.trace, {}
    for attr, name in ALIGNED.items():
        outer = [(s, e) for s, e, n in t.host if n == PREFIX + attr]
        inner = [s for s in spans if s.name == name]
        pairs = [(o, next((s for s in inner if s.t0 <= o[1] and s.t1 >= o[0]), None))
                 for o in outer]
        pairs = [(o, s) for o, s in pairs if s is not None]
        if not pairs:
            continue
        starts = [(o[0] - s.t0) * 1e-3 for o, s in pairs]
        ends = [(s.t1 - o[1]) * 1e-3 for o, s in pairs]
        out[attr] = {"calls": len(pairs), "start_us": [min(starts), max(starts)],
                     "end_us": [min(ends), max(ends)]}
        if attr == "match_pairs":
            both = _traced_kernels(t, [o for o, _ in pairs], [(s.t0, s.t1) for _, s in pairs])
            out[attr].update(kernels=both[0], kernels_in_program_span=both[1])
    return out


def _traced_kernels(t, outer, inner):
    """(kernels launched inside ``outer``, those also inside ``inner``)."""
    def inside(ivs, at):
        return any(s <= at <= e for s, e in ivs)

    n = m = 0
    for _, _, op, corr in t.device:
        at = t.runtime.get(corr)
        if at is not None and is_kernel(op) and inside(outer, at):
            n += 1
            m += inside(inner, at)
    return n, m


def _report(win, spans) -> None:
    gaps = idle_by_span(win, None)
    by_span = defaultdict(float)
    for key, v in gaps:
        by_span[key.split(" > ")[0]] += v
    print(f"portbench: idle by program span {sorted(by_span.items(), key=lambda kv: -kv[1])}; "
          f"by span and host op {gaps[:12]}", file=sys.stderr, flush=True)
    drift = (time.time_ns() - time.perf_counter_ns() - _OFFSET0) * 1e-3
    print(f"portbench: program clock against the harness's spans {clock_check(win, spans)}, "
          f"Unix clock less perf_counter moved {drift:.3f} us since tracing began",
          file=sys.stderr, flush=True)
