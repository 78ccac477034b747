"""Reduction of a torch.profiler trace of the profiled slice.

The slice is bounded by the harness's ``portbench::window`` span. From the
profiler's events this keeps the device's operations (kernels, copies and
sets), the CUDA runtime calls that launched them (matched by correlation
id) and the host's operations and spans on the thread that ran the slice.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.core.spans import PREFIX

WINDOW = PREFIX + "window"
NAME_CHARS = 160  # a kernel's name is cut to this in the breakdown


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _dur_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _is_device(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel launch, not a copy or a set."""
    return not (name.startswith("Memcpy") or name.startswith("Memset")
                or name.startswith("Memory"))


def merge(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """``device``: (start, end, name, correlation) per device operation in the
    window; ``host``: (start, end, name) per host operation or span on the
    slice's thread; times in ns on one clock."""

    def __init__(self, device, runtime, host, window, jobs: int):
        self.w0, self.w1 = window
        self.jobs = jobs
        self.device = [d for d in device if d[1] > self.w0 and d[0] < self.w1]
        self.runtime = runtime  # correlation -> start of the launching call
        self.host = sorted(host)

    @classmethod
    def from_profiler(cls, prof, jobs: int) -> "Trace":
        device, runtime, host_by_tid = [], {}, defaultdict(list)
        window, window_tid = None, None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            s = _start_ns(e)
            end = s + _dur_ns(e)
            if _is_device(e):
                if not name.startswith(PREFIX):  # the GPU-side copies of host spans
                    device.append((s, end, name, e.correlation_id() or e.linked_correlation_id()))
            elif _is_runtime(name):
                runtime[e.correlation_id()] = s
            else:
                tid = e.start_thread_id()
                host_by_tid[tid].append((s, end, name))
                if name == WINDOW:
                    window, window_tid = (s, end), tid
        if window is None:
            raise RuntimeError("the profiled slice has no window span")
        return cls(device, runtime, host_by_tid[window_tid], window, jobs)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    def busy(self):
        return merge((max(s, self.w0), min(e, self.w1)) for s, e, _, _ in self.device)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    @property
    def launches(self) -> int:
        return sum(1 for d in self.device if is_kernel(d[2]))

    def spans(self, names):
        """Merged (start, end) of the host spans of these attributes."""
        want = {PREFIX + n for n in names}
        return merge((s, e) for s, e, n in self.host if n in want)

    def kernel_seconds_under(self, names):
        """Device seconds of the kernels whose launch lies inside a span of
        ``names``; None where no such span ran or no kernel's launch was
        matched."""
        spans = self.spans(names)
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total, matched = 0, 0
        for s, e, name, corr in self.device:
            t = self.runtime.get(corr)
            if t is None or not is_kernel(name):
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
                matched += 1
        return total * 1e-9 if matched else None

    def matched_share(self) -> float:
        """Share of the window's kernels whose launching call was found."""
        kernels = [d for d in self.device if is_kernel(d[2])]
        if not kernels:
            return 0.0
        return sum(1 for d in kernels if d[3] in self.runtime) / len(kernels)

    def top_device_ops(self, n: int = 10):
        by = defaultdict(int)
        for s, e, name, _ in self.device:
            by[name] += min(e, self.w1) - max(s, self.w0)
        return [[k[:NAME_CHARS], v * 1e-9]
                for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The device's idle time in the window, summed by what the host was
        doing when each gap began: "<innermost span> > <innermost op>"."""
        gaps, t = [], self.w0
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.w1:
            gaps.append((t, self.w1))
        by = defaultdict(int)
        stack, j = [], 0
        for g0, g1 in gaps:
            while j < len(self.host) and self.host[j][0] <= g0:
                while stack and stack[-1][1] < self.host[j][0]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][1] < g0:
                stack.pop()
            span = next((ev[2][len(PREFIX):] for ev in reversed(stack)
                         if ev[2].startswith(PREFIX)), "harness")
            op = stack[-1][2] if stack and not stack[-1][2].startswith(PREFIX) else "python"
            by[f"{span} > {op}"] += g1 - g0
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
