"""Tracing and roofline accounting (port of `tpu3drec/utils/profiling.py`).

`trace` records a torch.profiler trace of the card and the host, with the
port's program spans (`utils/tracing.py`) on a track of their own, and
writes it as a Chrome trace (chrome://tracing, Perfetto); `roofline`
classifies a measured time against a chip's peaks, by default those of one
H100 SXM. `recording` keeps every call of a function with clones of its
arguments and result, and `held_against` holds the recorded results
against another function (a kernel's plain version) on the same
arguments, bit for bit.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass

import torch

from tpu3drec_torch.utils import tracing


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the CPU and, when there is one, the card,
    with the program spans of the block: ``with trace('/tmp/trace'):
    step()`` writes ``log_dir/trace.json``. Tracing is on for the block
    (and left as it was after it); the spans that finish in it are drained
    from the tracer into the file."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = tracing.is_enabled()
    tracing.enable()
    t_start = time.time_ns()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if not was_on:
            tracing.disable()
    spans = [s for s in tracing.drain() if s.t0 >= t_start]
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_program_spans(path, spans)


_PROGRAM_TRACK = 1 << 30  # thread ids of the program spans' tracks: this, plus one a thread


def _add_program_spans(path: str, spans) -> None:
    """Appends ``spans`` (finished `utils/tracing.py` spans) to the Chrome
    trace at ``path``, one track a thread named "program spans", on the
    file's own time base (its ``baseTimeNanoseconds``, 0 where it has
    none: its times are then Unix microseconds)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tracks, events = os.getpid(), {}, doc.setdefault("traceEvents", [])
    for s in sorted(spans, key=lambda s: s.t0):
        tid = tracks.setdefault(s.thread, _PROGRAM_TRACK + len(tracks))
        args = {"id": s.id, "parent": s.parent, "root": s.root, **(s.counters or {})}
        events.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": tid,
                       "ts": (s.t0 - base) / 1e3, "dur": (s.t1 - s.t0) / 1e3, "args": args})
    for n, tid in enumerate(tracks.values()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": "program spans" + (f" {n}" if n else "")}})
    with open(path, "w") as f:
        json.dump(doc, f)


@dataclass(frozen=True)
class ChipSpec:
    """A chip's peak rates: dense matmul FLOP/s in bf16 and fp32, memory
    bytes/s, and elementwise (vector) operations/s."""

    name: str
    flops_bf16: float
    flops_f32: float
    hbm_bytes_per_s: float
    vpu_ops_per_s: float


# One H100 SXM, from NVIDIA's H100 data sheet: 67 TFLOP/s fp32 on the CUDA
# cores, 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3. Its
# elementwise rate is the fp32 CUDA-core rate.
H100 = ChipSpec(
    name="H100 SXM",
    flops_bf16=989e12,
    flops_f32=67e12,
    hbm_bytes_per_s=3.35e12,
    vpu_ops_per_s=67e12,
)


@dataclass
class RooflineReport:
    seconds: float
    flops: float
    bytes: float
    achieved_flops_per_s: float
    achieved_bytes_per_s: float
    compute_bound: bool
    fraction_of_peak: float

    def __str__(self):
        kind = "compute" if self.compute_bound else "memory"
        return (
            f"{self.seconds*1e3:.3f} ms | {self.achieved_flops_per_s/1e12:.2f} TFLOP/s, "
            f"{self.achieved_bytes_per_s/1e9:.1f} GB/s | {kind}-bound | "
            f"{self.fraction_of_peak*100:.1f}% of speed-of-light"
        )


def roofline(seconds: float, flops: float, bytes_moved: float,
             chip: ChipSpec = H100, dtype: str = "f32") -> RooflineReport:
    """Classify a measured kernel against the chip roofline."""
    peak_flops = chip.flops_bf16 if dtype == "bf16" else chip.flops_f32
    t_compute = flops / peak_flops
    t_memory = bytes_moved / chip.hbm_bytes_per_s
    t_sol = max(t_compute, t_memory)
    return RooflineReport(
        seconds=seconds,
        flops=flops,
        bytes=bytes_moved,
        achieved_flops_per_s=flops / max(seconds, 1e-12),
        achieved_bytes_per_s=bytes_moved / max(seconds, 1e-12),
        compute_bound=t_compute >= t_memory,
        fraction_of_peak=t_sol / max(seconds, 1e-12),
    )


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_clone(v) for v in x)
    return x


@contextlib.contextmanager
def patched(owner, names, wrap):
    """Replaces ``owner.<name>`` by ``wrap(name, original)`` for each name,
    and puts the originals back on the way out."""
    saved = {n: getattr(owner, n) for n in names}
    for n in names:
        setattr(owner, n, wrap(n, saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(owner, n, fn)


@contextlib.contextmanager
def recording(module, name: str):
    """Passes every call of ``module.name`` through unchanged and keeps
    clones of its arguments and its result (tensors cloned, dicts, lists
    and tuples walked), so that what a path's own launches returned can be
    held against the plain version on the inputs the path gave them.
    Yields the list of (args, result) it fills; keyword arguments are
    passed on and not kept."""
    calls = []

    def wrap(_, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((_clone(args), _clone(out)))
            return out
        return wrapped

    with patched(module, (name,), wrap):
        yield calls


def held_against(calls, plain):
    """Each recorded call's result (a sequence or dict of tensors) against
    ``plain`` on the same arguments, bit for bit. Returns (the calls equal
    in every output, the largest absolute difference, the first differing
    (call, output key) or None)."""
    equal, max_err, first = 0, 0.0, None
    for i, (args, out) in enumerate(calls):
        ref = plain(*args)
        same = True
        for k in (list(ref) if isinstance(ref, dict) else range(len(ref))):
            if out[k].numel():
                max_err = max(max_err, float((out[k].double() - ref[k].double()).abs().max()))
            if not torch.equal(out[k], ref[k]):
                same = False
                first = first or (i, k)
        equal += same
    return equal, max_err, first
