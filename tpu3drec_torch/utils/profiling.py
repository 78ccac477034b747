"""Tracing, timing and roofline accounting (port of
`tpu3drec/utils/profiling.py`).

`trace` records a torch.profiler trace of the card and the host and writes
it as a Chrome trace (chrome://tracing, Perfetto). `time_chained` and
`time_device_loop` time device work with CUDA events and
``torch.cuda.synchronize``; `roofline` classifies a measured time against
a chip's peaks, by default those of one H100 SXM. `recording` keeps every
call of a function with clones of its arguments and result, and
`held_against` holds the recorded results against another function (a
kernel's plain version) on the same arguments, bit for bit.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the CPU and, when there is one, the card:
    ``with trace('/tmp/trace'): step()`` writes ``log_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _elapsed(fn) -> float:
    """Seconds of ``fn()``: CUDA events around it on the card (after a
    synchronize), the host clock without one."""
    if torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def time_chained(step_fn, x0, iters: int = 20, warmup: int = 2) -> float:
    """Steady-state seconds per iteration of ``x = step_fn(x)``, the output
    of each call feeding the next, so the calls run one after another."""
    x = x0
    for _ in range(warmup):
        x = step_fn(x)
    _sync()
    state = {"x": x}

    def loop():
        for _ in range(iters):
            state["x"] = step_fn(state["x"])

    return _elapsed(loop) / iters


def time_device_loop(body_fn, make_carry, iters=(4, 24), reps=2) -> float:
    """Per-iteration seconds by the two-length slope: ``carry =
    body_fn(i, carry)`` run ``n1`` and ``n2`` times from ``make_carry(salt)``
    (the best of ``reps`` runs of each), returning (t_n2 - t_n1) / (n2 - n1),
    in which the fixed cost of a run cancels."""
    n1, n2 = iters
    best = {n1: float("inf"), n2: float("inf")}
    salt = 0
    for _ in range(reps):
        for n in (n1, n2):
            salt += 1
            c = make_carry(float(salt))
            _sync()

            def loop(c=c, n=n):
                for i in range(n):
                    c = body_fn(i, c)

            best[n] = min(best[n], _elapsed(loop))
    return max((best[n2] - best[n1]) / (n2 - n1), 1e-9)


def chain_scalar(out) -> torch.Tensor:
    """Collapse any nest of tensors (dicts, lists, tuples) to a zero scalar
    that depends on all of them, for folding into the next iteration's
    input (``x + chain_scalar(out)``)."""
    acc = torch.zeros(())
    stack = [out]
    while stack:
        o = stack.pop()
        if isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, torch.Tensor):
            acc = acc.to(o.device) + torch.sum(o).to(torch.float32) * 0
    return acc


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
    Yields the list of (args, result) it fills."""
    calls = []

    def wrap(_, fn):
        def wrapped(*args):
            out = fn(*args)
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
