"""The loop, the window and the result line.

A run loads its cell from `BENCHMARK.json`, builds the entry its traffic
names (set-up and warm-up: the entry's constructor), then runs the entry's
jobs back to back, one client in a closed loop, for ``--seconds``. With
``--trace 1`` the entry's per-layer metrics name the spans to wrap, and
the profiler covers a slice of the window that the traffic file sets
(``trace_after`` jobs, then ``trace_jobs``). Once the window has closed the
peak memory is read, the program's state is freed, and the entry's check
compares what the timed path produced with the plain reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch

from portbench.core.spans import Spans
from portbench.core.trace import WINDOW, Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3drec")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, found by name (a metric's name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    return load_module("metrics", name)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, flax's
    or the JAX package's, compared whole (`tpu3drec_torch` is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", wl["traffic"] + ".json"))
    config.update((overrides or {}).get("config", {}))  # tiny sizes for the CPU tests
    traffic.update((overrides or {}).get("traffic", {}))

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, wl["chips"], config, traffic,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


@dataclass
class RunContext:
    """What an entry gets: its configuration, traffic, seed, device, a
    directory of its own for outputs, and the mode (``"program"``, or a
    fault that the tests plant)."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device
    out_dir: str
    mode: str = "program"


@dataclass
class Window:
    """What the metrics read: the window's job records, its end (seconds
    from its start, after the device finished), set-up seconds, the
    profiled slice's trace and the spans' tallies."""

    setup_s: float
    records: list
    t_end: float
    slice_s: float = 0.0  # the profiled slice, with its profiler's stop
    trace: Trace | None = None
    spans: Spans | None = None
    entry: object = None

    @property
    def done(self) -> list:
        return [r for r in self.records if not r.get("failed")]

    def work_rate(self) -> float | None:
        """All the work of the completed jobs over all the window's time."""
        if not self.done:
            return None
        return sum(r["work"] for r in self.done) / self.t_end

    @property
    def untraced(self) -> list:
        return [r for r in self.done if not r["traced"]]

    @property
    def untraced_s(self) -> float:
        return self.t_end - self.slice_s


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_cpu():
    """(this process's CPU seconds, the host's stolen and total CPU ticks) so
    far, or None where /proc/stat cannot be read."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    t = os.times()
    return t.user + t.system, ticks[7] if len(ticks) > 7 else 0, sum(ticks)


def _noise_line(records, t_end: float, cpu0, cpu1) -> str:
    """What a run's spread may come from, on standard error: the work rate
    in each half of the window, the jobs' times (10th, 50th and 90th
    percentiles), the process's CPU time over the window's and the host's
    stolen share of its CPU time."""
    half = t_end / 2
    rates = [sum(r["work"] for r in records if not r.get("failed") and lo <= r["t1"] < hi)
             / half for lo, hi in ((0, half), (half, t_end + 1))]
    line = f"portbench: work rate by half {rates[0]:.4f} {rates[1]:.4f}"
    ms = [(r["t1"] - r["t0"]) * 1e3 for r in records]
    if len(ms) >= 10:
        q = statistics.quantiles(ms, n=10, method="inclusive")
        line += f", job ms p10 {q[0]:.3f} p50 {q[4]:.3f} p90 {q[-1]:.3f}"
    if cpu0 and cpu1:
        total = max(cpu1[2] - cpu0[2], 1)
        line += (f", process CPU {(cpu1[0] - cpu0[0]) / t_end:.3f} of the window, "
                 f"host stolen {100 * (cpu1[1] - cpu0[1]) / total:.2f}%")
    return line


def run_window(entry, dev, seconds: float, trace: bool, traffic: dict, spans: Spans | None):
    """Jobs back to back for ``seconds``, and at least the entry's
    ``min_jobs`` (the profiled slice, if any, is always run whole). Returns
    (records, t_end, the seconds of the slice and of stopping its profiler,
    profiler)."""
    after, n_traced = traffic.get("trace_after", 1), traffic.get("trace_jobs", 1)
    least = max(getattr(entry, "min_jobs", 1), after + n_traced if trace else 0)
    records, prof, rf, slice_t0, paused = [], None, None, 0.0, 0.0
    _sync(dev)
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < seconds or i < least:
        if trace and i == after:
            _sync(dev)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            spans.tally = False
            rf = torch.profiler.record_function(WINDOW)
            rf.__enter__()
            slice_t0 = time.perf_counter()
        traced = prof is not None and rf is not None
        t0 = time.perf_counter()
        try:
            out = entry.job(i)
        except Exception:  # a job that fails is counted, and the run goes on
            traceback.print_exc()
            out = {"failed": True, "work": 0}
        records.append({"i": i, "t0": t0 - w0, "t1": time.perf_counter() - w0,
                        "traced": traced, **out})
        i += 1
        if traced and i == after + n_traced:
            _sync(dev)
            rf.__exit__(None, None, None)
            prof.stop()
            spans.tally = True
            rf = None
            paused = time.perf_counter() - slice_t0  # the slice and the profiler's stop
    _sync(dev)
    return records, time.perf_counter() - w0, paused, prof


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: torch.device, overrides: dict | None = None, mode: str = "program"):
    """One run. Returns (result dict, the checks' lines for standard error)."""
    cell = load_cell(cell_name, overrides)
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: metric_module(m["name"]) for m in metrics}
    spans = Spans([t for r in readers.values() for t in getattr(r, "SPANS", ())]) if trace else None
    entry_mod = load_module("entries", cell.traffic["entry"])
    if device.type == "cuda":
        print(f"portbench: card {torch.cuda.get_device_name(device)!r}, "
              f"nvidia-smi {_power_limit()!r}", file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory(prefix="portbench_") as out_dir:
        ctx = RunContext(cell.config, cell.traffic, seed, device, out_dir, mode)
        t_entry = time.perf_counter()
        entry = entry_mod.Entry(ctx)
        print(f"portbench: imports {t_entry - t_start:.2f} s, entry set-up and warm-up "
              f"{time.perf_counter() - t_entry:.2f} s", file=sys.stderr, flush=True)
        if spans is not None:
            spans.install()
        _sync(device)
        setup_s = time.perf_counter() - t_start
        cpu0 = _host_cpu()
        try:
            records, t_end, slice_s, prof = run_window(entry, device, seconds, trace,
                                                       cell.traffic, spans)
        finally:
            if spans is not None:
                spans.remove()
        print(_noise_line(records, t_end, cpu0, _host_cpu()), file=sys.stderr, flush=True)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        loaded = forbidden_modules()
        if loaded:
            raise SystemExit(f"portbench: the run loaded {loaded}")
        win = Window(setup_s, records, t_end, slice_s, spans=spans, entry=entry)
        if prof is not None:
            win.trace = Trace.from_profiler(prof, jobs=cell.traffic.get("trace_jobs", 1))
            print(f"portbench: traced {win.trace.window_s:.3f} s, "
                  f"{len(win.trace.device)} device ops, launches matched to their call: "
                  f"{win.trace.matched_share():.4f}", file=sys.stderr, flush=True)
            del prof
        values = {}
        for m in metrics:
            v = readers[m["name"]].read(win)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        entry.release()
        checks = entry.check(records)
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"portbench: the run loaded {loaded}")
    failed = sum(1 for r in records if r.get("failed"))
    result = {
        "correct": failed == 0 and bool(checks) and all(c["ok"] for c in checks),
        "attempted": len(records),
        "failed": failed,
        "metrics": values,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if win.trace is not None:
        result["device"].update(busy_s=win.trace.busy_s, window_s=win.trace.window_s)
        result["breakdown"] = {"device_ops": win.trace.top_device_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["checks"] = {c["name"]: {"value": _finite(c["value"]), "limit": c["limit"],
                                    "ok": c["ok"]} for c in checks}
    lines = [f"check {c['name']}: {c['value']!r} {c['op']} {c['limit']!r} "
             f"{'ok' if c['ok'] else 'FAILED'}" for c in checks]
    return result, lines


def _finite(v):
    """JSON has no infinity or NaN: a reading that is none of a number is null."""
    return v if v is None or math.isfinite(v) else None


def check(name: str, value, limit, op: str = "<=") -> dict:
    """One compared number beside its limit; a missing or NaN value fails."""
    ok = value is not None and value == value and (value <= limit if op == "<=" else value >= limit)
    return {"name": name, "value": value, "limit": limit, "op": op, "ok": bool(ok)}


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr, flush=True)
        return 3
    torch.set_num_threads(4)
    result, lines = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                        torch.device("cuda", 0))
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
