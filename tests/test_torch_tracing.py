"""The port's program spans and counters (`tpu3drec_torch/utils/tracing.py`)
on the CPU: the shared no-op when tracing is off, nesting, roots, threads,
counters and exceptions when it is on, the clock against torch.profiler's
host events, the spans in `utils/profiling.py::trace`'s Chrome trace, and
the spans and counters of incremental SfM, bundle adjustment and the map
pipeline against what those paths report themselves.
"""

import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec_torch.pipelines import rgbd
from tpu3drec_torch.sfm import incremental
from tpu3drec_torch.sfm.ba import BAResult
from tpu3drec_torch.utils import profiling, tracing
from tpu3drec_torch.utils.config import CameraConfig, MapConfig, RGBDPipelineConfig

from test_sfm_e2e import K, _render


@pytest.fixture(autouse=True)
def tracer():
    """Every test starts and ends with the tracer off and empty."""
    tracing.disable()
    tracing.drain()
    yield tracing
    tracing.disable()
    tracing.drain()


def _seconds(s):
    return (s.t1 - s.t0) * 1e-9


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_span_is_one_shared_object_and_records_nothing():
    assert not tracing.is_enabled()
    first = tracing.span("a")
    assert tracing.span("b") is first

    def body():
        for _ in range(1000):
            with tracing.span("sfm.job"):
                tracing.count("n", 3)
            tracing.record("sfm.match", 0, 1)

    body()  # any first-call caches filled outside the measurement
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        body()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "lineno")
             if d.traceback[0].filename == tracing.__file__ and d.size_diff > 0]
    assert grown == []
    assert tracing.drain() == []


def test_nesting_roots_counters_and_exceptions():
    tracing.enable()
    with tracing.span("job") as job:
        tracing.count("reads", 2)
        with tracing.span("stage") as stage:
            tracing.count("reads")
            tracing.count("reads", 4)
            tracing.count("bytes", 10)
        with pytest.raises(ValueError):
            with tracing.span("failing"):
                raise ValueError("closed on the way out")
    with tracing.span("next_job") as nxt:
        pass
    tracing.count("dropped")  # no span open: nothing to add to
    spans = tracing.drain()
    assert [s.name for s in spans] == ["stage", "failing", "job", "next_job"]
    by = _by_name(spans)
    assert job.parent is None and job.root == job.id
    assert stage.parent == job.id and stage.root == job.id
    assert by["failing"][0].parent == job.id and by["failing"][0].t1 is not None
    assert nxt.parent is None and nxt.root == nxt.id != job.id
    assert job.counters == {"reads": 2} and stage.counters == {"reads": 5, "bytes": 10}
    assert nxt.counters is None
    assert job.t0 <= stage.t0 <= stage.t1 <= job.t1
    assert tracing.drain() == []


def test_stacks_are_per_thread():
    tracing.enable()
    ready, release = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with tracing.span("worker_root") as w:
            ready.set()
            release.wait(10)
            with tracing.span("worker_child") as c:
                seen["child"] = c
        seen["root"] = w

    with tracing.span("main_root") as main:
        t = threading.Thread(target=worker)
        t.start()
        ready.wait(10)
        with tracing.span("main_child") as mc:
            release.set()
            t.join(10)
    assert mc.parent == main.id and mc.root == main.id
    assert seen["root"].parent is None and seen["root"].root == seen["root"].id
    assert seen["child"].parent == seen["root"].id
    assert seen["root"].thread != main.thread
    assert len(tracing.drain()) == 4


def test_an_abandoned_child_closes_with_its_parent():
    """A span entered by hand and never left leaves the stack when the span
    it opened under closes, unrecorded; the next span is a root again."""
    tracing.enable()
    with tracing.span("job"):
        tracing.span("left_open").__enter__()
    with tracing.span("after") as after:
        pass
    assert after.parent is None
    assert [s.name for s in tracing.drain()] == ["job", "after"]


def test_record_takes_the_caller_s_clock_readings():
    tracing.enable()
    with tracing.span("job") as job:
        t0 = time.perf_counter_ns()
        t1 = time.perf_counter_ns()
        tracing.record("stage", t0, t1)
    spans = _by_name(tracing.drain())
    stage = spans["stage"][0]
    assert stage.parent == job.id and stage.root == job.id
    assert stage.t1 - stage.t0 == t1 - t0 and job.t0 <= stage.t0 <= stage.t1 <= job.t1


def test_spans_share_the_profiler_s_host_clock():
    """A record_function block inside a program span lies inside the span's
    interval once both are on one clock: the spans carry Unix ns, as the
    profiler's host events do."""
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("outer") as outer:
            with torch.profiler.record_function("inner_block"):
                torch.ones(64).sum()
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "inner_block")
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert outer.t0 <= start and end <= outer.t1, (outer.t0, start, end, outer.t1)
    assert outer.t1 - outer.t0 < 1e9


def test_profiling_trace_writes_program_spans(tmp_path):
    """`profiling.trace` turns tracing on for its block only and writes the
    block's spans as a track of their own, on the file's time base, around
    the profiler's own event of the same work."""
    with profiling.trace(str(tmp_path)):
        with tracing.span("program.step"):
            tracing.count("bytes_to_host", 128)
            with torch.profiler.record_function("inner_block"):
                torch.ones(64).sum()
    assert not tracing.is_enabled() and tracing.drain() == []
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    prog = [e for e in events if e.get("cat") == "program"]
    inner = next(e for e in events if e.get("name") == "inner_block")
    assert [e["name"] for e in prog] == ["program.step"]
    step = prog[0]
    assert step["args"]["bytes_to_host"] == 128 and step["args"]["parent"] is None
    assert step["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= step["ts"] + step["dur"]
    names = [e for e in events if e.get("ph") == "M" and e.get("tid") == step["tid"]]
    assert names and names[0]["args"]["name"] == "program spans"
    assert step["tid"] != inner["tid"]


@pytest.fixture(scope="module")
def sfm_images():
    """tests/test_sfm_e2e.py's scene (as tests/test_torch_sfm.py renders it)."""
    rng = np.random.default_rng(7)
    gx, gz = np.meshgrid(np.linspace(-4, 6, 9), np.linspace(8, 16, 6))
    X = np.stack([gx.ravel(), np.zeros(gx.size), gz.ravel()], -1)
    X += rng.uniform(-0.45, 0.45, size=X.shape)
    X[:, 1] = rng.uniform(-2.0, 2.0, size=X.shape[0])
    amps = rng.uniform(0.4, 1.0, size=(X.shape[0], 4))
    sats = rng.uniform(-0.35, 0.35, size=(X.shape[0], 3, 3))
    images = []
    for f in range(6):
        R = ScipyR.from_rotvec([0, 0.03 * f, 0]).as_matrix().astype(np.float32)
        C = np.array([0.5 * f, 0.05 * f, 0.3 * f], np.float32)
        images.append(_render(X, R, (-R @ C).astype(np.float32), amps, sats))
    return np.stack(images)


class _Ticks:
    """A clock that moves 1 us at every reading and at no other time: the
    stage laps of `sfm/incremental.py` and the tracer's spans read it in
    place of ``time.perf_counter_ns``, so that a wall-clock stall between
    two readings (a garbage collection, the scheduler under parallel test
    workers) cannot move the spans against the laps."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        self.ns += 1000
        return self.ns

    def time_ns(self):
        return time.time_ns()


def test_sfm_spans_agree_with_its_stage_clock(sfm_images, monkeypatch):
    """The ``sfm.ba`` spans sum to ``Reconstruction.seconds["ba"]``, the
    ``sfm.detect``/``match``/``verify`` spans equal its laps, the
    ``ba.lm_iters`` counters sum to the LM iterations `ba_solve` reported,
    and on the CPU no LM iteration replays a CUDA graph."""
    ticks = _Ticks()
    monkeypatch.setattr(incremental, "time", ticks)
    monkeypatch.setattr(tracing, "time", ticks)
    tracing.enable()
    with profiling.recording(incremental, "ba_solve") as calls:
        rec = incremental.run_sfm(sfm_images, K, max_keypoints=128, overlap=3, seed=0,
                                  device="cpu")
    spans = tracing.drain()
    by = _by_name(spans)
    assert len(by["sfm.job"]) == 1 and by["sfm.job"][0].parent is None
    root = by["sfm.job"][0].id
    assert all(s.root == root for s in spans)
    ba = by["sfm.ba"]
    assert len(ba) == len(calls) >= 2
    assert abs(sum(_seconds(s) for s in ba) - rec.seconds["ba"]) < 2e-3
    for stage in ("detect", "match", "verify"):
        (s,) = by["sfm." + stage]
        assert _seconds(s) == pytest.approx(rec.seconds[stage], abs=1e-6)
    solves = by["ba.solve"]
    assert len(solves) == len(calls)
    assert all(s.parent in {b.id for b in ba} for s in solves)
    iters = sum(s.counters["ba.lm_iters"] for s in solves)
    assert iters == sum(BAResult(*out).n_iters for _, out in calls) > 0  # clones are tuples
    assert all(s.counters["ba.graph_replays"] == 0 for s in solves)
    frames = by["sfm.register.frame"]
    assert frames and all(s.parent == root for s in frames)
    attempts = sum((s.counters or {}).get("sfm.pnp.attempts", 0) for s in frames)
    assert attempts >= len(rec.registered_frames()) - 2
    assert {s.parent for s in by["sfm.pnp"]} <= {s.id for s in frames}


def test_map_job_counts_the_copies_both_ways(tmp_path):
    """`rgbd.run_arrays`: ``bytes_to_device`` is the float32 bytes of the
    depth, the poses and the four intrinsics; ``bytes_to_host`` the voxel
    count, the voxel keys, the mask and the cloud that came back."""
    F, H, W = 3, 8, 10
    depth = np.random.default_rng(0).uniform(0.5, 3.0, (F, H, W)).astype(np.float64)
    depth[0, 0, :4] = 0.0  # a few pixels left out by min_depth
    q = np.tile(np.array([0, 0, 0, 1], np.float32), (F, 1))
    t = np.zeros((F, 3), np.float32)
    cfg = RGBDPipelineConfig(
        camera=CameraConfig(fx=10.0, fy=10.0, cx=5.0, cy=4.0, width=W, height=H),
        map=MapConfig(voxel_res=0.1, min_depth=0.1, max_depth=10.0),
        out_ply="", out_bt=str(tmp_path / "m.bt"))
    tracing.enable()
    res = rgbd.run_arrays(depth, q, t, cfg, keep_points=True, device="cpu")
    spans = tracing.drain()
    by = _by_name(spans)
    (job,) = by["map.job"]
    assert job.parent is None and all(s.root == job.id for s in spans)
    assert [s.name for s in sorted(spans, key=lambda s: s.t0)] == [
        "map.job", "map.to_device", "map.fuse", "map.voxel", "map.to_host", "map.write_bt",
        "map.to_host"]
    down = sum((s.counters or {}).get("bytes_to_device", 0) for s in spans)
    assert down == F * H * W * 4 + F * 9 * 4 + F * 3 * 4 + 4 * 4
    assert by["map.to_device"][0].counters == {"bytes_to_device": down}
    n_pix = F * H * W
    up = sum((s.counters or {}).get("bytes_to_host", 0) for s in spans)
    assert up == 4 + res.n_voxels * 3 * 4 + n_pix + res.points.nbytes
    assert res.points.shape == (n_pix - 4, 3)
