"""Each metric's arithmetic on a synthetic trace and synthetic job records."""

from __future__ import annotations

import math
import statistics
from collections import defaultdict

import pytest

from portbench.core.harness import Window, metric_module
from portbench.core.roofline import bound_seconds, matcher_work
from portbench.core.spans import PREFIX, Spans
from portbench.core.trace import WINDOW, Trace, merge
from portbench.references.monodepth2 import depth_forward_flops, train_step_flops

MS = 1_000_000  # ns


def _trace():
    """A 100 ms slice: a match_pairs span over 10-40 ms launching two
    kernels (5 ms, 5 ms) and a copy; a kernel outside the span; host ops."""
    host = [(0, 100 * MS, WINDOW), (10 * MS, 40 * MS, PREFIX + "match_pairs"),
            (12 * MS, 13 * MS, "aten::mm"), (50 * MS, 60 * MS, "aten::item")]
    runtime = {1: 12 * MS, 2: 14 * MS, 3: 20 * MS, 4: 55 * MS}
    device = [(15 * MS, 20 * MS, "matcher_kernel", 1), (18 * MS, 23 * MS, "matcher_kernel", 2),
              (25 * MS, 26 * MS, "Memcpy DtoH (Device -> Pageable)", 3),
              (60 * MS, 70 * MS, "elementwise_kernel", 4),
              (150 * MS, 160 * MS, "after_the_window", 5)]
    return Trace(device, runtime, host, (0, 100 * MS), jobs=2)


def test_trace_reduction():
    t = _trace()
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.019)  # 15-23, 25-26, 60-70
    assert t.launches == 3
    assert t.kernel_seconds_under(["match_pairs"]) == pytest.approx(0.010)
    assert t.kernel_seconds_under(["voxelize"]) is None
    assert dict(t.top_device_ops()) == pytest.approx(
        {"matcher_kernel": 0.010, "elementwise_kernel": 0.010,
         "Memcpy DtoH (Device -> Pageable)": 0.001})
    # each gap goes whole to what the host was doing as it began
    assert dict(t.idle_gaps()) == pytest.approx(
        {"window > python": 0.015 + 0.030,          # 0-15, 70-100
         "match_pairs > python": 0.002 + 0.034})    # 23-25, 26-60
    late = Trace(t.device[:1], t.runtime, t.host, (50 * MS, 60 * MS), jobs=1)
    assert dict(late.idle_gaps()) == pytest.approx({"window > aten::item": 0.010})
    assert merge([(3, 4), (1, 2), (2, 3)]) == [[1, 4]]


def _window(records, trace=None, spans=None, config=None):
    w = Window(setup_s=12.5, records=records, t_end=10.0, trace=trace, spans=spans)
    w.entry = type("E", (), {"ctx": type("C", (), {"config": config or {}})()})()
    return w


def test_end_to_end_readers():
    recs = [{"i": i, "t0": i * 0.1, "t1": i * 0.1 + 0.05 + 0.001 * i, "traced": False,
             "work": 16} for i in range(20)]
    recs.append({"i": 20, "t0": 2.0, "t1": 2.1, "traced": False, "work": 0, "failed": True})
    w = _window(recs)
    assert metric_module("map_frames_per_s").read(w) == pytest.approx(20 * 16 / 10.0)
    assert metric_module("sfm_frames_per_s").read(w) == pytest.approx(32.0)
    ms = [(r["t1"] - r["t0"]) * 1e3 for r in recs[:20]]
    assert metric_module("map_job_p90_ms").read(w) == pytest.approx(
        statistics.quantiles(ms, n=10, method="inclusive")[-1])
    assert metric_module("train_step_ms").read(w) == pytest.approx(10.0 / 20 * 1e3)
    assert metric_module("setup_s").read(w) == 12.5
    assert metric_module("map_job_p90_ms").read(_window(recs[:5])) is None
    # per layer, over the untraced jobs only
    for r in recs[:5]:
        r["traced"] = True
    assert metric_module("fuse.job_p90_ms").read(w) == pytest.approx(
        statistics.quantiles(ms[5:], n=10, method="inclusive")[-1])


def test_per_layer_readers():
    t = _trace()
    spans = Spans([])
    spans.traced_calls["match_pairs"] = [[(12, 512, 128), (12, 512), (30, 2)]]
    recs = [{"i": i, "t0": 0, "t1": 1, "traced": i in (1, 2), "work": 12,
             "seconds": {"verify": 1.0, "register": 0.5 + i, "ba": 2.0}} for i in range(4)]
    w = _window(recs, t, spans, {"height": 192, "width": 640})
    w.slice_s = 4.0
    assert metric_module("sfm.verify_register_s").read(w) == pytest.approx((1.5 + 4.5) / 2)
    assert metric_module("sfm.ba_s").read(w) == pytest.approx(2.0)
    assert metric_module("sfm.launches_per_job").read(w) == pytest.approx(1.5)
    for name in ("device_idle.sfm", "device_idle.map", "device_idle.train"):
        assert metric_module(name).read(w) == pytest.approx(81.0)
    need = bound_seconds(*matcher_work(30, 512, 512, 128))[0]
    assert metric_module("matcher_roofline").read(w) == pytest.approx(100 * need / 0.010)
    assert metric_module("fusion_roofline").read(w) is None  # no span ran
    assert metric_module("train.mfu").read(w) == pytest.approx(
        100 * 2 * train_step_flops(12, 192, 640) / 6.0 / 67e12)


def test_span_tallies_feed_the_host_readers():
    spans = Spans([])
    spans.seconds["write_bt_sharded"] = [0.010, 0.030]
    spans.seconds["infer_depth_maps"] = [0.050, 0.050]
    spans.calls["infer_depth_maps"] = [[None, (16, 192, 640, 3), None]] * 2
    w = _window([], spans=spans)
    assert metric_module("export.bt_ms").read(w) == pytest.approx(20.0)
    assert metric_module("infer.mfu").read(w) == pytest.approx(
        100 * 2 * depth_forward_flops(16, 192, 640) / 0.1 / 67e12)
    spans.traced_calls["fuse_arrays"] = [[(16, 480, 640), (16, 4), (16, 3)]]
    host = [(0, 10 * MS, WINDOW), (1 * MS, 2 * MS, PREFIX + "fuse_arrays"),
            (2 * MS, 3 * MS, PREFIX + "unique_voxels")]
    t = Trace([(1 * MS, 3 * MS, "k1", 7), (2 * MS, 4 * MS, "k2", 8)],
              {7: int(1.5 * MS), 8: int(2.5 * MS)}, host, (0, 10 * MS), jobs=1)
    w = _window([], t, spans)
    need = 42 * 16 * 480 * 640 / 3.35e12
    assert metric_module("fusion_roofline").read(w) == pytest.approx(100 * need / 0.004)


def test_spans_wrap_and_restore():
    import portbench.core.roofline as mod

    before = mod.matcher_work
    spans = Spans(["portbench.core.roofline:matcher_work"])
    spans.install()
    try:
        assert mod.matcher_work(1, 2, 3, 4) == before(1, 2, 3, 4)
        spans.tally = False
        mod.matcher_work(1, 2, 3, 4)
    finally:
        spans.remove()
    assert mod.matcher_work is before
    assert len(spans.seconds["matcher_work"]) == 1 and len(spans.traced_calls["matcher_work"]) == 1
    assert math.isfinite(spans.seconds["matcher_work"][0])
    assert isinstance(spans.calls, defaultdict)
