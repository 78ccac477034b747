"""The `psmnet_train_b12` cell on the CPU: its whole run at a tiny size
(traced and untraced), each planted fault turning `correct` false, the
TF32 control failing its check, its per-layer metrics on a made-up window, and the analytic operation count of `references/psmnet.py` against
PyTorch's counter on the reference. The sizes are cut here only: the card
runs the configuration as it stands."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.control import readings
from portbench.core import harness
from portbench.core import program_spans as ps
from portbench.core.harness import Window, metric_module
from portbench.core.trace import WINDOW, Trace
from portbench.references import psmnet as ref

SEED = 2 ** 31 + 12345  # a seed past 32 signed bits
CELL = "psmnet_train_b12"
# batch 2 of 64x128, max disparity 32, the pools scaled to the size: batch
# norms over 2 samples read otherwise than over 12, so the tiny size holds
# its own limits (CPU, three seeds; the program's largest reading against
# the control's least: loss 4.3e-7 / 4.7e-6, disparity 1.4e-3 / 1.0 px,
# gradient 1.3e-2 / 5.0e-2, statistics 4.8e-3 / 2.2e-2; the held step's
# loss 6.6e-8 / 1.4e-6, change 4.8e-5 / 4.9e-3, statistics 1.6e-6 / 5.0e-4)
TINY = {"config": {"height": 64, "width": 128, "batch_size": 2, "max_disp": 32,
                   "spp_pools": [16, 8, 4, 2]},
        "traffic": {"batch_pool": 3, "trace_after": 1, "trace_jobs": 2, "check_span": 1,
                    "limits": {"loss_gap": 1.5e-6, "pred_gap": 0.05, "grad_gap": 0.025,
                               "change_gap": 0.25, "stats_gap": 0.01,
                               "window_loss_gap": 4e-7, "window_change_gap": 5e-4,
                               "window_stats_gap": 3e-5}}}
CPU = torch.device("cpu")
# the cell's per-layer metrics: the stereo net's own, and the training
# step's that it shares with `mono_train_b12`
NEW = {"stereo.mfu", "stereo.features_ms_per_step", "stereo.regularize_ms_per_step",
       "stereo.regress_ms_per_step", "stereo.backward_ms_per_step",
       "stereo.volume_bytes_per_step"}
SHARED = {"train.launches_per_step", "device_idle.train", "train.host_ms_per_step",
          "train.loss_launches_per_step", "train.optimizer_launches_per_step"}


def _run(trace, mode="program"):
    torch.set_num_threads(4)
    return harness.run(CELL, SEED, 1.5, trace, time.perf_counter(), CPU, TINY, mode)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(trace):
    result, lines = _run(trace)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 4
    cell = harness.load_cell(CELL)
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= wanted
    if trace:  # the CPU has no device trace: the program's spans and counter only
        assert wanted == NEW | SHARED
        assert {"stereo.mfu", "train.host_ms_per_step",
                "stereo.volume_bytes_per_step"} <= set(result["metrics"])
        full = 2 * 32 * 64 * 128 * 4
        assert result["metrics"]["stereo.volume_bytes_per_step"]["value"] == (
            2 * 64 * 8 * 16 * 32 * 4 + 9 * full)
    else:
        assert set(result["metrics"]) == wanted == {"train_step_ms", "setup_s"}


@pytest.mark.parametrize("mode", ["fault_unchanged", "fault_half", "fault_loss"])
def test_fault_turns_correct_false(mode):
    result, lines = _run(False, mode)
    assert not result["correct"], lines


def test_control_fails_the_check():
    r = readings(CELL, SEED, 1, "program", CPU, TINY)
    assert r["program_correct"] and not r["control_correct"], r


@pytest.mark.parametrize("n,h,w,d,pools", [(1, 64, 128, 32, (16, 8, 4, 2)),
                                           (2, 64, 64, 16, (8, 4, 2, 1))])
def test_operation_count_matches_the_flop_counter(n, h, w, d, pools):
    torch.manual_seed(0)
    model = ref.PSMNet(d, pools)
    img = torch.rand(n, 3, h, w)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(img, img, False)
    assert fc.get_total_flops() == ref.forward_flops(n, h, w, d, pools)
    assert ref.train_step_flops(n, h, w, d, pools) == 3 * ref.forward_flops(n, h, w, d, pools)


def test_train_step_count_at_the_published_size():
    # 29.0 GMAC a tower and image, 126.7 GMAC of 3D convolutions a pair
    # (a transposed convolution counted over its input)
    assert ref.features_flops(1, 256, 512) == 57_972_965_376
    assert ref.regularize_flops(1, 256, 512) == 253_445_013_504
    assert 13.29e12 < ref.train_step_flops(12, 256, 512) < 13.31e12


MS = 1_000_000  # ns


def test_metrics_on_a_made_up_window(monkeypatch):
    """Three steps: untraced, traced, untraced. The traced one (at 1000 ms)
    launches kernels inside ``psmnet.features`` (1.5 ms), inside
    ``psmnet.regularize`` (2 and 3 ms), inside
    ``psmnet.regress`` (4 ms), inside ``train.loss`` (0.5 ms), inside
    ``train.backward`` (6 and 2 ms, run after the forward's) and inside
    ``train.optimizer`` (1 ms), and one copy."""
    spans, ids = [], iter(range(1, 1000))

    def add(name, t0, t1, parent=None, counters=None):
        i = next(ids)
        s = SimpleNamespace(name=name, id=i, parent=None if parent is None else parent.id,
                            root=i if parent is None else parent.root, thread=1,
                            t0=int(t0 * MS), t1=int(t1 * MS), counters=counters)
        spans.append(s)
        return s

    for T, host_ms in ((0, 40), (1000, 60), (2000, 50)):
        root = add("train.step", T, T + host_ms)
        add("train.optimizer", T + 0.5, T + 1, root)
        fwd = add("train.forward", T + 1, T + 20, root)
        add("psmnet.features", T + 1, T + 2, fwd)
        add("psmnet.cost_volume", T + 2, T + 3, fwd, {"psmnet.volume_bytes": 100})
        add("psmnet.regularize", T + 3, T + 10, fwd)
        add("psmnet.regress", T + 10, T + 15, fwd, {"psmnet.volume_bytes": 900})
        add("train.loss", T + 20, T + 22, root)
        add("train.backward", T + 22, T + 38, root)
        add("train.optimizer", T + 38, T + 40, root)
    monkeypatch.setattr(ps, "tracing", SimpleNamespace(drain=lambda: list(spans)))
    ps._cache.clear()
    host = [(1000 * MS, 1100 * MS, WINDOW)]
    runtime = {1: 1004 * MS, 2: 1005 * MS, 3: 1012 * MS, 4: 1039 * MS, 5: 1012 * MS,
               6: 1021 * MS, 7: 1025 * MS, 8: 1030 * MS, 9: 1001_500_000}
    device = [(1020 * MS, 1022 * MS, "conv3d_kernel", 1), (1022 * MS, 1025 * MS, "bn_kernel", 2),
              (1030 * MS, 1034 * MS, "softmax_kernel", 3), (1060 * MS, 1061 * MS, "adam", 4),
              (1034 * MS, 1035 * MS, "Memcpy DtoH (Device -> Pageable)", 5),
              (1035 * MS, 1035_500_000, "loss_kernel", 6),
              (1040 * MS, 1046 * MS, "wgrad_kernel", 7), (1046 * MS, 1048 * MS, "dgrad_kernel", 8),
              (1018 * MS, 1019_500_000, "fft_gemm_kernel", 9)]
    trace = Trace(device, runtime, host, (1000 * MS, 1100 * MS), jobs=1)
    records = [{"i": i, "t0": 0, "t1": 1, "traced": i == 1, "work": 12} for i in range(3)]
    win = Window(setup_s=1.0, records=records, t_end=9.0, slice_s=3.0, trace=trace)
    win.entry = SimpleNamespace(ctx=SimpleNamespace(config={
        "height": 256, "width": 512, "max_disp": 192, "spp_pools": [64, 32, 16, 8]}))
    try:
        read = {name: metric_module(name).read(win) for name in NEW | SHARED}
    finally:
        ps._cache.clear()
    assert read["stereo.mfu"] == pytest.approx(
        100 * 2 * ref.train_step_flops(12, 256, 512) / 6.0 / 67e12)
    assert read["train.launches_per_step"] == 8
    assert read["device_idle.train"] == pytest.approx(100 * (1 - 0.021 / 0.1))
    assert read["train.host_ms_per_step"] == pytest.approx(45.0)
    assert read["train.loss_launches_per_step"] == 1
    assert read["train.optimizer_launches_per_step"] == 1
    assert read["stereo.features_ms_per_step"] == pytest.approx(1.5)
    assert read["stereo.regularize_ms_per_step"] == pytest.approx(5.0)
    assert read["stereo.regress_ms_per_step"] == pytest.approx(4.0)
    assert read["stereo.backward_ms_per_step"] == pytest.approx(8.0)
    assert read["stereo.volume_bytes_per_step"] == 1000
    ps._cache.clear()
    none = Window(setup_s=1.0, records=records, t_end=9.0)
    none.entry = win.entry
    monkeypatch.setattr(ps, "tracing", None)  # a program without the tracer
    for name in (NEW | SHARED) - {"stereo.mfu"}:
        assert metric_module(name).read(none) is None, name
    ps._cache.clear()
