"""Every cell's whole run end to end on the CPU at a tiny size (the
harness's look for a card skipped), each fault that the cell can have
planted in the timed path and seen to turn `correct` false, and each
cell's control seen to fail its check. The sizes are cut here only: the
card runs the configurations as they stand."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.control import readings
from portbench.core import harness

SEED = 2 ** 31 + 12345  # a seed past 32 signed bits
F = 600.391 * 240 / 640
TINY = {
    "uav_sfm_12f": {"config": {"camera": {"width": 240, "height": 180, "fx": F,
                                          "fy": F * 600.079 / 600.391, "cx": 120.0, "cy": 90.0},
                               "sfm": {"max_keypoints": 192, "overlap": 3, "ba_every": 3}},
                    # at 240x180 the program's ATE reads 1.4e-2 (1.4e-3 at 480x640);
                    # the altered pose txt reads 9.0e-2
                    "traffic": {"scene_pool": 2, "trace_jobs": 1,
                                "limits": {"ate_share": 0.04, "matcher_gap": 3e-05}}},
    "uav_fuse_16f": {"config": {"camera": {"width": 64, "height": 48, "fx": 60.0, "fy": 60.0,
                                           "cx": 32.0, "cy": 24.0}},
                     "traffic": {"frames": 4, "check_span": 4, "check_jobs": 1,
                                 "trace_after": 1, "trace_jobs": 2}},
    "mono_infer_fuse": {"config": {"height": 64, "width": 96},
                        "traffic": {"frames": 4, "chunk": 2, "check_span": 3, "check_jobs": 1,
                                    "trace_after": 1, "trace_jobs": 2, "sequence_pool": 2}},
    # at batch 2 of 64x96 the readings differ from the cell's, so the tiny
    # size holds its own limits (CPU, six seeds: the first step's loss,
    # program at most 7.7e-7, control at least 1.5e-5; three seeds: the
    # gradient 2.6e-3 against 0.035, and the window's held step at most
    # 8.1e-7, 5.0e-4 and 3.4e-6 (loss, change, statistics) against at
    # least 3.6e-6, 2.4e-3 and 2.6e-4)
    "mono_train_b12": {"config": {"height": 64, "width": 96, "batch_size": 2},
                       "traffic": {"batch_pool": 4, "trace_after": 1, "trace_jobs": 2,
                                   "check_span": 1,
                                   "limits": {"loss_gap": 5e-6, "grad_gap": 1e-2,
                                              "change_gap": 0.05, "stats_gap": 1e-3,
                                              "window_loss_gap": 1e-5, "window_change_gap": 2e-3,
                                              "window_stats_gap": 5e-5}}},
}
FAULTS = [("uav_sfm_12f", "fault_matcher"), ("uav_sfm_12f", "fault_poses"),
          ("uav_fuse_16f", "fault_half"), ("uav_fuse_16f", "fault_points"),
          ("mono_infer_fuse", "fault_depth"),
          ("mono_train_b12", "fault_unchanged"), ("mono_train_b12", "fault_half"),
          ("mono_train_b12", "fault_loss")]
CPU = torch.device("cpu")


def _run(cell, trace, mode="program"):
    torch.set_num_threads(4)
    seconds = 0.0 if cell == "uav_sfm_12f" else 1.5
    return harness.run(cell, SEED, seconds, trace, time.perf_counter(), CPU, TINY[cell], mode)


# the SfM cell's untraced run is the traced one's loop; one CPU run of it will do
RUNS = [(c, t) for c in sorted(TINY) for t in (False, True) if t or c != "uav_sfm_12f"]


@pytest.mark.parametrize("cell,trace", RUNS)
def test_cell_runs_correct(cell, trace):
    result, lines = _run(cell, trace)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks" and len(lines) == len(result["checks"])
    cellspec = harness.load_cell(cell)
    wanted = {m["name"] for m in (cellspec.per_layer if trace else cellspec.end_to_end)}
    assert set(result["metrics"]) <= wanted
    if trace:
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert set(result["metrics"]) == wanted


@pytest.mark.parametrize("cell,mode", FAULTS)
def test_fault_turns_correct_false(cell, mode):
    result, lines = _run(cell, False, mode)
    assert not result["correct"], lines


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_the_check(cell):
    r = readings(cell, SEED, 1, "program", CPU, TINY[cell])
    assert r["program_correct"] and not r["control_correct"], r
