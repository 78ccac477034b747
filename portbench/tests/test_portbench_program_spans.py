"""The readers of the program's own spans and counters
(`portbench/core/program_spans.py` and the metrics that import it) on
made-up windows: the pairing of root spans with the window's jobs, each
metric's arithmetic, the idle gaps by program span and the clock check."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.core import program_spans as ps
from portbench.core.harness import Window, metric_module
from portbench.core.spans import PREFIX
from portbench.core.trace import WINDOW, Trace

MS = 1_000_000  # ns


class Jobs:
    """Made-up finished spans, built job by job (times in ms)."""

    def __init__(self):
        self.spans, self._id = [], 0

    def add(self, name, t0, t1, parent=None, counters=None):
        self._id += 1
        root = self._id if parent is None else parent.root
        s = SimpleNamespace(name=name, id=self._id, parent=None if parent is None else parent.id,
                            root=root, thread=1, t0=int(t0 * MS), t1=int(t1 * MS),
                            counters=counters)
        self.spans.append(s)
        return s


@pytest.fixture
def tracer(monkeypatch):
    """The made-up spans in place of the program's tracer."""
    made = Jobs()
    monkeypatch.setattr(ps, "tracing", SimpleNamespace(drain=lambda: list(made.spans)))
    ps._cache.clear()
    yield made
    ps._cache.clear()


def _window(records, trace=None):
    return Window(setup_s=1.0, records=records, t_end=10.0, trace=trace)


def _records(*kinds, work=12):
    """One record a job: "u" untraced, "t" traced, "f" failed (untraced)."""
    return [{"i": i, "t0": 0, "t1": 1, "traced": k == "t", "work": work,
             **({"failed": True, "work": 0} if k == "f" else {})} for i, k in enumerate(kinds)]


def _sfm_job(made, T, iters=(5, 7), attempts=(1, 2)):
    """An SfM job at T ms: two frames tried (the first with a PnP and a BA
    nested in it), then a closing BA."""
    job = made.add("sfm.job", T, T + 100)
    made.add("sfm.detect", T, T + 5, job)
    made.add("sfm.match", T + 5, T + 8, job)
    a = made.add("sfm.register.frame", T + 10, T + 40, job, {"sfm.pnp.attempts": attempts[0]})
    made.add("sfm.pnp", T + 12, T + 15, a)
    ba = made.add("sfm.ba", T + 20, T + 35, a)
    made.add("ba.solve", T + 22, T + 32, ba, {"ba.lm_iters": iters[0]})
    made.add("sfm.register.frame", T + 50, T + 60, job, {"sfm.pnp.attempts": attempts[1]})
    ba = made.add("sfm.ba", T + 70, T + 90, job)
    made.add("ba.solve", T + 71, T + 89, ba, {"ba.lm_iters": iters[1]})
    return job


def _sfm_window(made):
    """A warm-up job, then four: untraced, traced, untraced, failed; the
    traced and the failed job count other numbers, which no host-clock
    reader may take. The trace covers the traced job (at 1000 ms): a
    kernel and three host reads inside its frames, one read outside them."""
    _sfm_job(made, -500, iters=(90, 90), attempts=(9, 9))
    _sfm_job(made, 0)
    _sfm_job(made, 1000, iters=(50, 50), attempts=(5, 5))
    _sfm_job(made, 2000)
    _sfm_job(made, 3000, iters=(70, 70), attempts=(7, 7))
    T = 1000
    runtime = {1: (T + 12) * MS, 2: (T + 25) * MS, 3: (T + 55) * MS, 4: (T + 80) * MS,
               5: (T + 13) * MS}
    dtoh = "Memcpy DtoH (Device -> Pageable)"
    device = [((T + 13) * MS, (T + 14) * MS, dtoh, 1), ((T + 26) * MS, (T + 27) * MS, dtoh, 2),
              ((T + 56) * MS, (T + 57) * MS, dtoh, 3), ((T + 81) * MS, (T + 82) * MS, dtoh, 4),
              ((T + 14) * MS, (T + 16) * MS, "some_kernel", 5)]
    host = [(T * MS, (T + 100) * MS, WINDOW)]
    trace = Trace(device, runtime, host, (T * MS, (T + 100) * MS), jobs=1)
    return _window(_records("u", "t", "u", "f"), trace)


def _train_window(made):
    """Two warm-up steps, then untraced, traced, traced, untraced steps (the
    last one 60 ms long); the traced steps launch kernels inside their loss
    (3, then 5) and their optimizer spans (1 + 2, then 3), and a copy in
    the loss, which is no kernel."""
    runtime, device, corr = {}, [], iter(range(1, 100))

    def launch(at, name="k"):
        c = next(corr)
        runtime[c] = int(at * MS)
        device.append((int(at * MS), int((at + 0.5) * MS), name, c))

    for T in (-200, -100, 0, 100, 200, 300):
        step = made.add("train.step", T, T + (60 if T == 300 else 50))
        made.add("train.optimizer", T + 1, T + 2, step)
        made.add("train.forward", T + 3, T + 20, step)
        made.add("train.loss", T + 20, T + 30, step)
        made.add("train.backward", T + 30, T + 45, step)
        made.add("train.optimizer", T + 45, T + 49, step)
        if T in (100, 200):
            for j in range(3 if T == 100 else 5):
                launch(T + 21 + j)
            launch(T + 25, "Memcpy DtoH (Device -> Pageable)")
            launch(T + 1.5)
            for j in range(2 if T == 100 else 3):
                launch(T + 46 + j)
            if T == 200:  # the first optimizer span launches nothing in this step
                device.pop(-4)
            launch(T + 35)  # backward
    trace = Trace(device, runtime, [(100 * MS, 250 * MS, WINDOW)], (100 * MS, 250 * MS), jobs=2)
    return _window(_records("u", "t", "t", "u"), trace)


def _map_job(made, T, infer=True):
    """A map job at T ms: depth inference (with ``infer``), then fusion."""
    if infer:
        d = made.add("infer.depth", T, T + 20)
        made.add("infer.to_device", T + 1, T + 3, d, {"bytes_to_device": 100})
        made.add("infer.net", T + 3, T + 15, d)
        made.add("infer.to_host", T + 15, T + 19, d, {"bytes_to_host": 40})
    m = made.add("map.job", T + 20, T + 40)
    made.add("map.to_device", T + 21, T + 22, m, {"bytes_to_device": 30})
    made.add("map.fuse", T + 22, T + 25, m)
    made.add("map.voxel", T + 25, T + 30, m)
    made.add("map.to_host", T + 30, T + 32, m, {"bytes_to_host": 8})
    made.add("map.write_bt", T + 32, T + 36, m)
    made.add("map.to_host", T + 36, T + 39, m, {"bytes_to_host": 60})


def _map_window(made, infer=True):
    """A warm-up job, then untraced, traced, untraced jobs of 4 frames."""
    for T in (-100, 0, 100, 200):
        _map_job(made, T, infer)
    return _window(_records("u", "t", "u", work=4))


# metric -> (window, value)
CASES = {
    "sfm.ba_solve_s": (_sfm_window, 0.028),
    "sfm.ba_host_s": (_sfm_window, 0.007),                 # (15 - 10) + (20 - 18) ms
    "sfm.lm_iters_per_job": (_sfm_window, 12.0),
    "sfm.lm_ms_per_iter": (_sfm_window, 28.0 / 12),
    "sfm.register_ms_per_frame": (_sfm_window, 12.5),      # (30 - 15 + 10) ms / 2 frames
    "sfm.pnp_attempts_per_frame": (_sfm_window, 3 / 12),
    "sfm.host_reads_per_frame": (_sfm_window, 1.5),        # 3 reads / 2 frames
    "train.host_ms_per_step": (_train_window, 55.0),
    "train.loss_launches_per_step": (_train_window, 4.0),
    "train.optimizer_launches_per_step": (_train_window, 3.0),
    "map.to_host_ms": (_map_window, 9.0),
    "map.bytes_to_host_per_frame": (_map_window, 108 / 4),
    "map.bytes_to_device_per_frame": (_map_window, 130 / 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_reads_the_made_up_window(tracer, name):
    make, want = CASES[name]
    assert metric_module(name).read(make(tracer)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_finds_nothing_without_the_tracer(monkeypatch, name):
    """Against a program that has no tracer every reader returns None."""
    monkeypatch.setattr(ps, "tracing", None)
    ps._cache.clear()
    made = Jobs()
    assert metric_module(name).read(CASES[name][0](made)) is None
    ps._cache.clear()


def test_map_readers_without_depth_inference(tracer):
    w = _map_window(tracer, infer=False)
    assert metric_module("map.to_host_ms").read(w) == pytest.approx(5.0)
    assert metric_module("map.bytes_to_host_per_frame").read(w) == pytest.approx(68 / 4)
    assert metric_module("map.bytes_to_device_per_frame").read(w) == pytest.approx(30 / 4)


def test_roots_pair_with_records(tracer):
    """The warm-up's roots are left out, a failed job keeps its root (so the
    jobs after it pair with their own), and too few roots read nothing."""
    w = _sfm_window(tracer)
    jobs = ps.jobs(w, "sfm.job")
    assert [r["i"] for r, _ in jobs] == [0, 2]
    assert [ps.counter(s, "ba.lm_iters") for _, s in jobs] == [12, 12]
    (traced,) = ps.jobs(w, "sfm.job", traced=True)
    assert traced[0]["i"] == 1 and ps.counter(traced[1], "ba.lm_iters") == 100
    assert ps.jobs(w, "train.step") is None  # a root the program never opened
    short = _window(_records("u", "u", "u", "u", "u", "u"))
    assert ps.jobs(short, "sfm.job") is None


def test_idle_gaps_go_to_the_innermost_program_span(tracer):
    """The traced job's device is busy 13-16, 26-27, 56-57 and 81-82 ms into
    it; each gap goes whole to the innermost program span and host op open
    as it began (the harness's own spans are no host op)."""
    w = _sfm_window(tracer)
    t = w.trace
    t.host = sorted(t.host + [(1080 * MS, 1085 * MS, "aten::add")])
    assert dict(ps.idle_by_span(w)) == pytest.approx({
        "sfm.detect > python": 0.013,                    # 0-13
        "sfm.register.frame > python": 0.010 + 0.024,    # 16-26 (after the PnP), 57-81
        "ba.solve > python": 0.029,                      # 27-56
        "ba.solve > aten::add": 0.018})                  # 82-100
    assert sum(v for _, v in ps.idle_by_span(w)) == pytest.approx(0.1 - t.busy_s)


def test_clock_check_against_the_harness_s_spans(tracer):
    made = tracer
    job = made.add("sfm.job", 0, 100)
    m = made.add("sfm.match", 10, 30, job)
    runtime = {1: 12 * MS, 2: 28 * MS}
    device = [(13 * MS, 14 * MS, "matcher", 1), (29 * MS, 31 * MS, "matcher", 2)]
    host = [(0, 100 * MS, WINDOW), (10 * MS + 20_000, 29 * MS, PREFIX + "match_pairs")]
    w = _window(_records("t"), Trace(device, runtime, host, (0, 100 * MS), jobs=1))
    got = ps.clock_check(w, made.spans)
    assert got == {"match_pairs": {"calls": 1, "start_us": pytest.approx([20.0, 20.0]),
                                   "end_us": pytest.approx([1000.0, 1000.0]), "kernels": 2,
                                   "kernels_in_program_span": 2}}
    assert m.t0 <= host[1][0]
