"""Program spans and counters of every net's training step
(`models/training.py::train_step_skeleton`) on the CPU: Monodepth2's
(`make_train_step`, pose net), the PSMNet-class sibling's and the published
PSMNet's (`models/psmnet_training.py::make_stereo_train_step`,
``arch="stackhourglass"``, `models/psmnet.py::StackHourglassPSMNet`). Each
step's phase spans under one ``train.step`` root, in order; for the
published net also the forward's ``psmnet.*`` spans and
``psmnet.volume_bytes`` against the bytes the shapes give; nothing recorded
with the tracer off, and the same operators (so the same launches and host
reads) either way.
"""

import functools
from collections import Counter

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu3drec_torch.models import psmnet_training as tpt
from tpu3drec_torch.models import training as tt
from tpu3drec_torch.utils import tracing

torch.set_num_threads(2)

N, H, W, MAX_DISP, POOLS = 2, 32, 64, 16, (4, 2, 2, 1)
NETS = ("monodepth2", "psmnet_class", "stackhourglass")
PHASES = ["train.optimizer", "train.forward", "train.loss", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True)
def tracer():
    """Every test starts and ends with the tracer off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _setup(net):
    """(step(state, batch), state, batch) of ``net``: Monodepth2 with the
    pose net and the automask noise drawn in the step, or a stereo arch."""
    g = torch.Generator().manual_seed(2)
    if net == "monodepth2":
        cfg = tt.TrainConfig(height=H, width=W, batch_size=N)
        _, state = tt.init_state(1, cfg, device="cpu")
        batch = {k: torch.rand(N, H, W, 3, generator=g) for k in ("target", "prev", "next")}
        step = functools.partial(tt.make_train_step(cfg), rng=torch.Generator().manual_seed(3))
        return step, state, batch
    cfg = tpt.StereoTrainConfig(arch=net, max_disp=MAX_DISP, spp_pools=POOLS, feat_ch=8,
                                batch_size=N, height=H, width=W)
    _, state = tpt.init_stereo_state(1, cfg, device="cpu")
    batch = {"left": torch.rand(N, H, W, 3, generator=g),
             "right": torch.rand(N, H, W, 3, generator=g),
             "disp": torch.rand(N, H, W, generator=g) * 20, "mask": torch.ones(N, H, W)}
    return tpt.make_stereo_train_step(cfg), state, batch


class _Ops(TorchDispatchMode):
    """Counts every operator dispatched (on the card, each a launch or a
    copy) and the reads of a value back to the host."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("net", NETS)
def test_step_spans_nest_under_one_root_and_count_the_volumes(net):
    step, state, batch = _setup(net)
    tracing.enable()
    step(state, batch)
    spans = tracing.drain()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (root,) = by["train.step"]
    assert root.parent is None and all(s.root == root.id for s in spans)
    for name in ("train.forward", "train.loss", "train.backward"):
        assert [s.parent for s in by[name]] == [root.id], name
    assert [s.parent for s in by["train.optimizer"]] == [root.id, root.id]
    order = [s.name for s in sorted(spans, key=lambda s: s.t0)]
    if net != "stackhourglass":
        assert order == ["train.step"] + PHASES
        return
    (fwd,) = by["train.forward"]
    for name in ("psmnet.features", "psmnet.cost_volume", "psmnet.regularize",
                 "psmnet.regress"):
        assert [s.parent for s in by[name]] == [fwd.id], name
    assert order == ["train.step", "train.optimizer", "train.forward", "psmnet.features",
                     "psmnet.cost_volume", "psmnet.regularize", "psmnet.regress", "train.loss",
                     "train.backward", "train.optimizer"]
    cost = N * 64 * (MAX_DISP // 4) * (H // 4) * (W // 4) * 4  # float32 concatenation volume
    full = N * MAX_DISP * H * W * 4  # one full-resolution volume
    assert by["psmnet.cost_volume"][0].counters == {"psmnet.volume_bytes": cost}
    assert by["psmnet.regress"][0].counters == {"psmnet.volume_bytes": 3 * 3 * full}
    assert sum((s.counters or {}).get("psmnet.volume_bytes", 0) for s in spans) == (
        cost + 9 * full)


@pytest.mark.parametrize("net", NETS)
def test_tracer_off_records_nothing_and_dispatches_the_same_operators(net):
    step, state, batch = _setup(net)
    step(state, batch)  # first-call caches outside the comparison
    counted = {}
    for on in (False, True):
        if on:
            tracing.enable()
        with _Ops() as ops:
            step(state, batch)
        counted[on] = ops.ops
        spans = tracing.drain()
        assert bool(spans) == on
        tracing.disable()
    # every operator alike, reads of a value to the host (here only Adam's
    # step counts, which live on the host) included
    assert counted[True] == counted[False] and counted[True]["aten.convolution"] > 0
