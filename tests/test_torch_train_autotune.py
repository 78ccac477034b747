"""cuDNN's autotuner in every net's training step
(`models/training.py::train_step_skeleton`, `core/fp.py::cudnn_autotune`):
Monodepth2's step (`make_train_step`, pose net), the PSMNet-class
sibling's and the published PSMNet's
(`models/psmnet_training.py::make_stereo_train_step`). The flag
``torch.backends.cudnn.benchmark`` is on, with ``benchmark_limit`` at
`fp.AUTOTUNE_CANDIDATES`, while the nets' forward and autograd's backward
run, and both are back to what they were after a step and after a step
that raises; the ``train.step`` span counts ``train.autotuned_steps``,
0 on the CPU and 1 a step on a card (marker ``gpu``). This file imports no
JAX, so on a machine without it the card's test runs as ``PYTHONPATH=.
python -m pytest --noconftest -m gpu tests/test_torch_train_autotune.py``.
"""

import pytest
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.models import psmnet_training as tpt
from tpu3drec_torch.models import training as tt
from tpu3drec_torch.utils import tracing

torch.set_num_threads(2)

N, H, W, MAX_DISP, POOLS = 2, 32, 64, 16, (4, 2, 2, 1)
NETS = ("monodepth2", "psmnet_class", "stackhourglass")


@pytest.fixture(autouse=True)
def clean():
    """Every test starts with the autotuner off and the tracer off and
    empty, and leaves them so."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.benchmark_limit
    cudnn.benchmark = False
    tracing.disable()
    tracing.drain()
    yield
    cudnn.benchmark, cudnn.benchmark_limit = saved
    tracing.disable()
    tracing.drain()


def _setup(net, device="cpu"):
    """(step(state, batch), state, batch) of ``net`` on ``device``: a
    constant automask tiebreak for Monodepth2, or a stereo arch."""
    g = torch.Generator().manual_seed(2)
    if net == "monodepth2":
        cfg = tt.TrainConfig(height=H, width=W, batch_size=N)
        _, state = tt.init_state(1, cfg, device=device)
        batch = {k: torch.rand(N, H, W, 3, generator=g) for k in ("target", "prev", "next")}
        return tt.make_train_step(cfg), state, batch
    cfg = tpt.StereoTrainConfig(arch=net, max_disp=MAX_DISP, spp_pools=POOLS, feat_ch=8,
                                batch_size=N, height=H, width=W)
    _, state = tpt.init_stereo_state(1, cfg, device=device)
    batch = {"left": torch.rand(N, H, W, 3, generator=g),
             "right": torch.rand(N, H, W, 3, generator=g),
             "disp": torch.rand(N, H, W, generator=g) * 20, "mask": torch.ones(N, H, W)}
    return tpt.make_stereo_train_step(cfg), state, batch


def _first_conv(model):
    return next(m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)))


def _flags():
    return torch.backends.cudnn.benchmark, torch.backends.cudnn.benchmark_limit


class _ReadFlag(torch.autograd.Function):
    """Identity that notes the flags when autograd runs its backward."""

    @staticmethod
    def forward(ctx, x, seen):
        ctx.seen = seen
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.seen["backward"] = _flags()
        return g, None


@pytest.mark.parametrize("net", NETS)
def test_autotuner_on_in_forward_and_backward_and_off_after(net):
    step, state, batch = _setup(net)
    seen = {}

    def hook(module, args, out):
        seen["forward"] = _flags()
        return _ReadFlag.apply(out, seen)

    _first_conv(state.model).register_forward_hook(hook)
    before = _flags()
    step(state, batch)
    tuned = (True, fp.AUTOTUNE_CANDIDATES)
    assert seen == {"forward": tuned, "backward": tuned}
    assert _flags() == before and before[0] is False


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("before", [False, True])
def test_a_step_that_raises_puts_the_flag_back(net, before):
    step, state, batch = _setup(net)

    def hook(module, args, out):
        assert _flags() == (True, fp.AUTOTUNE_CANDIDATES)
        raise RuntimeError("raised in the forward")

    _first_conv(state.model).register_forward_hook(hook)
    torch.backends.cudnn.benchmark = before
    flags = _flags()
    with pytest.raises(RuntimeError, match="raised in the forward"):
        step(state, batch)
    assert _flags() == flags and flags[0] is before


@pytest.mark.parametrize("net", NETS)
def test_steps_on_the_cpu_count_no_autotuned_step(net):
    step, state, batch = _setup(net)
    tracing.enable()
    step(state, batch)
    (root,) = [s for s in tracing.drain() if s.name == "train.step"]
    assert root.counters == {"train.autotuned_steps": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("net", NETS)
def test_steps_on_the_card_count_each_autotuned_step(net):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    step, state, batch = _setup(net, "cuda")
    seen = []
    _first_conv(state.model).register_forward_hook(
        lambda module, args, out: seen.append(_flags()))
    before = _flags()
    tracing.enable()
    for _ in range(3):
        loss = step(state, batch)[1]  # Monodepth2's step returns aux too
    torch.cuda.synchronize()
    roots = [s for s in tracing.drain() if s.name == "train.step"]
    assert [s.counters["train.autotuned_steps"] for s in roots] == [1, 1, 1]
    # a net may call its first convolution more than once a step (both towers)
    assert seen and set(seen) == {(True, fp.AUTOTUNE_CANDIDATES)} and len(seen) % 3 == 0
    assert _flags() == before and before[0] is False
    assert torch.isfinite(loss)
