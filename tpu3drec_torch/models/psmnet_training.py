"""PSMNet training (port of `tpu3drec/models/psmnet_training.py`):
supervised smooth-L1 on ground-truth disparity, one step = forward, loss
over valid-disparity pixels, backward, Adam update.

``StereoTrainConfig.arch`` picks the net, its initialisation and its loss
from `ARCHS`: ``"psmnet_class"`` (the default), the PSMNet-class sibling
that the JAX package has, flax's initialisers, one output; or
``"stackhourglass"``, the published PSMNet
(`models/psmnet.py::StackHourglassPSMNet`), its initialisation and loss.

As in `models/training.py`, the module holds the weights and batch
statistics and ``torch.optim.Adam`` (optax's defaults) the moments:
`init_stereo_state` returns (model, state), the step
(`models/training.py::train_step_skeleton`) updates both in place, and
`make_stereo_eval(model)` takes no parameter trees. With a mesh the loss
is the global batch's: its valid-pixel count is all-reduced.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.models.psmnet import (
    SPP_POOLS, PSMNet, StackHourglassPSMNet, init_psmnet_params, smooth_l1_terms)
from tpu3drec_torch.models.training import (
    TrainState, at_least_f32, init_flax_params, make_optimizer, train_step_skeleton)
from tpu3drec_torch.parallel.mesh import all_reduce
from tpu3drec_torch.utils.device import resolve_device

HEAD_WEIGHTS = (0.5, 0.7, 1.0)  # the published main.py's weights of the three heads


@dataclass
class StereoTrainConfig:
    learning_rate: float = 1e-3     # PSMNet's published Adam lr
    num_epochs: int = 10
    batch_size: int = 4
    height: int = 256
    width: int = 512
    max_disp: int = 64
    feat_ch: int = 32               # the sibling's width; the published net's are fixed
    compute_dtype: str = "float32"  # "bfloat16": the net under bf16 autocast
    arch: str = "psmnet_class"      # a key of ARCHS
    # the stacked hourglass's SPP pools, in px at 1/4: published; only tests
    # and the benchmark's CPU-sized cell set smaller ones, for small inputs
    spp_pools: tuple = SPP_POOLS


def _sibling_loss(cfg, pred, gt, mask, total):
    """Smooth L1 over ``mask``."""
    num, den = smooth_l1_terms(at_least_f32(pred), gt, mask)
    return num / total(den)


def _stack_loss(cfg, preds, gt, mask, total):
    """main.py's 0.5 L1 + 0.7 L2 + L3 over ``mask`` and 0 <= disparity < max_disp."""
    mask = mask * ((gt >= 0) & (gt < cfg.max_disp)).to(mask.dtype)
    terms = [smooth_l1_terms(at_least_f32(p), gt, mask) for p in preds]
    den = total(terms[0][1])
    return sum(wt * num / den for wt, (num, _) in zip(HEAD_WEIGHTS, terms))


# the nets by arch name: (net(cfg, spp_pools), init(net, generator), loss(cfg,
# outputs, gt, mask, total)); total(den): the global batch's valid pixels, >= 1
ARCHS = {
    "psmnet_class": (lambda cfg, pools: PSMNet(max_disp=cfg.max_disp, feat_ch=cfg.feat_ch),
                     init_flax_params, _sibling_loss),
    "stackhourglass": (lambda cfg, pools: StackHourglassPSMNet(cfg.max_disp, tuple(pools)),
                       init_psmnet_params, _stack_loss),
}


def _arch(name: str):
    if name not in ARCHS:
        raise ValueError(f"arch must be one of {tuple(ARCHS)}, not {name!r}")
    return ARCHS[name]


def build_stereo_model(cfg, generator: torch.Generator,
                       spp_pools=SPP_POOLS) -> torch.nn.Module:
    """The net ``cfg.arch`` names in `ARCHS` (``cfg``: a `StereoTrainConfig`
    or `pipelines/stereo.py::StereoPipelineConfig`), on the CPU, initialised
    from ``generator`` (the stacked hourglass with SPP pools ``spp_pools``)."""
    net, init, _ = _arch(cfg.arch)
    model = net(cfg, spp_pools)
    init(model, generator)
    return model


def init_stereo_state(seed, cfg: StereoTrainConfig, device=None):
    """A fresh net of ``cfg.arch`` on ``device`` (default the card), its
    weights drawn on the CPU from ``seed`` (an int or a CPU
    ``torch.Generator``), and its Adam optimizer. Returns (model, state)."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    model = build_stereo_model(cfg, gen, cfg.spp_pools)
    model.to(dev)
    lr = cfg.learning_rate
    state = TrainState(model, make_optimizer(cfg, model.parameters()), lambda step: lr)
    return model, state


def to_model(model: torch.nn.Module, x, image: bool = False) -> torch.Tensor:
    """A numpy array or tensor -> a tensor on the model's device in its
    floating dtype; ``image``: NHWC -> NCHW."""
    p = next(model.parameters())
    x = torch.as_tensor(x, dtype=p.dtype, device=p.device)
    return x.permute(0, 3, 1, 2) if image else x


def make_stereo_train_step(cfg: StereoTrainConfig, mesh=None, axis: str = "data"):
    """``train_step(state, batch) -> (state, loss)``: batch dict with
    "left"/"right" (N, H, W, 3) in [0, 1], "disp" (N, H, W) ground-truth
    disparity in pixels and "mask" (N, H, W) validity, as numpy arrays or
    tensors. The loss is float32 whatever the net's compute dtype, and the
    one `ARCHS` gives ``cfg.arch``. With ``mesh``, ``batch`` is this rank's
    shard of the global batch and the loss returned is the global batch's."""
    *_, arch_loss = _arch(cfg.arch)

    def prepare(model, batch: dict) -> dict:
        return {k: to_model(model, batch[k], image=k in ("left", "right"))
                for k in ("left", "right", "disp", "mask")}

    def total(den):  # the global batch's valid pixels
        return torch.clamp(den if mesh is None else all_reduce(mesh, den, axis), min=1.0)

    step = train_step_skeleton(
        cfg, mesh, axis, 1, prepare, lambda model, b: model(b["left"], b["right"], train=True),
        lambda preds, b: (arch_loss(cfg, preds, b["disp"], b["mask"], total), {}))
    return lambda state, batch: step(state, batch)[:2]  # (state, loss): no aux


def make_stereo_eval(model: PSMNet):
    """``eval_fn(left, right, gt_disp, mask) -> (disparity, end-point error
    over valid pixels)``, in eval mode and float32, inputs as in the train
    step."""

    @torch.no_grad()
    def eval_fn(left, right, gt_disp, mask):
        left, right = to_model(model, left, image=True), to_model(model, right, image=True)
        gt, m = to_model(model, gt_disp), to_model(model, mask)
        with fp.ieee_fp32():
            disp = model(left, right, train=False)
        err = torch.abs(disp.float() - gt) * m
        return disp, torch.sum(err) / torch.clamp(torch.sum(m), min=1.0)

    return eval_fn


def iterate_stereo_batches(lefts, rights, disps, masks, batch_size: int, rng=None):
    """Full batches of in-memory stereo arrays (numpy), shuffled when a
    numpy ``rng`` is given (``rng.permutation``); a short tail is dropped.
    Host-side: the arrays stay numpy until the step moves them."""
    n = lefts.shape[0]
    order = rng.permutation(n) if rng is not None else np.arange(n)
    for i in range(0, n - batch_size + 1, batch_size):
        idx = order[i: i + batch_size]
        yield {"left": lefts[idx], "right": rights[idx], "disp": disps[idx],
               "mask": masks[idx]}
