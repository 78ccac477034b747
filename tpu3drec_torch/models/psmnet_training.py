"""PSMNet training (port of `tpu3drec/models/psmnet_training.py`):
supervised smooth-L1 on ground-truth disparity, one step = forward, loss
over valid-disparity pixels, backward, Adam update.

``StereoTrainConfig.arch`` picks the net: ``"psmnet_class"`` (the
default), the PSMNet-class sibling that the JAX package has, flax's
initialisers, one output; or ``"stackhourglass"``, the published PSMNet
(`models/psmnet.py::StackHourglassPSMNet`), the published initialisation,
and the published loss 0.5 L1 + 0.7 L2 + L3 over its three heads, each
term over the pixels with ``mask`` and 0 <= disparity < ``max_disp``.

As in `models/training.py`, the module holds the weights and batch
statistics and ``torch.optim.Adam`` (optax's defaults) the moments:
`init_stereo_state` returns (model, state), the step updates both in place,
and `make_stereo_eval(model)` takes no parameter trees. The step runs in
IEEE float32 (`core/fp.py::ieee_fp32`, no TF32); ``compute_dtype=
"bfloat16"`` runs the net under bf16 autocast and the loss in float32.
With a mesh the step is data-parallel over ``axis`` (as
`models/training.py::make_train_step`): batch norms over the global batch,
the loss the global batch's (its valid-pixel count all-reduced), the
gradients all-reduced.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.models.psmnet import (
    SPP_POOLS, PSMNet, StackHourglassPSMNet, init_psmnet_params, smooth_l1_terms)
from tpu3drec_torch.models.training import (
    TrainState, autocast, data_parallel, init_flax_params, make_optimizer, sync_gradients)
from tpu3drec_torch.parallel.mesh import all_reduce
from tpu3drec_torch.utils.device import resolve_device
from tpu3drec_torch.utils.tracing import span

ARCHS = ("psmnet_class", "stackhourglass")
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
    arch: str = "psmnet_class"      # or "stackhourglass", the published PSMNet
    # the stacked hourglass's SPP pools, in px at 1/4: published; only tests
    # and the benchmark's CPU-sized cell set smaller ones, for small inputs
    spp_pools: tuple = SPP_POOLS


def build_stereo_model(cfg, generator: torch.Generator,
                       spp_pools=SPP_POOLS) -> torch.nn.Module:
    """The net ``cfg.arch`` names (``cfg``: a `StereoTrainConfig` or
    `pipelines/stereo.py::StereoPipelineConfig`), on the CPU, initialised
    from ``generator``: flax's initialisers for the sibling, the published
    ones for the stacked hourglass (with SPP pools ``spp_pools``)."""
    if cfg.arch == "stackhourglass":
        model = StackHourglassPSMNet(max_disp=cfg.max_disp, spp_pools=tuple(spp_pools))
        init_psmnet_params(model, generator)
    elif cfg.arch == "psmnet_class":
        model = PSMNet(max_disp=cfg.max_disp, feat_ch=cfg.feat_ch)
        init_flax_params(model, generator)
    else:
        raise ValueError(f"arch must be one of {ARCHS}, not {cfg.arch!r}")
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
    tensors. The loss is float32 whatever the net's compute dtype. With
    ``mesh``, ``batch`` is this rank's shard of the global batch and the
    loss returned is the global batch's. With the stacked hourglass the
    loss weighs its three heads (`HEAD_WEIGHTS`) and keeps only pixels with
    0 <= disparity < ``max_disp``."""
    stack = cfg.arch == "stackhourglass"

    def train_step(state: TrainState, batch: dict):
        with span("train.step"):
            return step(state, batch)

    def step(state: TrainState, batch: dict):
        model, opt = state.model, state.optimizer
        left, right = (to_model(model, batch[k], image=True) for k in ("left", "right"))
        gt, mask = (to_model(model, batch[k]) for k in ("disp", "mask"))
        with fp.ieee_fp32():
            with span("train.optimizer"):
                opt.zero_grad(set_to_none=True)
            with autocast(cfg, left.device), data_parallel(mesh, axis), span("train.forward"):
                preds = model(left, right, train=True)
            with span("train.loss"):
                if stack:  # the published main.py: disp_true < maxdisp
                    mask = mask * ((gt >= 0) & (gt < cfg.max_disp)).to(mask.dtype)
                else:
                    preds = (preds,)
                terms = [smooth_l1_terms(p.to(torch.promote_types(p.dtype, torch.float32)),
                                         gt, mask) for p in preds]
                den = terms[0][1]
                if mesh is not None:
                    den = all_reduce(mesh, den, axis)  # the global batch's valid pixels
                den = torch.clamp(den, min=1.0)
                if stack:
                    loss = sum(wt * num / den for wt, (num, _) in zip(HEAD_WEIGHTS, terms))
                else:
                    loss = terms[0][0] / den
            with span("train.backward"):
                loss.backward()
                sync_gradients(model.parameters(), mesh, axis, 1)
            with span("train.optimizer"):
                for group in opt.param_groups:
                    group["lr"] = state.schedule(state.step)
                opt.step()
        state.step += 1
        loss = loss.detach()
        if mesh is not None:
            loss = all_reduce(mesh, loss, axis)
        return state, loss

    return train_step


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
