"""PSMNet training (port of `tpu3drec/models/psmnet_training.py`):
supervised smooth-L1 on ground-truth disparity, one step = forward, loss
over valid-disparity pixels, backward, Adam update.

As in `models/training.py`, the module holds the weights and batch
statistics and ``torch.optim.Adam`` (optax's defaults) the moments:
`init_stereo_state` returns (model, state), the step updates both in place,
and `make_stereo_eval(model)` takes no parameter trees. The step runs in
IEEE float32 (`core/fp.py::ieee_fp32`, no TF32); ``compute_dtype=
"bfloat16"`` runs the net under bf16 autocast and the loss in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.models.psmnet import PSMNet, smooth_l1_loss
from tpu3drec_torch.models.training import (
    TrainState, autocast, init_flax_params, make_optimizer)
from tpu3drec_torch.utils.device import resolve_device


@dataclass
class StereoTrainConfig:
    learning_rate: float = 1e-3     # PSMNet's published Adam lr
    num_epochs: int = 10
    batch_size: int = 4
    height: int = 256
    width: int = 512
    max_disp: int = 64
    feat_ch: int = 32
    compute_dtype: str = "float32"  # "bfloat16": the net under bf16 autocast


def init_stereo_state(seed, cfg: StereoTrainConfig, device=None):
    """A fresh PSMNet on ``device`` (default the card), flax's initialisers
    drawn on the CPU from ``seed`` (an int or a CPU ``torch.Generator``),
    and its Adam optimizer. Returns (model, state)."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    model = PSMNet(max_disp=cfg.max_disp, feat_ch=cfg.feat_ch)
    init_flax_params(model, gen)
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


def make_stereo_train_step(cfg: StereoTrainConfig):
    """``train_step(state, batch) -> (state, loss)``: batch dict with
    "left"/"right" (N, H, W, 3) in [0, 1], "disp" (N, H, W) ground-truth
    disparity in pixels and "mask" (N, H, W) validity, as numpy arrays or
    tensors. The loss is float32 whatever the net's compute dtype."""

    def train_step(state: TrainState, batch: dict):
        model, opt = state.model, state.optimizer
        left, right = (to_model(model, batch[k], image=True) for k in ("left", "right"))
        gt, mask = (to_model(model, batch[k]) for k in ("disp", "mask"))
        with fp.ieee_fp32():
            opt.zero_grad(set_to_none=True)
            with autocast(cfg, left.device):
                disp = model(left, right, train=True)
            loss = smooth_l1_loss(disp.to(torch.promote_types(disp.dtype, torch.float32)),
                                  gt, mask)
            loss.backward()
            for group in opt.param_groups:
                group["lr"] = state.schedule(state.step)
            opt.step()
        state.step += 1
        return state, loss.detach()

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
