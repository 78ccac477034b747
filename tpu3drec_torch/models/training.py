"""Monodepth training step and depth inference (port of
`tpu3drec/models/training.py`).

The reference's training semantics: Adam at 1e-5 with a x0.1 step decay
after 15 epochs, the photometric + smoothness loss, pose from the pose net
or from ground truth (``use_gt_pose``), optionally the stereo frame.

Where the JAX package keeps parameters, batch statistics and the optimizer
state in one pytree, here the module holds the weights and the statistics
and ``torch.optim.Adam`` the moments: `init_state` returns the model and a
`TrainState` that holds both, and the step updates them in place.
Gradients come from autograd. Data parallelism: with a mesh
(`parallel/mesh.py`) the step takes this rank's shard of the global batch
(equal shards on the ranks of ``axis``); batch norms reduce over the
global batch (`models/resnet.py::global_batch`), the loss is the global
batch's mean, and the gradients are all-reduced to match it, so every rank
takes the same Adam update. ``compute_dtype="float32"`` is IEEE float32
on the card too (`core/fp.py::ieee_fp32`, no TF32), so the card agrees with
a CPU run of the same code; ``"bfloat16"`` runs the nets under bf16
autocast, and the loss in float32 either way.

`train_step_skeleton` is every net's step (this module's and
`models/psmnet_training.py`'s), in the program spans (`utils/tracing.py`):
the root ``train.step``; ``train.forward`` (the nets), ``train.loss``,
``train.backward`` (autograd and the gradients' all-reduce) and
``train.optimizer`` (twice: the gradients' reset, then the learning rate
and Adam's update). From the gradients' reset to Adam's update the step
runs under `core/fp.py::cudnn_autotune`, so cuDNN times its candidate
algorithms for each convolution shape, forward and gradients, on the
first step that meets it; ``train.step`` counts ``train.autotuned_steps``,
1 for a step on a CUDA device and 0 elsewhere.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable

import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.models.monodepth import (
    MonodepthLossConfig,
    MonodepthModel,
    disp_to_depth,
    monodepth_loss,
    resize_bilinear,
    transformation_from_parameters,
)
from tpu3drec_torch.models.resnet import global_batch
from tpu3drec_torch.parallel.mesh import all_reduce
from tpu3drec_torch.utils.device import resolve_device
from tpu3drec_torch.utils.tracing import count, span


@dataclass
class TrainConfig:
    learning_rate: float = 1e-5        # --learning_rate default
    scheduler_step_epochs: int = 15    # --scheduler_step_size
    scheduler_gamma: float = 0.1
    num_epochs: int = 20               # --num_epochs
    batch_size: int = 1                # reference default
    height: int = 480
    width: int = 640
    use_gt_pose: bool = False          # --use_GTpose
    # mono+stereo self-supervision: the reference's "s" frame with a
    # constant known-baseline transform, which anchors metric scale
    use_stereo: bool = False
    stereo_baseline: float = 0.1       # metres
    depth_layers: int = 18
    compute_dtype: str = "float32"     # "bfloat16": the nets under bf16 autocast
    loss: MonodepthLossConfig = None

    def __post_init__(self):
        if self.loss is None:
            self.loss = MonodepthLossConfig(
                fx=0.9375 * self.width, fy=1.25 * self.height,
                cx=0.5 * self.width, cy=0.5 * self.height,
            )


@dataclass
class TrainState:
    """The model (weights and batch statistics), its Adam optimizer, the
    learning rate by step, and the number of steps taken."""

    model: MonodepthModel
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The reference's StepLR as the JAX package has it
    (``optax.piecewise_constant_schedule``): ``learning_rate`` before the
    boundary ``scheduler_step_epochs * steps_per_epoch``, times
    ``scheduler_gamma`` from the boundary's own step on."""
    boundary = cfg.scheduler_step_epochs * steps_per_epoch
    return lambda step: cfg.learning_rate * (cfg.scheduler_gamma if step >= boundary else 1.0)


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """``optax.adam``: b1 0.9, b2 0.999, eps 1e-8 outside the square root;
    the train step sets the learning rate from `lr_schedule` before each
    update."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def init_flax_params(model: torch.nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers: convolution kernels ``lecun_normal`` (a normal
    truncated at 2 standard deviations, scaled to variance 1 / fan_in),
    biases 0; batch norms scale 1, bias 0, running mean 0, variance 1."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
            fan_in = m.in_channels * math.prod(m.kernel_size)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                            generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def init_state(seed, cfg: TrainConfig, steps_per_epoch: int = 1000, device=None):
    """A fresh model on ``device`` (default the card) with weights drawn on
    the CPU from ``seed`` (an int or a CPU ``torch.Generator``), so that
    one seed gives the same weights on every device. Returns (model,
    state)."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    model = MonodepthModel(depth_layers=cfg.depth_layers)
    init_flax_params(model, gen)
    model.to(dev)
    state = TrainState(model, make_optimizer(cfg, model.parameters()),
                       lr_schedule(cfg, steps_per_epoch))
    return model, state


def autocast(cfg, dev: torch.device):
    """The nets' compute dtype of ``cfg`` (a `TrainConfig` or
    `models/psmnet_training.py::StereoTrainConfig`): nothing for float32,
    bf16 autocast for bfloat16."""
    if cfg.compute_dtype == "float32":
        return contextlib.nullcontext()
    if cfg.compute_dtype != "bfloat16":
        raise ValueError(f"compute_dtype must be float32 or bfloat16, not {cfg.compute_dtype!r}")
    return torch.autocast(dev.type, dtype=torch.bfloat16)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least float32: the loss's dtype whatever the nets'."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _forward(model: MonodepthModel, batch: dict, cfg: TrainConfig):
    """The nets: disparities by scale, and the poses of prev and next."""
    return model.forward_train(batch["target"], batch["prev"], batch["next"],
                               with_pose=not cfg.use_gt_pose)


def _loss(outputs, batch: dict, cfg: TrainConfig, noise=None):
    """(loss, aux) of `_forward`'s ``outputs`` on NHWC frames in [0, 1].

    batch keys: "target", "prev", "next"; with use_gt_pose also
    "gt_axisangle" (N, 2, 3) and "gt_translation" (N, 2, 3), rows [prev,
    next]; with use_stereo also "stereo" (N, H, W, 3) and "stereo_sign"
    (N,) in {-1, +1}. ``noise``: standard normal draws (sources, N, H, W)
    for the automask tiebreak (times 1e-5), or None for a constant.
    """
    disps, pose_prev, pose_next = outputs
    target, prev, nxt = batch["target"], batch["prev"], batch["next"]
    disps = {k: at_least_f32(v) for k, v in disps.items()}
    if cfg.use_gt_pose:
        # the GT path: no inversion, rows [prev, next]
        T_prev = transformation_from_parameters(batch["gt_axisangle"][:, 0],
                                                batch["gt_translation"][:, 0])
        T_next = transformation_from_parameters(batch["gt_axisangle"][:, 1],
                                                batch["gt_translation"][:, 1])
    else:
        # invert for the negative frame id
        T_prev = transformation_from_parameters(*map(at_least_f32, pose_prev), invert=True)
        T_next = transformation_from_parameters(*map(at_least_f32, pose_next), invert=False)

    frame_Ts = [T_prev, T_next]
    sources = [prev, nxt]
    if cfg.use_stereo:
        # constant stereo transform: identity R, the baseline along x with
        # the sample's flip sign; the pose net never sees the stereo frame
        N = target.shape[0]
        T_s = torch.eye(4, dtype=target.dtype, device=target.device).repeat(N, 1, 1)
        T_s[:, 0, 3] = batch["stereo_sign"].to(target.dtype) * cfg.stereo_baseline
        frame_Ts.append(T_s)
        sources.append(batch["stereo"])

    ident = None
    if noise is not None:
        ident = torch.as_tensor(noise, dtype=target.dtype, device=target.device) * 1e-5
    return monodepth_loss(disps, frame_Ts, target, sources, cfg.loss, identity_noise=ident)


def _forward_loss(model: MonodepthModel, batch: dict, cfg: TrainConfig, noise=None):
    """`_forward` under autocast, then `_loss`: the step's loss alone."""
    with autocast(cfg, batch["target"].device):
        outputs = _forward(model, batch, cfg)
    return _loss(outputs, batch, cfg, noise)


def train_step_skeleton(cfg, mesh, axis: str, shards: int, prepare: Callable,
                        forward: Callable, loss_fn: Callable):
    """Every net's training step, in the module docstring's spans:
    ``step(state, *inputs, **named) -> (state, loss, aux)``, ``state`` a
    `TrainState` updated in place. ``prepare(model, *inputs, **named) -> x``
    puts the batch on the model's device; ``forward(model, x)`` runs the
    net under ``cfg.compute_dtype`` and, with ``mesh``, batch norms over the
    global batch; ``loss_fn(outputs, x) -> (loss, dict aux)``. With ``mesh``
    the gradients, loss and aux are summed over ``axis`` and divided by
    ``shards``: the shard count where each rank's loss is its shard's mean,
    1 where it is already its share of the global batch's."""

    def step(state: TrainState, *inputs, **named):
        with span("train.step"):
            model, opt = state.model, state.optimizer
            dev = next(model.parameters()).device
            x = prepare(model, *inputs, **named)
            with fp.ieee_fp32(), fp.cudnn_autotune():
                count("train.autotuned_steps", int(dev.type == "cuda"))
                with span("train.optimizer"):
                    opt.zero_grad(set_to_none=True)
                par = contextlib.nullcontext() if mesh is None else global_batch(mesh, axis)
                with autocast(cfg, dev), par, span("train.forward"):
                    outputs = forward(model, x)
                with span("train.loss"):
                    loss, aux = loss_fn(outputs, x)
                with span("train.backward"):
                    loss.backward()
                    grads = [p.grad for p in model.parameters() if p.grad is not None]
                    if mesh is not None and grads:  # in one all-reduce
                        flat = all_reduce(mesh, torch.cat([g.reshape(-1) for g in grads]),
                                          axis) / shards
                        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                            g.copy_(part.view_as(g))
                with span("train.optimizer"):
                    for group in opt.param_groups:
                        group["lr"] = state.schedule(state.step)
                    opt.step()
            state.step += 1
            loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
            if mesh is not None:
                keys = list(aux)
                vals = all_reduce(mesh, torch.stack([loss] + [aux[k] for k in keys]), axis) / shards
                loss, aux = vals[0], dict(zip(keys, vals[1:]))
        return state, loss, aux

    return step


def make_train_step(cfg: TrainConfig, mesh=None, axis: str = "data"):
    """Monodepth's step (`train_step_skeleton`): forward, loss, backward, Adam.

    ``train_step(state, batch, rng=None, noise=None) -> (state, loss,
    aux)``. The automask tiebreak comes from ``noise`` (standard normal
    draws, shape (sources, N, H, W)) when given, else from the
    ``torch.Generator`` ``rng`` on the model's device, else a constant.

    With ``mesh``, ``batch`` is this rank's shard of the global batch and
    ``noise`` (or ``rng``'s draws) covers the global batch, of which the
    rank takes its slice, so that D ranks draw what one process would; the
    loss and aux values returned are the global batch's.
    """
    shards = 1 if mesh is None else mesh.axis_size(axis)
    index = 0 if mesh is None else mesh.axis_index(axis)

    def prepare(model, batch: dict, rng=None, noise=None):
        param = next(model.parameters())  # its device, and float32 or float64
        batch = {k: torch.as_tensor(v, dtype=param.dtype, device=param.device)
                 for k, v in batch.items()}
        n, h, w = batch["target"].shape[:3]
        if noise is None and rng is not None:
            noise = torch.randn((3 if cfg.use_stereo else 2, n * shards, h, w),
                                generator=rng, device=param.device)
        if noise is not None and mesh is not None:
            noise = noise[:, index * n:(index + 1) * n]
        return batch, noise

    return train_step_skeleton(cfg, mesh, axis, shards, prepare,
                               lambda model, x: _forward(model, x[0], cfg),
                               lambda outputs, x: _loss(outputs, x[0], cfg, x[1]))


def make_eval_depth(model: MonodepthModel, cfg: TrainConfig):
    """Depth inference: RGB (N, H, W, 3) in [0, 1], on the model's device
    -> depth (N, cfg.height, cfg.width): the finest disparity resized to
    (height, width), then `disp_to_depth`."""

    @torch.no_grad()
    def eval_depth(images: torch.Tensor) -> torch.Tensor:
        with fp.ieee_fp32(), autocast(cfg, images.device):
            disp0 = model.depth(images, train=False)[0]
        disp_full = resize_bilinear(disp0.float(), cfg.height, cfg.width)
        _, depth = disp_to_depth(disp_full[..., 0], cfg.loss.min_depth, cfg.loss.max_depth)
        return depth

    return eval_depth
