"""Stereo pipeline, reference configuration 3 (port of
`tpu3drec/pipelines/stereo.py`): stereo RGB -> disparity from the net
``arch`` names in `models/psmnet_training.py::ARCHS` (by default the
PSMNet-class sibling) -> depth -> fused point cloud + octomap export
through `pipelines/rgbd.py::run_arrays`.

Depth from disparity uses the reference's 0.1 m stereo baseline unless
overridden. As in `pipelines/monocular.py`, the weights live in the
module: `load_trained` returns the model and `run` takes one (or draws
the architecture's initial weights from seed 0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu3drec_torch.models.psmnet import disparity_to_depth, stereo_infer
from tpu3drec_torch.models.psmnet_training import (
    StereoTrainConfig,
    build_stereo_model,
    init_stereo_state,
    iterate_stereo_batches,
    make_stereo_train_step,
    to_model,
)
from tpu3drec_torch.pipelines import rgbd
from tpu3drec_torch.utils.checkpoint import CheckpointManager
from tpu3drec_torch.utils.config import RGBDPipelineConfig
from tpu3drec_torch.utils.device import resolve_device
from tpu3drec_torch.utils.metrics_logger import MetricsLogger, ThroughputMeter


@dataclass
class StereoPipelineConfig:
    rgbd: RGBDPipelineConfig = field(default_factory=RGBDPipelineConfig)
    baseline_m: float = 0.1
    max_disp: int = 64
    feat_ch: int = 32
    batch: int = 4
    arch: str = StereoTrainConfig.arch  # a key of `models/psmnet_training.py::ARCHS`


def train(
    cfg: StereoTrainConfig,
    lefts: np.ndarray,            # (F, H, W, 3) float in [0, 1]
    rights: np.ndarray,
    gt_disp: np.ndarray,          # (F, H, W) pixels
    mask: np.ndarray,             # (F, H, W) validity
    log_dir: str = "runs/stereo",
    log_every: int = 10,
    resume: bool = True,
    seed: int = 0,
    device=None,
):
    """Supervised training of the net ``cfg.arch`` names (smooth-L1 on
    ground-truth disparity): the epoch loop, checkpoints every 5 epochs and at the end, resume from the
    newest one, JSONL metrics. Returns (model, state, last loss)."""
    dev = resolve_device(device)
    model, state = init_stereo_state(seed, cfg, device=dev)
    ckpt = CheckpointManager(log_dir + "/ckpt", save_frequency=5)
    ckpt.save_config(cfg)
    if resume:
        state = ckpt.restore(state)
    step_fn = make_stereo_train_step(cfg)
    logger = MetricsLogger(log_dir, "train")
    steps_per_epoch = max(lefts.shape[0] // cfg.batch_size, 1)
    meter = ThroughputMeter(cfg.num_epochs * steps_per_epoch, cfg.batch_size)
    rng = np.random.default_rng(seed)

    step = state.step
    last_loss = math.nan
    try:
        for epoch in range(cfg.num_epochs):
            for batch in iterate_stereo_batches(lefts, rights, gt_disp, mask,
                                                cfg.batch_size, rng):
                state, loss = step_fn(state, batch)
                step = state.step
                last_loss = float(loss)
                if step % log_every == 0:
                    scalars = {"loss": last_loss}
                    scalars.update(meter.report(step))
                    logger.log(step, scalars, echo=True)
            ckpt.maybe_save(epoch, state)
        ckpt.save(step, state)
    finally:
        logger.close()
    return model, state, last_loss


def infer_disparity(model: torch.nn.Module, lefts: np.ndarray, rights: np.ndarray,
                    batch: int = 4) -> np.ndarray:
    """(F, H, W, 3) pairs -> (F, H', W') float32 disparity, in batches of
    ``batch`` on the model's device; the last batch is padded with zero
    pairs to the full batch (eval mode: the padding changes no frame)."""
    out = []
    for i in range(0, lefts.shape[0], batch):
        left, right = lefts[i: i + batch], rights[i: i + batch]
        pad = batch - left.shape[0]
        if pad:
            z = np.zeros((pad,) + left.shape[1:], left.dtype)
            left, right = np.concatenate([left, z]), np.concatenate([right, z])
        d = stereo_infer(model, to_model(model, left, image=True),
                         to_model(model, right, image=True))
        out.append(d.float().cpu().numpy()[: batch - pad])
    return np.concatenate(out)


def load_trained(log_dir: str, cfg: StereoTrainConfig, device=None) -> torch.nn.Module:
    """The net (``cfg.arch``) of a `train()` checkpoint directory's newest
    checkpoint, on ``device``, ready for `run(..., model=...)`."""
    model, state = init_stereo_state(0, cfg, device=device)
    CheckpointManager(log_dir + "/ckpt").restore(state)
    return model


def run(
    cfg: StereoPipelineConfig,
    lefts: np.ndarray,            # (F, H, W, 3) float in [0, 1]
    rights: np.ndarray,
    q_xyzw: np.ndarray,           # (F, 4) COLMAP-convention poses
    t: np.ndarray,                # (F, 3)
    model: torch.nn.Module | None = None,  # a trained net, or None: initial weights of cfg.arch
    keep_points: bool = False,
    device=None,
):
    """Stereo frames + poses -> map artifacts (PLY/.bt per ``cfg.rgbd``).
    Returns `pipelines/rgbd.py::RGBDResult`."""
    dev = resolve_device(device)
    if model is None:
        model = build_stereo_model(cfg, torch.Generator().manual_seed(0)).to(dev)
    disp = infer_disparity(model, lefts, rights, batch=cfg.batch)
    depth = disparity_to_depth(torch.as_tensor(disp), cfg.rgbd.camera.fx, cfg.baseline_m).numpy()
    return rgbd.run_arrays(depth, q_xyzw, t, cfg.rgbd, keep_points=keep_points, device=dev)
