"""Monocular pipeline, reference configuration 4 (port of
`tpu3drec/pipelines/monocular.py`): self-supervised depth training, and
depth inference that feeds fusion.

`train` is the reference's ``Trainer.train()``: the epoch loop, one
held-out batch with depth metrics every ``val_every`` steps, checkpoints
every ``save_frequency`` epochs and at the end, and resume from the newest
one. `infer_depth_maps` turns frames into depth maps for
`pipelines/rgbd.py::run_arrays`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu3drec_torch.data.loader import TripletLoader
from tpu3drec_torch.models.metrics import depth_metrics
from tpu3drec_torch.models.training import (
    TrainConfig,
    init_state,
    make_eval_depth,
    make_train_step,
)
from tpu3drec_torch.utils.checkpoint import CheckpointManager
from tpu3drec_torch.utils.device import resolve_device
from tpu3drec_torch.utils.metrics_logger import MetricsLogger, ThroughputMeter
from tpu3drec_torch.utils.tracing import count, span


@dataclass
class MonocularRunConfig:
    train: TrainConfig = field(default_factory=TrainConfig)
    log_dir: str = "runs/monocular"
    log_every: int = 25        # reference alternates 250/2000
    val_every: int = 100
    max_steps: int = 0         # 0 = epochs * len(loader)


def train(
    cfg: MonocularRunConfig,
    train_loader: TripletLoader,
    val_loader: TripletLoader | None = None,
    resume: bool = True,
    device=None,
):
    """The epoch loop of the reference's ``run_epoch``. Returns (model,
    state)."""
    dev = resolve_device(device)
    tcfg = cfg.train
    steps_per_epoch = max(len(train_loader), 1)
    model, state = init_state(0, tcfg, steps_per_epoch, device=dev)
    ckpt = CheckpointManager(cfg.log_dir + "/ckpt", save_frequency=5)
    ckpt.save_config(tcfg)
    if resume:
        state = ckpt.restore(state)
    step_fn = make_train_step(tcfg)
    eval_fn = make_eval_depth(model, tcfg)
    logger = MetricsLogger(cfg.log_dir, "train")
    val_logger = MetricsLogger(cfg.log_dir, "val")
    meter = ThroughputMeter(tcfg.num_epochs * steps_per_epoch, tcfg.batch_size)

    step = state.step
    rng = torch.Generator(device=dev).manual_seed(step)
    val_iter = iter(val_loader) if val_loader is not None else None
    try:
        for epoch in range(tcfg.num_epochs):
            for batch in train_loader:
                state, loss, _ = step_fn(state, batch, rng)
                step = state.step
                if step % cfg.log_every == 0:
                    scalars = {"loss": float(loss)}
                    scalars.update(meter.report(step))
                    logger.log(step, scalars, echo=True)
                if val_iter is not None and step % cfg.val_every == 0:
                    # one val batch per val step, the reference's `val()`
                    try:
                        vb = next(val_iter)
                    except StopIteration:
                        val_iter = iter(val_loader)
                        vb = next(val_iter)
                    depth = eval_fn(torch.as_tensor(vb["target"], device=dev))
                    scalars = {}
                    if "gt_depth" in vb:
                        m = depth_metrics(depth, torch.as_tensor(vb["gt_depth"], device=dev))
                        scalars.update({k: float(v) for k, v in m.items()})
                    val_logger.log(step, scalars)
                if cfg.max_steps and step >= cfg.max_steps:
                    break
            ckpt.maybe_save(epoch, state)
            if cfg.max_steps and step >= cfg.max_steps:
                break
        ckpt.save(step, state)
    finally:
        logger.close()
        val_logger.close()
    return model, state


def infer_depth_maps(model, images: np.ndarray, cfg: TrainConfig, batch: int = 8) -> np.ndarray:
    """RGB (F, H, W, 3) uint8 or float in [0, 1] -> depth (F, cfg.height,
    cfg.width) float32, in chunks of ``batch`` frames on the model's
    device; the last chunk is padded with zero frames to the full batch
    (the batch statistics are not used, so padding changes no frame).

    Program spans (`utils/tracing.py`): the root ``infer.depth``;
    ``infer.to_device`` (the conversion to float32 on the host, then each
    chunk's copy, counter ``bytes_to_device``), ``infer.net`` and
    ``infer.to_host`` (counter ``bytes_to_host``), a chunk each."""
    with span("infer.depth"):
        eval_fn = make_eval_depth(model, cfg)
        dev = next(model.parameters()).device
        if images.dtype == np.uint8:
            with span("infer.to_device"):
                images = images.astype(np.float32) / 255.0
        out = []
        for i in range(0, images.shape[0], batch):
            with span("infer.to_device"):
                chunk = images[i: i + batch]
                pad = batch - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:],
                                                            chunk.dtype)])
                x = torch.as_tensor(chunk, dtype=torch.float32, device=dev)
                count("bytes_to_device", x.nbytes)
            with span("infer.net"):
                d = eval_fn(x)
            with span("infer.to_host"):
                d = d.cpu().numpy()
                count("bytes_to_host", d.nbytes)
            out.append(d[: batch - pad])
        return np.concatenate(out, axis=0)
