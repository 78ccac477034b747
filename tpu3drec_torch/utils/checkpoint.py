"""Checkpoint / resume (port of `tpu3drec/utils/checkpoint.py`).

The reference's training persistence: periodic epoch checkpoints of every
model plus the Adam state, partial restore (state dicts merged model by
model), and the run config dumped beside the weights (``opt.json``). A
checkpoint here is one ``torch.save`` file ``<step>.pt`` holding the
model's state_dict (weights and batch statistics), the optimizer's and
the step, written to a temporary file and renamed into place, so a crash
never leaves a torn checkpoint under a step's name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Any

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """``max_to_keep`` newest checkpoints in ``directory``, saved every
    ``save_frequency`` epochs by `maybe_save` (reference default 5)."""

    def __init__(self, directory: str, max_to_keep: int = 5, save_frequency: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_frequency = save_frequency

    def save_config(self, cfg: Any) -> None:
        """Dump the run config next to the weights."""
        if dataclasses.is_dataclass(cfg):
            cfg = dataclasses.asdict(cfg)
        with open(os.path.join(self.directory, "opt.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)

    def maybe_save(self, epoch: int, state) -> bool:
        """Save if the epoch hits the save frequency."""
        if (epoch + 1) % self.save_frequency == 0:
            self.save(epoch, state)
            return True
        return False

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state) -> None:
        """``state``: a `models/training.py::TrainState`."""
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(), "step": int(state.step)}
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.directory, f"{step}.pt"))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"{old}.pt"))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_template, step: int | None = None):
        """Load a checkpoint into the template's model and optimizer (on
        their device) and set its step. Returns the template unchanged if
        no checkpoint exists."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state_template
        dev = next(state_template.model.parameters()).device
        payload = torch.load(os.path.join(self.directory, f"{step}.pt"), map_location=dev,
                             weights_only=True)
        state_template.model.load_state_dict(payload["model"])
        state_template.optimizer.load_state_dict(payload["optimizer"])
        state_template.step = payload["step"]
        return state_template

    def close(self):
        """Nothing stays open between calls; kept for the reference's API."""


def restore_partial(state_dict: dict, loaded: dict) -> dict:
    """Merge ``loaded`` entries into ``state_dict`` where the key exists
    with the same shape, keeping the rest: the reference's per-model
    partial state-dict merge."""
    merged = dict(state_dict)
    for k, v in loaded.items():
        if k in merged and tuple(merged[k].shape) == tuple(v.shape):
            merged[k] = v
    return merged
