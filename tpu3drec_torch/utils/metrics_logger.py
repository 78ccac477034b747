"""Metrics / logging / observability (port of
`tpu3drec/utils/metrics_logger.py`).

The reference logs scalars + images to tensorboardX per train/val mode and
prints wall-clock throughput (`ref/monodepth2/trainer.py:142-144,541-585`).
Here: a JSONL event log (machine-readable, append-only, crash-safe) with
console mirroring and the same examples/s + ETA arithmetic
(`trainer.py:541-551`); TensorBoard output optional via torch's bundled
SummaryWriter when available.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, mode: str = "train",
                 tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{mode}.jsonl")
        self._f = open(self.path, "a")
        self.mode = mode
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, mode))
            except ImportError:  # no tensorboard installed
                self._tb = None

    def log(self, step: int, scalars: dict, echo: bool = False) -> None:
        rec = {"step": int(step), "t": time.time(), "mode": self.mode}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))
        if echo:
            parts = " ".join(f"{k}={float(v):.5g}" for k, v in scalars.items())
            print(f"[{self.mode} step {step}] {parts}")

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class ThroughputMeter:
    """examples/s + ETA, the reference's log_time (`trainer.py:541-551`)."""

    def __init__(self, total_steps: int, batch_size: int):
        self.start = time.time()
        self.total_steps = total_steps
        self.batch_size = batch_size

    def report(self, step: int) -> dict:
        elapsed = max(time.time() - self.start, 1e-9)
        done = max(step, 1)
        rate = done * self.batch_size / elapsed
        eta = elapsed / done * (self.total_steps - done)
        return {"examples_per_s": rate, "elapsed_s": elapsed, "eta_s": eta}
