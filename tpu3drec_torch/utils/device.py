"""Device resolution shared by every public entry point of the port."""

from __future__ import annotations

import threading

import torch

# torch.func's forward-mode AD numbers its levels in process-wide state, so
# jacfwd running in two threads at once corrupts the other's levels. Every
# jacfwd evaluation of the port holds this lock; threads meet only where
# `pipelines/kitti.py` reconstructs windows concurrently.
FORWARD_AD_LOCK = threading.RLock()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``). A CUDA device that is not there
    raises: the port never falls back to the CPU on its own; callers that
    want the CPU pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """Array-like -> float32 tensor on ``device`` (no copy when it already
    is one)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)
