"""Textured RGB frames under a small known camera motion, made on the device
from a seed: a smooth random texture (coarse and mid-scale noise,
bilinearly upsampled) seen through a window that slides ``shift`` pixels a
frame, as a camera translating parallel to a textured plane does."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def texture(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, h, w, 3) float32 in [0, 1]."""
    out = torch.zeros((n, 3, h, w), device=device)
    for cell, weight in ((16, 1.0), (4, 0.35)):
        low = torch.randn((n, 3, h // cell + 2, w // cell + 2), generator=gen, device=device)
        out += weight * F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return torch.sigmoid(1.5 * out).permute(0, 2, 3, 1).contiguous()


def sequences(gen, n: int, frames: int, h: int, w: int, shift: int, device) -> torch.Tensor:
    """(n, frames, h, w, 3): frame k of a sequence is its texture seen at an
    offset of k * shift pixels."""
    tex = texture(gen, n, h, w + shift * (frames - 1), device)
    return torch.stack([tex[:, :, k * shift: k * shift + w] for k in range(frames)], 1)
