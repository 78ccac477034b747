"""Depth decoder (port of `tpu3drec/models/depth_decoder.py`), NCHW.

Monodepth2's DepthDecoder: 5 up-levels of reflect-padded 3x3 convolutions
with ELU, nearest x2 upsampling, the encoder's skip concatenated after the
upsampled tensor, and sigmoid disparity heads ``dispconv_{i}`` at the
scales asked for.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Pad H and W by 1, mirrored without the edge (``jnp.pad`` "reflect");
    an axis of length 1 repeats its one value, as ``jnp.pad`` does, where
    ``F.pad`` would raise."""
    h, w = x.shape[-2:]
    if h > 1 and w > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    x = F.pad(x, (1, 1, 0, 0), mode="reflect" if w > 1 else "replicate")
    return F.pad(x, (0, 0, 1, 1), mode="reflect" if h > 1 else "replicate")


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 on NCHW: each value repeated 2 x 2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ConvBlock(nn.Module):
    """3x3 conv with reflection padding + ELU (monodepth2 ConvBlock)."""

    def __init__(self, cin: int, channels: int):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin, channels, 3)])

    def forward(self, x):
        return F.elu(self.convs[0](reflect_pad1(x)))


class DepthDecoder(nn.Module):
    """Encoder pyramid -> dict {scale: disparity (N, 1, h, w) in (0, 1)}."""

    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int] = (0, 1, 2, 3),
                 num_ch_dec: Sequence[int] = (16, 32, 64, 128, 256)):
        super().__init__()
        self.scales = tuple(scales)
        blocks, cin = [], num_ch_enc[-1]
        for i in range(4, -1, -1):
            blocks.append(ConvBlock(cin, num_ch_dec[i]))
            cin = num_ch_dec[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            blocks.append(ConvBlock(cin, num_ch_dec[i]))
            cin = num_ch_dec[i]
        self.convblocks = nn.ModuleList(blocks)
        self.dispconvs = nn.ModuleDict(
            {str(i): nn.Conv2d(num_ch_dec[i], 1, 3) for i in self.scales})

    def forward(self, feats: Sequence[torch.Tensor]) -> dict:
        outputs = {}
        x = feats[-1]
        for k, i in enumerate(range(4, -1, -1)):
            x = upsample2x(self.convblocks[2 * k](x))
            if i > 0:
                skip = feats[i - 1]
                # guard odd input sizes: crop to the skip's spatial dims
                x = torch.cat([x[:, :, : skip.shape[2], : skip.shape[3]], skip], dim=1)
            x = self.convblocks[2 * k + 1](x)
            if i in self.scales:
                outputs[i] = torch.sigmoid(self.dispconvs[str(i)](reflect_pad1(x)))
        return outputs
