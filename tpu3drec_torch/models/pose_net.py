"""Pose network (port of `tpu3drec/models/pose_net.py`), NCHW.

A frame pair -> 6-DoF relative pose (axis-angle + translation): a 2-frame
ResNet encoder and monodepth2's PoseDecoder, whose 0.01 output scaling
keeps early training near identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.models.resnet import ResNetEncoder


class PoseDecoder(nn.Module):
    """1x1 squeeze to 256 channels, two 3x3 convolutions, a 1x1 6-DoF head,
    then the spatial mean."""

    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(cin, 256, 1), nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1), nn.Conv2d(256, 6, 1)])

    def forward(self, feat):
        y = feat
        for conv in self.convs[:3]:
            y = F.relu(conv(y))
        y = 0.01 * self.convs[3](y).mean(dim=(2, 3))
        return y[..., :3], y[..., 3:]  # axisangle, translation


class PoseNet(nn.Module):
    """Two RGB frames (NCHW each) -> (axisangle (N, 3), translation (N, 3))."""

    def __init__(self, depth: int = 18):
        super().__init__()
        self.encoder = ResNetEncoder(depth=depth, in_frames=2)
        self.decoder = PoseDecoder(self.encoder.num_ch_enc[-1])

    def forward(self, img_a, img_b, train: bool = False):
        feats = self.encoder(torch.cat([img_a, img_b], dim=1), train=train)
        return self.decoder(feats[-1])
