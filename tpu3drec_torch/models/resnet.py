"""ResNet encoder (port of `tpu3drec/models/resnet.py`), NCHW.

The reference's torchvision-style multi-scale encoder for depths 18, 34
and 50, returning the 5-scale pyramid [conv1, layer1..layer4] that the
depth decoder's skips consume. ImageNet normalisation happens inside (per
frame for the 2-frame pose encoder).

Each module keeps its convolutions in ``convs`` and its batch norms in
``norms``, in the order flax creates them (``Conv_0``, ``Conv_1``, ...),
so that `models/convert.py` maps flax's auto-names by rule. Every
``forward`` takes ``train`` as the flax modules do: it picks batch or
running statistics per call, whatever ``nn.Module.training`` says.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.parallel.mesh import all_reduce_grad

# stage channel widths per depth, torchvision layout
_STAGES = {
    18: ((64, 64, 128, 256, 512), (2, 2, 2, 2), False),
    34: ((64, 64, 128, 256, 512), (3, 4, 6, 3), False),
    50: ((64, 256, 512, 1024, 2048), (3, 4, 6, 3), True),
}


# (mesh, axis) while `global_batch` is active: train-mode batch norms then
# reduce their moments over the ranks of the axis
_GLOBAL_BATCH = None


@contextlib.contextmanager
def global_batch(mesh, axis):
    """Inside, every `BatchNorm` in train mode takes its statistics over the
    global batch, whose equal shards lie on the ranks of ``mesh``'s
    ``axis``: each moment is the mean of the ranks' local moments, by an
    all-reduce that autograd goes through (`parallel/mesh.py::
    all_reduce_grad`), as the JAX package's batch norm reduces over a
    sharded batch."""
    global _GLOBAL_BATCH
    saved, _GLOBAL_BATCH = _GLOBAL_BATCH, (mesh, axis)
    try:
        yield
    finally:
        _GLOBAL_BATCH = saved


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channels (dim 1) of an NCHW or
    NCDHW tensor: the statistics reduce over every other dim.

    Not ``nn.BatchNorm2d``: flax keeps ``momentum`` 0.99 of the running
    statistics (torch keeps 0.9) and updates the running variance with the
    biased batch variance E[x^2] - E[x]^2, clipped at 0 (torch uses the
    unbiased one). Statistics and normalisation run in at least float32
    whatever the input's dtype, in flax's order: (x - mean) * (rsqrt(var + eps) * scale)
    + bias; the result takes the input's dtype."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0,) + tuple(range(2, x.ndim))
        if train:
            mean = xf.mean(dim=dims)
            mean_sq = (xf * xf).mean(dim=dims)
            if _GLOBAL_BATCH is not None:
                mesh, axis = _GLOBAL_BATCH
                moments = all_reduce_grad(mesh, torch.stack([mean, mean_sq]), axis)
                mean, mean_sq = (moments / mesh.axis_size(axis)).unbind(0)
            var = torch.maximum(mean_sq - mean * mean, mean.new_zeros(()))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        shape = (-1,) + (1,) * (x.ndim - 2)  # broadcast over the spatial dims
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        convs = [_conv(cin, channels, 3, stride, 1), _conv(channels, channels, 3, 1, 1)]
        if stride != 1 or cin != channels:  # the residual's shape differs
            convs.append(_conv(cin, channels, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchNorm(channels) for _ in convs)

    def forward(self, x, train: bool):
        y = F.relu(self.norms[0](self.convs[0](x), train))
        y = self.norms[1](self.convs[1](y), train)
        residual = self.norms[2](self.convs[2](x), train) if len(self.convs) > 2 else x
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """``channels`` is the output width, 4x the bottleneck's; the stride
    sits on the 3x3 convolution."""

    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        width = channels // 4
        convs = [_conv(cin, width, 1), _conv(width, width, 3, stride, 1),
                 _conv(width, channels, 1)]
        if stride != 1 or cin != channels:
            convs.append(_conv(cin, channels, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchNorm(c.out_channels) for c in convs)

    def forward(self, x, train: bool):
        y = F.relu(self.norms[0](self.convs[0](x), train))
        y = F.relu(self.norms[1](self.convs[1](y), train))
        y = self.norms[2](self.convs[2](y), train)
        residual = self.norms[3](self.convs[3](x), train) if len(self.convs) > 3 else x
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """Multi-scale encoder. Input NCHW in [0, 1] with 3 * ``in_frames``
    channels; returns the features at /2, /4, /8, /16 and /32."""

    def __init__(self, depth: int = 18, in_frames: int = 1):
        super().__init__()
        chans, blocks, bottleneck = _STAGES[depth]
        self.num_ch_enc = list(chans)
        # ImageNet statistics, kept in float64 and rounded to the input's dtype
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406] * in_frames,
                                                  dtype=torch.float64).view(1, -1, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225] * in_frames,
                                                 dtype=torch.float64).view(1, -1, 1, 1),
                             persistent=False)
        self.convs = nn.ModuleList([_conv(3 * in_frames, chans[0], 7, 2, 3)])
        self.norms = nn.ModuleList([BatchNorm(chans[0])])
        block = Bottleneck if bottleneck else BasicBlock
        layers, self.stage_ends, cin = [], [], chans[0]
        for stage, (c, n) in enumerate(zip(chans[1:], blocks)):
            for i in range(n):
                layers.append(block(cin, c, stride=2 if (stage > 0 and i == 0) else 1))
                cin = c
            self.stage_ends.append(len(layers) - 1)
        self.blocks = nn.ModuleList(layers)

    def forward(self, x, train: bool = False) -> list[torch.Tensor]:
        x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        y = F.relu(self.norms[0](self.convs[0](x), train))
        feats = [y]  # /2
        # flax pads max_pool with -inf, as MaxPool2d does
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for i, block in enumerate(self.blocks):
            y = block(y, train)
            if i in self.stage_ends:
                feats.append(y)  # /4, /8, /16, /32
        return feats
