"""PSMNet-class stereo disparity network (port of `tpu3drec/models/psmnet.py`):
a shared 2D feature extractor at 1/4 resolution with pyramid context
pooling, a concatenation cost volume over disparities, 3D-convolution
regularisation and soft-argmin disparity regression. NCHW images, NCDHW
cost volumes.

Each module keeps its convolutions in ``convs``, its batch norms in
``norms`` and its sub-blocks in ``blocks`` / ``hourglasses``, in the order
flax creates them, so that `models/convert.py` maps the JAX package's
flax auto-names by rule. Batch norms are flax's (`models/resnet.py::
BatchNorm`). ``forward`` takes ``train`` as the flax modules do.

Training: smooth-L1 against ground-truth disparity (PSMNet's loss); depth
follows from depth = fx * baseline / disparity (the reference's stereo
baseline is 0.1 m).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.core import fp
from tpu3drec_torch.models.resnet import BatchNorm


class ConvBnRelu(nn.Module):
    """3x3 convolution (no bias, padding = dilation), batch norm, ReLU."""

    def __init__(self, cin: int, ch: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin, ch, 3, stride=stride, padding=dilation,
                                              dilation=dilation, bias=False)])
        self.norms = nn.ModuleList([BatchNorm(ch)])

    def forward(self, x, train: bool = False):
        return F.relu(self.norms[0](self.convs[0](x), train))


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW tensor to a size no
    smaller on either axis: half-pixel centres, edge samples clamped."""
    if x.shape[2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """jax.image.resize's nearest source index of each of ``n`` outputs
    from ``m`` inputs: floor((i + 0.5) * m / n) in float32, which is
    ``F.interpolate``'s "nearest-exact" (not "nearest")."""
    i = np.arange(n, dtype=np.float32) + np.float32(0.5)
    idx = np.floor(i * np.float32(m) / np.float32(n)).astype(np.int64)
    return torch.as_tensor(idx, device=device)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` over the spatial dims (2, 3, ...)
    of ``x`` to ``size``."""
    for d, n in enumerate(size, start=2):
        if x.shape[d] != n:
            x = x.index_select(d, _nearest_index(x.shape[d], n, x.device))
    return x


class FeatureExtractor(nn.Module):
    """Shared-weight tower -> (N, ch, H/4, W/4) features with SPP context."""

    def __init__(self, ch: int = 32):
        super().__init__()
        c2 = ch * 2
        self.blocks = nn.ModuleList([
            ConvBnRelu(3, ch, stride=2), ConvBnRelu(ch, ch), ConvBnRelu(ch, ch, stride=2),
            ConvBnRelu(ch, c2), ConvBnRelu(c2, c2, dilation=2), ConvBnRelu(c2, c2, dilation=4),
            # pooled(1, 1), pooled(2, 2), pooled(4, 4), then the fuse
            ConvBnRelu(c2, ch), ConvBnRelu(c2, ch), ConvBnRelu(c2, ch),
            ConvBnRelu(c2 + 3 * ch, c2),
        ])
        self.convs = nn.ModuleList([nn.Conv2d(c2, ch, 1)])

    def forward(self, x, train: bool = False):
        for block in self.blocks[:6]:
            x = block(x, train)
        feat = x
        h, w = feat.shape[2:]

        def pooled(i, ph, pw):
            # flax's VALID avg_pool, window = stride = the floor of size / parts
            k = (max(h // ph, 1), max(w // pw, 1))
            p = self.blocks[6 + i](F.avg_pool2d(feat, k, stride=k), train)
            return resize_bilinear(p, h, w)

        spp = torch.cat([feat, pooled(0, 1, 1), pooled(1, 2, 2), pooled(2, 4, 4)], dim=1)
        return self.convs[0](self.blocks[9](spp, train))


def build_cost_volume(fl: torch.Tensor, fr: torch.Tensor, max_disp4: int) -> torch.Tensor:
    """Concatenation cost volume at 1/4 resolution: (N, 2C, D/4, H/4, W/4)
    from (N, C, H/4, W/4) features. The right features shift right by d so
    that cost[d] aligns left pixel x with right pixel x - d; columns shifted
    in are zero."""
    slices = []
    for d in range(max_disp4):
        shifted = fr if d == 0 else F.pad(fr[..., :-d], (d, 0))
        slices.append(torch.cat([fl, shifted], dim=1))
    return torch.stack(slices, dim=2)


class Hourglass3D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv3d(ch, ch * 2, 3, stride=2, padding=1, bias=False),
            nn.Conv3d(ch * 2, ch * 2, 3, padding=1, bias=False),
            nn.Conv3d(ch * 2, ch, 3, padding=1, bias=False)])
        self.norms = nn.ModuleList([BatchNorm(ch * 2), BatchNorm(ch * 2), BatchNorm(ch)])

    def forward(self, x, train: bool = False):
        down = F.relu(self.norms[0](self.convs[0](x), train))
        down = F.relu(self.norms[1](self.convs[1](down), train))
        up = resize_nearest(down, x.shape[2:])
        up = F.relu(self.norms[2](self.convs[2](up), train))
        return x + up


class PSMNet(nn.Module):
    """Stereo pair (N, 3, H, W) in [0, 1] -> disparity (N, 4*(H//4),
    4*(W//4)) in full-resolution pixels."""

    def __init__(self, max_disp: int = 64, feat_ch: int = 32):
        super().__init__()
        self.max_disp, self.feat_ch = max_disp, feat_ch
        c = feat_ch
        self.features = FeatureExtractor(c)
        self.convs = nn.ModuleList([nn.Conv3d(2 * c, c, 3, padding=1, bias=False),
                                    nn.Conv3d(c, 1, 3, padding=1)])
        self.norms = nn.ModuleList([BatchNorm(c)])
        self.hourglasses = nn.ModuleList([Hourglass3D(c), Hourglass3D(c)])

    def forward(self, left, right, train: bool = False):
        # one extractor, called on the left then the right images: in train
        # mode each call normalises by its own batch and updates the running
        # statistics in turn, as the flax module does
        fl = self.features(left, train)
        fr = self.features(right, train)
        d4 = self.max_disp // 4
        x = F.relu(self.norms[0](self.convs[0](build_cost_volume(fl, fr, d4)), train))
        for hg in self.hourglasses:
            x = hg(x, train)
        x = self.convs[1](x)[:, 0]  # (N, D4, H4, W4)
        # soft-argmin disparity regression at 1/4 resolution, in 1/4-res units
        prob = torch.softmax(-x, dim=1)
        disp_vals = torch.arange(d4, dtype=prob.dtype, device=prob.device)[None, :, None, None]
        disp4 = torch.sum(prob * disp_vals, dim=1)  # (N, H4, W4)
        n, h4, w4 = disp4.shape
        # upsample x4 and rescale to full-resolution pixels
        return resize_bilinear(disp4[:, None], h4 * 4, w4 * 4)[:, 0] * 4.0


def disparity_to_depth(disp: torch.Tensor, fx: float, baseline: float = 0.1,
                       min_disp: float = 0.1) -> torch.Tensor:
    """depth = fx * B / d (reference stereo baseline 0.1 m)."""
    return fx * baseline / torch.maximum(disp, disp.new_full((), min_disp))


def smooth_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """PSMNet's training loss: smooth-L1 over valid-disparity pixels."""
    d = pred - gt
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)


@torch.no_grad()
def stereo_infer(model: PSMNet, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Inference entry: eval-mode disparity, full float32 (no TF32)."""
    with fp.ieee_fp32():
        return model(left, right, train=False)
