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

`StackHourglassPSMNet` is the published model (Chang & Chen, CVPR 2018,
github.com/JiaRenChang/PSMNet, `models/stackhourglass.py` and
`models/submodule.py`), beside the sibling above: a residual feature tower
with four SPP branches, a cost volume zero in both halves where x < d,
three stacked hourglasses with transposed 3D convolutions and skips, three
heads regressed at full resolution. Its modules take the published names;
its batch norms keep 0.9 of their running statistics, as PyTorch's do, with
the port's biased variance.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.core import fp
from tpu3drec_torch.models.resnet import BatchNorm
from tpu3drec_torch.utils import tracing
from tpu3drec_torch.utils.tracing import span


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


# ------------------------------------------------- the published PSMNet

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_KEEP = 0.9  # PyTorch's BatchNorm momentum 0.1: 0.9 of the running statistics kept


class ConvBN(nn.Module):
    """The published ``convbn`` / ``convbn_3d``: a convolution with no bias
    (padding ``dilation`` when the dilation is over 1, else ``pad``), then
    batch norm. ``transpose``: the hourglass's ``ConvTranspose3d`` (kernel
    3, stride 2, padding 1, output padding 1)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, pad: int = 1,
                 dilation: int = 1, dims: int = 2, transpose: bool = False):
        super().__init__()
        if transpose:
            self.conv = nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1, output_padding=1,
                                           bias=False)
        else:
            conv = nn.Conv2d if dims == 2 else nn.Conv3d
            self.conv = conv(cin, cout, k, stride=stride,
                             padding=dilation if dilation > 1 else pad, dilation=dilation,
                             bias=False)
        self.bn = BatchNorm(cout, momentum=BN_KEEP)

    def forward(self, x, train: bool = False):
        return self.bn(self.conv(x), train)


class ResBlock(nn.Module):
    """The published ``BasicBlock``: conv-BN-ReLU, conv-BN, plus the shortcut
    (a 1x1 conv and BN where the stride or the width changes), and no ReLU
    after the sum."""

    def __init__(self, cin: int, cout: int, stride: int, dilation: int):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, stride, 1, dilation)
        self.conv2 = ConvBN(cout, cout, 3, 1, 1, dilation)
        self.downsample = (ConvBN(cin, cout, 1, stride, 0)
                           if stride != 1 or cin != cout else None)

    def forward(self, x, train: bool = False):
        out = self.conv2(F.relu(self.conv1(x, train)), train)
        return out + (x if self.downsample is None else self.downsample(x, train))


def _layer(cin: int, cout: int, blocks: int, stride: int, dilation: int) -> nn.ModuleList:
    return nn.ModuleList([ResBlock(cin if i == 0 else cout, cout, stride if i == 0 else 1,
                                   dilation) for i in range(blocks)])


class StackFeatures(nn.Module):
    """The published ``feature_extraction``: (N, 3, H, W) -> (N, 32, H/4,
    W/4). Three conv blocks (the first of stride 2), residual layers of 3 x
    32, 16 x 64 (stride 2), 3 x 128 and 3 x 128 (dilation 2), four SPP
    branches (average pools of ``pools`` px, a 1x1 conv-BN-ReLU to 32, a
    bilinear resize back), then (layer2, layer4, branches from the smallest
    pool up) -> 320 -> conv-BN-ReLU 128 -> 1x1 conv 32."""

    def __init__(self, pools):
        super().__init__()
        self.pools = tuple(pools)
        self.firstconv = nn.ModuleList([ConvBN(3, 32, 3, 2), ConvBN(32, 32, 3), ConvBN(32, 32, 3)])
        self.layer1 = _layer(32, 32, 3, 1, 1)
        self.layer2 = _layer(32, 64, 16, 2, 1)
        self.layer3 = _layer(64, 128, 3, 1, 1)
        self.layer4 = _layer(128, 128, 3, 1, 2)
        self.branches = nn.ModuleList([ConvBN(128, 32, 1, 1, 0) for _ in self.pools])
        self.lastconv = ConvBN(320, 128, 3)
        self.lastconv_out = nn.Conv2d(128, 32, 1, bias=False)

    def forward(self, x, train: bool = False):
        for block in self.firstconv:
            x = F.relu(block(x, train))
        for block in self.layer1:
            x = block(x, train)
        for block in self.layer2:
            x = block(x, train)
        raw = x
        for block in (*self.layer3, *self.layer4):
            x = block(x, train)
        h, w = x.shape[2:]
        spp = []
        for pool, branch in zip(self.pools, self.branches):
            p = F.relu(branch(F.avg_pool2d(x, pool, stride=pool), train))
            spp.append(F.interpolate(p, size=(h, w), mode="bilinear", align_corners=False))
        x = torch.cat([raw, x] + spp[::-1], dim=1)
        return self.lastconv_out(F.relu(self.lastconv(x, train)))


def build_stack_cost_volume(fl: torch.Tensor, fr: torch.Tensor, max_disp4: int) -> torch.Tensor:
    """The published concatenation volume (N, 2C, D/4, H/4, W/4): at
    disparity d, column x holds (left[x], right[x - d]) for x >= d and
    zeros in both halves for x < d."""
    slices = []
    for d in range(max_disp4):
        pair = torch.cat([fl, fr], dim=1) if d == 0 else torch.cat([fl[..., d:], fr[..., :-d]], 1)
        slices.append(F.pad(pair, (d, 0)))
    return torch.stack(slices, dim=2)


class Hourglass(nn.Module):
    """The published ``hourglass``: 1/4 -> 1/8 -> 1/16 and back by
    transposed convolutions, with the skips ``presqu`` / ``postsqu`` carried
    from the hourglass before. Returns (out, pre, post)."""

    def __init__(self, c: int = 32):
        super().__init__()
        self.conv1 = ConvBN(c, 2 * c, 3, 2, dims=3)
        self.conv2 = ConvBN(2 * c, 2 * c, 3, 1, dims=3)
        self.conv3 = ConvBN(2 * c, 2 * c, 3, 2, dims=3)
        self.conv4 = ConvBN(2 * c, 2 * c, 3, 1, dims=3)
        self.conv5 = ConvBN(2 * c, 2 * c, 3, transpose=True)
        self.conv6 = ConvBN(2 * c, c, 3, transpose=True)

    def forward(self, x, presqu, postsqu, train: bool = False):
        out = F.relu(self.conv1(x, train))
        pre = self.conv2(out, train)
        pre = F.relu(pre if postsqu is None else pre + postsqu)
        out = F.relu(self.conv4(F.relu(self.conv3(pre, train)), train))
        post = F.relu(self.conv5(out, train) + (pre if presqu is None else presqu))
        return self.conv6(post, train), pre, post


class Classifier(nn.Module):
    """``classif``: conv-BN-ReLU, then a 3x3x3 conv to one channel."""

    def __init__(self, c: int = 32):
        super().__init__()
        self.conv = ConvBN(c, c, 3, dims=3)
        self.out = nn.Conv3d(c, 1, 3, padding=1, bias=False)

    def forward(self, x, train: bool = False):
        return self.out(F.relu(self.conv(x, train)))


SPP_POOLS = (64, 32, 16, 8)  # the published SPP branches' average pools, in px at 1/4


def regress_disparity(cost: torch.Tensor, max_disp: int, h: int, w: int) -> torch.Tensor:
    """(N, 1, D/4, H/4, W/4) cost -> (N, H, W) disparity: trilinear to
    (max_disp, h, w) (align_corners False), softmax over disparity (of the
    cost, not its negative), expectation of ``arange(max_disp)``. Counts the
    three full-resolution volumes it makes under ``psmnet.volume_bytes``."""
    up = F.interpolate(cost, size=(max_disp, h, w), mode="trilinear", align_corners=False)[:, 0]
    prob = torch.softmax(up, dim=1)
    weighted = prob * torch.arange(max_disp, dtype=prob.dtype, device=prob.device)[:, None, None]
    tracing.count("psmnet.volume_bytes", sum(v.numel() * v.element_size()
                                             for v in (up, prob, weighted)))
    return weighted.sum(dim=1)


class StackHourglassPSMNet(nn.Module):
    """The published stacked-hourglass PSMNet. Stereo pair (N, 3, H, W) in
    [0, 1] (ImageNet-normalised inside, as the published loader does) ->
    disparity (N, H, W) in pixels; H and W multiples of 16. ``train``: the
    three heads' (pred1, pred2, pred3), batch norms over the batch; else
    pred3.

    Program spans of the forward: ``psmnet.features`` (both towers),
    ``psmnet.cost_volume``, ``psmnet.regularize`` (dres0/dres1, the
    hourglasses, the classifiers) and ``psmnet.regress``; counter
    ``psmnet.volume_bytes``: the cost volume's bytes and each head's three
    full-resolution volumes'."""

    def __init__(self, max_disp: int = 192, spp_pools=SPP_POOLS):
        super().__init__()
        self.max_disp = max_disp
        # float64, so that a float64 model normalises by the exact constants
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN, dtype=torch.float64)
                             .view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD, dtype=torch.float64)
                             .view(1, 3, 1, 1), persistent=False)
        self.feature_extraction = StackFeatures(spp_pools)
        self.dres0 = nn.ModuleList([ConvBN(64, 32, 3, dims=3), ConvBN(32, 32, 3, dims=3)])
        self.dres1 = nn.ModuleList([ConvBN(32, 32, 3, dims=3), ConvBN(32, 32, 3, dims=3)])
        self.dres2, self.dres3, self.dres4 = Hourglass(), Hourglass(), Hourglass()
        self.classif1, self.classif2, self.classif3 = Classifier(), Classifier(), Classifier()

    def regularize(self, cost, train: bool = False):
        """The cost volume -> the three heads' summed costs (cost1, cost2,
        cost3), each (N, 1, D/4, H/4, W/4)."""
        cost0 = F.relu(self.dres0[0](cost, train))
        cost0 = F.relu(self.dres0[1](cost0, train))
        cost0 = self.dres1[1](F.relu(self.dres1[0](cost0, train)), train) + cost0
        out1, pre1, post1 = self.dres2(cost0, None, None, train)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1, train)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2, train)
        out3 = out3 + cost0
        cost1 = self.classif1(out1, train)
        cost2 = self.classif2(out2, train) + cost1
        return cost1, cost2, self.classif3(out3, train) + cost2

    def forward(self, left, right, train: bool = False):
        h, w = left.shape[2:]
        mean, std = self.mean.to(left.dtype), self.std.to(left.dtype)
        with span("psmnet.features"):
            fl = self.feature_extraction((left - mean) / std, train)
            fr = self.feature_extraction((right - mean) / std, train)
        with span("psmnet.cost_volume"):
            cost = build_stack_cost_volume(fl, fr, self.max_disp // 4)
            tracing.count("psmnet.volume_bytes", cost.numel() * cost.element_size())
        with span("psmnet.regularize"):
            costs = self.regularize(cost, train)
        with span("psmnet.regress"):
            preds = [regress_disparity(c, self.max_disp, h, w) for c in costs[0 if train else 2:]]
        return tuple(preds) if train else preds[0]


def init_psmnet_params(model: nn.Module, generator: torch.Generator) -> None:
    """The published initialisation, drawn from ``generator`` (a CPU
    generator, so that one seed gives the same weights on every device):
    ``Conv2d``/``Conv3d`` kernels normal(0, sqrt(2 / n)), n = the kernel's
    size times its output channels; ``ConvTranspose3d`` PyTorch's default
    (kaiming-uniform, a = sqrt(5)); batch norms scale 1, shift 0, running
    mean 0, variance 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                n = math.prod(m.kernel_size) * m.out_channels
                w = torch.empty(m.weight.shape).normal_(0.0, math.sqrt(2.0 / n),
                                                        generator=generator)
                m.weight.copy_(w)
            elif isinstance(m, nn.ConvTranspose3d):
                w = torch.empty(m.weight.shape)
                nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
                m.weight.copy_(w)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def disparity_to_depth(disp: torch.Tensor, fx: float, baseline: float = 0.1,
                       min_disp: float = 0.1) -> torch.Tensor:
    """depth = fx * B / d (reference stereo baseline 0.1 m)."""
    return fx * baseline / torch.maximum(disp, disp.new_full((), min_disp))


def smooth_l1_terms(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    """(sum of the smooth-L1 over valid pixels, the number of valid
    pixels): the numerator and denominator of `smooth_l1_loss`."""
    d = pred - gt
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    return torch.sum(loss * mask), torch.sum(mask)


def smooth_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """PSMNet's training loss: smooth-L1 over valid-disparity pixels."""
    num, den = smooth_l1_terms(pred, gt, mask)
    return num / torch.clamp(den, min=1.0)


@torch.no_grad()
def stereo_infer(model: PSMNet, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Inference entry: eval-mode disparity, full float32 (no TF32)."""
    with fp.ieee_fp32():
        return model(left, right, train=False)
