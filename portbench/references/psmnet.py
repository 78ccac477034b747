"""Plain PSMNet, the published stacked-hourglass model (Chang & Chen,
"Pyramid Stereo Matching Network", CVPR 2018, arXiv:1803.08669; code
github.com/JiaRenChang/PSMNet, `models/stackhourglass.py`,
`models/submodule.py`, `main.py`): the forward pass, the three-head
smooth-L1 loss, Adam, the seeded weights that the benchmark hands to both
sides, and the step's analytic operation count.

Plain PyTorch, in the dtype of its input; it imports nothing of the port,
and pins TF32 off. Modules are named as the port names them, so that one
state dict loads into both. Departures from the published code:

- batch norms update the running variance with the biased batch variance
  (the port's convention; PyTorch's ``BatchNorm3d`` takes the unbiased
  one), keeping 0.9 of the running statistics as PyTorch's default does;
- resizes take ``align_corners=False`` (PyTorch's default since 0.4.1; the
  published code calls ``F.upsample`` without the argument);
- images in [0, 1] are normalised inside the model, by the ImageNet mean
  and std that the published loader applies;
- one card holds the batch of 12, its batch norms over all 12, where the
  publication split it by ``DataParallel``, 3 to a GPU.

With ``checkpoint=True`` the forward keeps only the stages' boundaries
(each tower, each 3D module, each head's regression) and recomputes the
rest in the backward, so that a float64 step at the published size fits
on one card; the recomputation does not touch the running statistics.

Inside `tf32_convs` every convolution, forward and backward, computes on
operands rounded to TF32's 10 mantissa bits, the control's precision.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from portbench.references.monodepth2 import adam_step, tf32_round  # noqa: F401 (re-exported)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
POOLS = (64, 32, 16, 8)


class _TF32Op(torch.autograd.Function):
    """A convolution ``op(x, w)`` whose products, forward and backward,
    take TF32-rounded operands."""

    @staticmethod
    def forward(ctx, x, w, op):
        xr, wr = tf32_round(x), tf32_round(w)
        ctx.save_for_backward(xr, wr)
        ctx.op = op
        return op(xr, wr)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        with torch.enable_grad():
            x, w = xr.detach().requires_grad_(), wr.detach().requires_grad_()
            gx, gw = torch.autograd.grad(ctx.op(x, w), (x, w), tf32_round(g))
        return gx, gw, None


class _Conv:
    """The control's switch, shared by the three convolution kinds."""

    tf32 = False


@contextlib.contextmanager
def tf32_convs():
    """Every convolution in scope computes on TF32-rounded inputs."""
    _Conv.tf32 = True
    try:
        yield
    finally:
        _Conv.tf32 = False


class Conv2d(nn.Conv2d):
    def forward(self, x):
        if not _Conv.tf32:
            return super().forward(x)
        return _TF32Op.apply(x, self.weight, lambda a, b: self._conv_forward(a, b, None))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        if not _Conv.tf32:
            return super().forward(x)
        return _TF32Op.apply(x, self.weight, lambda a, b: self._conv_forward(a, b, None))


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x):
        op = lambda a, b: F.conv_transpose3d(a, b, None, 2, 1, 1)  # noqa: E731
        return _TF32Op.apply(x, self.weight, op) if _Conv.tf32 else op(x, self.weight)


class BatchNorm(nn.Module):
    """Over the channels (dim 1); running statistics keep 0.9 and take the
    biased variance. ``frozen``: batch statistics, running ones untouched
    (a checkpoint's recomputation)."""

    frozen = False

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool):
        shape = (-1,) + (1,) * (x.ndim - 2)
        if train:
            dims = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            if not BatchNorm.frozen:
                with torch.no_grad():
                    self.running_mean.mul_(0.9).add_(0.1 * mean)
                    self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + 1e-5) * self.weight
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


class ConvBN(nn.Module):
    """``convbn`` / ``convbn_3d`` (padding: the dilation where it is over
    1); ``transpose``: ConvTranspose3d(3, stride 2, padding 1, output
    padding 1) and BN."""

    def __init__(self, cin, cout, k, stride=1, pad=1, dilation=1, dims=2, transpose=False):
        super().__init__()
        if transpose:
            self.conv = ConvTranspose3d(cin, cout, 3, 2, 1, 1, bias=False)
        else:
            conv = Conv2d if dims == 2 else Conv3d
            self.conv = conv(cin, cout, k, stride, dilation if dilation > 1 else pad,
                             dilation, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, train):
        return self.bn(self.conv(x), train)


class BasicBlock(nn.Module):
    def __init__(self, cin, c, stride, dilation):
        super().__init__()
        self.conv1 = ConvBN(cin, c, 3, stride, 1, dilation)
        self.conv2 = ConvBN(c, c, 3, 1, 1, dilation)
        self.downsample = ConvBN(cin, c, 1, stride, 0) if stride != 1 or cin != c else None

    def forward(self, x, train):
        out = self.conv2(F.relu(self.conv1(x, train)), train)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return out + x


class FeatureExtraction(nn.Module):
    def __init__(self, pools=POOLS):
        super().__init__()
        self.pools = tuple(pools)
        self.firstconv = nn.ModuleList([ConvBN(3, 32, 3, 2), ConvBN(32, 32, 3),
                                        ConvBN(32, 32, 3)])
        spec = {"layer1": (32, 32, 3, 1, 1), "layer2": (32, 64, 16, 2, 1),
                "layer3": (64, 128, 3, 1, 1), "layer4": (128, 128, 3, 1, 2)}
        for name, (cin, c, n, stride, dil) in spec.items():
            setattr(self, name, nn.ModuleList(
                [BasicBlock(cin, c, stride, dil)]
                + [BasicBlock(c, c, 1, dil) for _ in range(n - 1)]))
        self.branches = nn.ModuleList([ConvBN(128, 32, 1, 1, 0) for _ in self.pools])
        self.lastconv = ConvBN(320, 128, 3)
        self.lastconv_out = Conv2d(128, 32, 1, bias=False)

    def forward(self, x, train):
        for m in self.firstconv:
            x = F.relu(m(x, train))
        for m in self.layer1:
            x = m(x, train)
        for m in self.layer2:
            x = m(x, train)
        output_raw = x
        for m in self.layer3:
            x = m(x, train)
        for m in self.layer4:
            x = m(x, train)
        output_skip = x
        h, w = x.shape[2:]
        branch = {}
        for pool, m in zip(self.pools, self.branches):
            b = F.relu(m(F.avg_pool2d(output_skip, (pool, pool), (pool, pool)), train))
            branch[pool] = F.interpolate(b, (h, w), mode="bilinear", align_corners=False)
        # (output_raw, output_skip, branch4 .. branch1): the smallest pool first
        x = torch.cat([output_raw, output_skip] + [branch[p] for p in sorted(self.pools)], 1)
        return self.lastconv_out(F.relu(self.lastconv(x, train)))


class Hourglass(nn.Module):
    def __init__(self, c=32):
        super().__init__()
        self.conv1 = ConvBN(c, 2 * c, 3, 2, dims=3)
        self.conv2 = ConvBN(2 * c, 2 * c, 3, 1, dims=3)
        self.conv3 = ConvBN(2 * c, 2 * c, 3, 2, dims=3)
        self.conv4 = ConvBN(2 * c, 2 * c, 3, 1, dims=3)
        self.conv5 = ConvBN(2 * c, 2 * c, 3, transpose=True)
        self.conv6 = ConvBN(2 * c, c, 3, transpose=True)

    def forward(self, x, presqu, postsqu, train):
        out = F.relu(self.conv1(x, train))
        pre = self.conv2(out, train)
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = F.relu(self.conv3(pre, train))
        out = F.relu(self.conv4(out, train))
        if presqu is not None:
            post = F.relu(self.conv5(out, train) + presqu)
        else:
            post = F.relu(self.conv5(out, train) + pre)
        return self.conv6(post, train), pre, post


class Classifier(nn.Module):
    def __init__(self, c=32):
        super().__init__()
        self.conv = ConvBN(c, c, 3, dims=3)
        self.out = Conv3d(c, 1, 3, 1, 1, bias=False)

    def forward(self, x, train):
        return self.out(F.relu(self.conv(x, train)))


def cost_volume(ref, target, max_disp4: int):
    """The published volume: zeros, then for each disparity i the left
    features at x >= i and the right ones at x - i."""
    n, c, h, w = ref.shape
    cost = ref.new_zeros((n, 2 * c, max_disp4, h, w))
    for i in range(max_disp4):
        if i > 0:
            cost[:, :c, i, :, i:] = ref[:, :, :, i:]
            cost[:, c:, i, :, i:] = target[:, :, :, :-i]
        else:
            cost[:, :c, i] = ref
            cost[:, c:, i] = target
    return cost


def regression(cost, max_disp: int, h: int, w: int):
    """Trilinear to (max_disp, h, w), softmax over disparity, expectation
    of 0 .. max_disp - 1."""
    up = F.interpolate(cost, [max_disp, h, w], mode="trilinear", align_corners=False)
    prob = F.softmax(torch.squeeze(up, 1), dim=1)
    disp = torch.arange(max_disp, dtype=prob.dtype, device=prob.device).view(1, -1, 1, 1)
    return torch.sum(prob * disp, 1)


class PSMNet(nn.Module):
    def __init__(self, max_disp: int = 192, pools=POOLS):
        super().__init__()
        self.max_disp = max_disp
        self.feature_extraction = FeatureExtraction(pools)
        self.dres0 = nn.ModuleList([ConvBN(64, 32, 3, dims=3), ConvBN(32, 32, 3, dims=3)])
        self.dres1 = nn.ModuleList([ConvBN(32, 32, 3, dims=3), ConvBN(32, 32, 3, dims=3)])
        self.dres2, self.dres3, self.dres4 = Hourglass(), Hourglass(), Hourglass()
        self.classif1, self.classif2, self.classif3 = Classifier(), Classifier(), Classifier()

    def forward(self, left, right, train: bool, checkpoint: bool = False):
        """Images NCHW in [0, 1] -> (pred1, pred2, pred3) in train mode,
        pred3 in eval mode, each (N, H, W)."""
        def run(fn, *args):
            if checkpoint and torch.is_grad_enabled():
                return _checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        mean = torch.tensor(MEAN, dtype=left.dtype, device=left.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, dtype=left.dtype, device=left.device).view(1, 3, 1, 1)
        tower = lambda x: self.feature_extraction(x, train)  # noqa: E731
        ref = run(tower, (left - mean) / std)
        target = run(tower, (right - mean) / std)
        cost = cost_volume(ref, target, self.max_disp // 4)

        def dres0(x):
            return F.relu(self.dres0[1](F.relu(self.dres0[0](x, train)), train))

        def dres1(x):
            return self.dres1[1](F.relu(self.dres1[0](x, train)), train) + x

        cost0 = run(dres1, run(dres0, cost))
        out1, pre1, post1 = run(lambda x: self.dres2(x, None, None, train), cost0)
        out1 = out1 + cost0
        out2, _, post2 = run(lambda x, a, b: self.dres3(x, a, b, train), out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = run(lambda x, a, b: self.dres4(x, a, b, train), out2, pre1, post2)
        out3 = out3 + cost0
        cost1 = run(lambda x: self.classif1(x, train), out1)
        cost2 = run(lambda x: self.classif2(x, train), out2) + cost1
        cost3 = run(lambda x: self.classif3(x, train), out3) + cost2
        h, w = left.shape[2:]
        head = lambda c: regression(c, self.max_disp, h, w)  # noqa: E731
        if train:
            return run(head, cost1), run(head, cost2), run(head, cost3)
        return run(head, cost3)


def loss(model: PSMNet, batch: dict, checkpoint: bool = False):
    """(loss, (pred1, pred2, pred3)) of one batch (NHWC images in [0, 1],
    ``disp``, ``mask``): 0.5 L1 + 0.7 L2 + L3, each smooth-L1 averaged
    over the pixels with ``mask`` and 0 <= disp < max_disp (the published
    ``disp_true < maxdisp``)."""
    left, right = (batch[k].permute(0, 3, 1, 2) for k in ("left", "right"))
    gt = batch["disp"]
    preds = model(left, right, True, checkpoint)
    valid = (batch["mask"] > 0) & (gt >= 0) & (gt < model.max_disp)
    total = sum(wt * F.smooth_l1_loss(p[valid], gt[valid], reduction="mean")
                for wt, p in zip((0.5, 0.7, 1.0), preds))
    return total, preds


@contextlib.contextmanager
def frozen_statistics():
    """Batch norms leave their running statistics alone in scope."""
    BatchNorm.frozen = True
    try:
        yield
    finally:
        BatchNorm.frozen = False


# ------------------------------------------------------------- weights

def make_weights(model: nn.Module, seed: int, device) -> dict:
    """The published initialisation of every parameter and statistic of
    ``model``'s state dict, from one float32 draw on ``device`` (a
    generator seeded with ``seed``), in sorted order of the names:
    Conv2d/Conv3d kernels normal(0, sqrt(2 / (kernel size x out
    channels))); ConvTranspose3d kernels PyTorch's default, uniform within
    1 / sqrt(fan-in), fan-in = out channels x 27; batch norms scale 1, shift
    0, running mean 0, variance 1."""
    transposed = {n + ".weight" for n, m in model.named_modules()
                  if isinstance(m, nn.ConvTranspose3d)}
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, t in sorted(model.state_dict().items()):
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if name in transposed:
            bound = 1.0 / math.sqrt(shape[1] * math.prod(shape[2:]))
            u = torch.rand(shape, generator=gen, device=device)
            out[name] = (2 * u - 1) * bound
        elif len(shape) >= 4:
            n = math.prod(shape[2:]) * shape[0]
            out[name] = torch.randn(shape, generator=gen, device=device) * math.sqrt(2.0 / n)
        elif leaf in ("weight", "running_var"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ------------------------------------------------------- operation count

def _conv(n, cin, cout, k3, spatial) -> int:
    return 2 * n * cin * cout * k3 * spatial


def features_flops(n: int, h: int, w: int, pools=POOLS) -> int:
    """Multiply-adds x 2 of one tower's convolutions on n images."""
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    f = _conv(n, 3, 32, 9, h2 * w2) + 2 * _conv(n, 32, 32, 9, h2 * w2)
    f += 3 * 2 * _conv(n, 32, 32, 9, h2 * w2)                       # layer1
    f += _conv(n, 32, 64, 9, h4 * w4) + _conv(n, 64, 64, 9, h4 * w4) \
        + _conv(n, 32, 64, 1, h4 * w4) + 15 * 2 * _conv(n, 64, 64, 9, h4 * w4)  # layer2
    f += _conv(n, 64, 128, 9, h4 * w4) + _conv(n, 128, 128, 9, h4 * w4) \
        + _conv(n, 64, 128, 1, h4 * w4) + 2 * 2 * _conv(n, 128, 128, 9, h4 * w4)  # layer3
    f += 3 * 2 * _conv(n, 128, 128, 9, h4 * w4)                     # layer4
    f += sum(_conv(n, 128, 32, 1, (h4 // p) * (w4 // p)) for p in pools)
    f += _conv(n, 320, 128, 9, h4 * w4) + _conv(n, 128, 32, 1, h4 * w4)
    return f


def regularize_flops(n: int, h: int, w: int, max_disp: int = 192) -> int:
    """The same for the 3D part: dres0, dres1, three hourglasses (a
    transposed convolution counted over its input, as PyTorch's counter
    does) and three classifiers."""
    v4 = (max_disp // 4) * (h // 4) * (w // 4)
    v8 = (max_disp // 8) * (h // 8) * (w // 8)
    v16 = (max_disp // 16) * (h // 16) * (w // 16)
    f = _conv(n, 64, 32, 27, v4) + 3 * _conv(n, 32, 32, 27, v4)     # dres0, dres1
    hourglass = (_conv(n, 32, 64, 27, v8) + _conv(n, 64, 64, 27, v8)
                 + _conv(n, 64, 64, 27, v16) + _conv(n, 64, 64, 27, v16)
                 + _conv(n, 64, 64, 27, v16) + _conv(n, 64, 32, 27, v8))
    classifier = _conv(n, 32, 32, 27, v4) + _conv(n, 32, 1, 27, v4)
    return f + 3 * hourglass + 3 * classifier


def forward_flops(n: int, h: int, w: int, max_disp: int = 192, pools=POOLS) -> int:
    """One forward pass on n pairs of (h, w): both towers and the 3D part."""
    return 2 * features_flops(n, h, w, pools) + regularize_flops(n, h, w, max_disp)


def train_step_flops(n: int, h: int, w: int, max_disp: int = 192, pools=POOLS) -> int:
    """One training step, forward and backward (backward counted as twice
    forward)."""
    return 3 * forward_flops(n, h, w, max_disp, pools)
