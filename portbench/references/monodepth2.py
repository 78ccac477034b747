"""Plain Monodepth2 (github.com/nianticlabs/monodepth2): the ResNet-18 depth
encoder and decoder, the separate ResNet-18 pose encoder of frame pairs and
its decoder, the self-supervised loss, Adam, the nets' analytic operation
count, and the seeded weights that the benchmark hands to both sides.

Plain PyTorch, in the dtype of its input; it imports nothing of the port.
It keeps the semantics the port documents for the same model, where they
depart from the published PyTorch code: batch norms keep 0.99 of their
running statistics and update the variance with the biased batch variance
(flax's convention); resizes that shrink are antialiased; the pose
decoder's output is scaled by 0.01 and averaged over space. Modules are
named as the port names them, so that one state dict loads into both.

Inside `tf32_convs` every convolution, forward and backward, computes on
operands rounded to TF32's 10 mantissa bits, the control's precision.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

ENC_CH = (64, 64, 128, 256, 512)
DEC_CH = (16, 32, 64, 128, 256)
SCALES = (0, 1, 2, 3)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32).to(x.dtype)


class _TF32Conv(torch.autograd.Function):
    """A convolution whose products, forward and backward, take TF32-rounded
    operands, as a TF32 convolution's do."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        xr, wr = tf32_round(x), tf32_round(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding, b is not None)
        return F.conv2d(xr, wr, b, stride, padding)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        stride, padding, has_b = ctx.conf
        gr = tf32_round(g)
        gx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, stride, padding)
        gw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, stride, padding)
        return gx, gw, g.sum((0, 2, 3)) if has_b else None, None, None


class Conv(nn.Conv2d):
    """nn.Conv2d whose products take TF32-rounded operands inside
    `tf32_convs`."""

    tf32 = False

    def forward(self, x):
        if not Conv.tf32:
            return super().forward(x)
        return _TF32Conv.apply(x, self.weight, self.bias, self.stride, self.padding)


@contextlib.contextmanager
def tf32_convs():
    """Every `Conv` in scope computes on TF32-rounded inputs."""
    Conv.tf32 = True
    try:
        yield
    finally:
        Conv.tf32 = False


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.99).add_(0.01 * mean)
                self.running_var.mul_(0.99).add_(0.01 * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + 1e-5) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        convs = [Conv(cin, c, 3, stride, 1, bias=False), Conv(c, c, 3, 1, 1, bias=False)]
        if stride != 1 or cin != c:
            convs.append(Conv(cin, c, 1, stride, bias=False))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchNorm(c) for _ in convs)

    def forward(self, x, train):
        y = F.relu(self.norms[0](self.convs[0](x), train))
        y = self.norms[1](self.convs[1](y), train)
        skip = self.norms[2](self.convs[2](x), train) if len(self.convs) > 2 else x
        return F.relu(y + skip)


class Encoder(nn.Module):
    """ResNet-18 over ``frames`` RGB frames stacked on the channels,
    ImageNet-normalised; features at /2, /4, /8, /16, /32."""

    def __init__(self, frames: int = 1):
        super().__init__()
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406] * frames,
                                                  dtype=torch.float64).view(1, -1, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225] * frames,
                                                 dtype=torch.float64).view(1, -1, 1, 1),
                             persistent=False)
        self.convs = nn.ModuleList([Conv(3 * frames, 64, 7, 2, 3, bias=False)])
        self.norms = nn.ModuleList([BatchNorm(64)])
        blocks, cin = [], 64
        for stage, c in enumerate(ENC_CH[1:]):
            for i in range(2):
                blocks.append(BasicBlock(cin, c, 2 if stage > 0 and i == 0 else 1))
                cin = c
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, train):
        x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        y = F.relu(self.norms[0](self.convs[0](x), train))
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for i, block in enumerate(self.blocks):
            y = block(y, train)
            if i % 2 == 1:
                feats.append(y)
        return feats


def _reflect_conv(conv, x):
    return conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.convs = nn.ModuleList([Conv(cin, c, 3)])

    def forward(self, x):
        return F.elu(_reflect_conv(self.convs[0], x))


class DepthDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        blocks, cin = [], ENC_CH[-1]
        for i in range(4, -1, -1):
            blocks.append(ConvBlock(cin, DEC_CH[i]))
            blocks.append(ConvBlock(DEC_CH[i] + (ENC_CH[i - 1] if i > 0 else 0), DEC_CH[i]))
            cin = DEC_CH[i]
        self.convblocks = nn.ModuleList(blocks)
        self.dispconvs = nn.ModuleDict({str(s): Conv(DEC_CH[s], 1, 3) for s in SCALES})

    def forward(self, feats):
        out, x = {}, feats[-1]
        for k, i in enumerate(range(4, -1, -1)):
            x = F.interpolate(self.convblocks[2 * k](x), scale_factor=2, mode="nearest")
            if i > 0:
                skip = feats[i - 1]
                x = torch.cat([x[:, :, :skip.shape[2], :skip.shape[3]], skip], dim=1)
            x = self.convblocks[2 * k + 1](x)
            if i in SCALES:
                out[i] = torch.sigmoid(_reflect_conv(self.dispconvs[str(i)], x))
        return out


class PoseDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList([Conv(512, 256, 1), Conv(256, 256, 3, padding=1),
                                    Conv(256, 256, 3, padding=1), Conv(256, 6, 1)])

    def forward(self, f):
        for conv in self.convs[:3]:
            f = F.relu(conv(f))
        y = 0.01 * self.convs[3](f).mean(dim=(2, 3))
        return y[:, :3], y[:, 3:]


class PoseNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = Encoder(frames=2)
        self.decoder = PoseDecoder()

    def forward(self, a, b, train):
        return self.decoder(self.encoder(torch.cat([a, b], dim=1), train)[-1])


class Monodepth2(nn.Module):
    """Images NHWC in [0, 1]; disparities NHWC (N, h, w, 1) by scale."""

    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = DepthDecoder()
        self.pose_net = PoseNet()

    def depth(self, img, train: bool):
        d = self.decoder(self.encoder(img.permute(0, 3, 1, 2), train))
        return {k: v.permute(0, 2, 3, 1) for k, v in d.items()}

    def pose(self, a, b, train: bool):
        return self.pose_net(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2), train)


# ------------------------------------------------------------- weights

def make_weights(model: nn.Module, seed: int, device) -> dict:
    """The benchmark's weights for every parameter and statistic of
    ``model``'s state dict, from one float32 normal draw on ``device``:
    convolution kernels lecun-normal (variance 1 / fan-in), biases 0.1 n,
    batch-norm scales 1 + 0.1 n and shifts 0.1 n, running means 0.1 n and
    variances 1 + 0.2 |n|."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name in sorted(shapes):
        shape = shapes[name]
        n = flat[at: at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) == 4:
            w = n * math.sqrt(1.0 / math.prod(shape[1:]))
        elif leaf == "running_var":
            w = 1.0 + 0.2 * n.abs()
        elif leaf == "weight":  # a batch norm's scale
            w = 1.0 + 0.1 * n
        else:
            w = 0.1 * n
        out[name] = w.contiguous()
    return out


# ---------------------------------------------------------------- loss

def disp_to_depth(disp, min_depth, max_depth):
    lo, hi = 1.0 / max_depth, 1.0 / min_depth
    scaled = lo + (hi - lo) * disp
    return scaled, 1.0 / scaled


def resize(x, h, w):
    """NHWC bilinear, half-pixel centres, antialiased where it shrinks."""
    if x.shape[1:3] == (h, w):
        return x
    shrink = h < x.shape[1] or w < x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


def axis_angle_to_matrix(aa, eps: float = 1e-8):
    theta = torch.sqrt((aa * aa).sum(-1, keepdim=True) + eps * eps)
    k = aa / theta
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    kx, ky, kz = k.unbind(-1)
    z = torch.zeros_like(kx)
    K = torch.stack([z, -kz, ky, kz, z, -kx, -ky, kx, z], -1).view(aa.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def transform(aa, t, invert: bool):
    R = axis_angle_to_matrix(aa)
    if invert:
        R = R.transpose(-1, -2)
        t = -(R @ t[..., None])[..., 0]
    T = torch.zeros(aa.shape[0], 4, 4, dtype=aa.dtype, device=aa.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    return T


def warp(src, depth, T, fx, fy, cx, cy):
    """Source NHWC sampled at the target's pixels moved by depth and T,
    bilinear with border clamping (grid_sample in pixel units)."""
    N, H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[None, :, None]
    P = torch.stack([(u - cx) / fx * depth, (v - cy) / fy * depth, depth,
                     torch.ones_like(depth)], -1)
    Pc = (T[:, None, None] @ P[..., None])[..., 0]
    z = torch.clamp(Pc[..., 2], min=1e-3)
    px, py = Pc[..., 0] / z * fx + cx, Pc[..., 1] / z * fy + cy
    grid = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1)
    out = F.grid_sample(src.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def _pool3(x):
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, 1)


def ssim(x, y):
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    mx, my = _pool3(x), _pool3(y)
    sx, sy, sxy = _pool3(x * x) - mx ** 2, _pool3(y * y) - my ** 2, _pool3(x * y) - mx * my
    n = (2 * mx * my + C1) * (2 * sxy + C2)
    d = (mx ** 2 + my ** 2 + C1) * (sx + sy + C2)
    s = torch.minimum(torch.maximum((1 - n / d) / 2, x.new_zeros(())), x.new_ones(()))
    return s.permute(0, 2, 3, 1)


def reprojection(pred, target):
    return 0.85 * ssim(pred, target).mean(-1) + 0.15 * (pred - target).abs().mean(-1)


def smoothness(disp, img):
    d = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
    dx = (d[:, :, 1:] - d[:, :, :-1]).abs() * torch.exp(
        -(img[:, :, 1:] - img[:, :, :-1]).abs().mean(-1, keepdim=True))
    dy = (d[:, 1:] - d[:, :-1]).abs() * torch.exp(
        -(img[:, 1:] - img[:, :-1]).abs().mean(-1, keepdim=True))
    return dx.mean() + dy.mean()


def loss(model: Monodepth2, batch: dict, noise, cfg: dict):
    """The training loss of one batch: multi-scale photometric (0.85 SSIM +
    0.15 L1, minimum over sources with identity automasking, ties broken by
    ``noise`` x 1e-5) plus edge-aware smoothness 1e-3 / 2^scale; pose from
    the pose net on [prev, target] (inverted) and [target, next]."""
    target, prev, nxt = batch["target"], batch["prev"], batch["next"]
    N, H, W, _ = target.shape
    disps = model.depth(target, True)
    T_prev = transform(*model.pose(prev, target, True), invert=True)
    T_next = transform(*model.pose(target, nxt, True), invert=False)
    fx, fy, cx, cy = cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"]
    sources = [prev, nxt]
    ident = torch.stack([reprojection(s, target) for s in sources]) + noise.to(target.dtype) * 1e-5
    total = 0.0
    for scale in SCALES:
        disp = disps[scale]
        _, depth = disp_to_depth(resize(disp, H, W)[..., 0], cfg["min_depth"], cfg["max_depth"])
        reproj = torch.stack([reprojection(warp(s, depth, T, fx, fy, cx, cy), target)
                              for s, T in zip(sources, (T_prev, T_next))])
        photo = torch.amin(torch.cat([ident, reproj]), dim=0).mean()
        smooth = smoothness(disp, resize(target, disp.shape[1], disp.shape[2]))
        total = total + photo + cfg["smoothness"] * smooth / (2 ** scale)
    return total / len(SCALES)


def adam_step(params, grads, state, step: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """Adam (eps outside the square root), in place, in the params' dtype."""
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = m / (1 - b1 ** step)
            vhat = v / (1 - b2 ** step)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))


# ------------------------------------------------------- operation count

def _out(i: int, k: int, s: int, p: int) -> int:
    return (i + 2 * p - k) // s + 1


def _conv(cin, cout, k, h, w) -> int:
    return 2 * cin * cout * k * k * h * w


def _encoder(n: int, h: int, w: int, frames: int):
    """(flops, feature sizes) of the ResNet-18 encoder at (h, w)."""
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    flops = _conv(3 * frames, 64, 7, h, w)
    sizes = [(h, w)]
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    for stage, c in enumerate(ENC_CH[1:]):
        for i in range(2):
            s = 2 if stage > 0 and i == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            flops += _conv(cin, c, 3, ho, wo) + _conv(c, c, 3, ho, wo)
            if s != 1 or cin != c:
                flops += _conv(cin, c, 1, ho, wo)
            h, w, cin = ho, wo, c
        sizes.append((h, w))
    return n * flops, sizes


def depth_forward_flops(n: int, h: int, w: int) -> int:
    """Multiply-adds x 2 of the convolutions of the depth encoder and
    decoder on n frames of (h, w), from the published architecture."""
    flops, sizes = _encoder(n, h, w, 1)
    dec = 0
    sh, sw = sizes[-1]
    cin = ENC_CH[-1]
    for i in range(4, -1, -1):
        dec += _conv(cin, DEC_CH[i], 3, sh, sw)
        sh, sw = 2 * sh, 2 * sw
        skip = 0
        if i > 0:
            sh, sw = min(sh, sizes[i - 1][0]), min(sw, sizes[i - 1][1])
            skip = ENC_CH[i - 1]
        dec += _conv(DEC_CH[i] + skip, DEC_CH[i], 3, sh, sw)
        if i in SCALES:
            dec += _conv(DEC_CH[i], 1, 3, sh, sw)
        cin = DEC_CH[i]
    return flops + n * dec


def pose_forward_flops(n: int, h: int, w: int) -> int:
    """The same for the pose encoder on n frame pairs and its decoder."""
    flops, sizes = _encoder(n, h, w, 2)
    h5, w5 = sizes[-1]
    return flops + n * (_conv(512, 256, 1, h5, w5) + 2 * _conv(256, 256, 3, h5, w5)
                        + _conv(256, 6, 1, h5, w5))


def train_step_flops(n: int, h: int, w: int) -> int:
    """One training step: the depth net on the targets and the pose net on
    two pairs, forward and backward (backward counted as twice forward)."""
    return 3 * (depth_forward_flops(n, h, w) + 2 * pose_forward_flops(n, h, w))
