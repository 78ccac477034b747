"""Monodepth2-class self-supervised monocular depth: model + losses (port
of `tpu3drec/models/monodepth.py`).

The reference's training semantics: disparity -> depth with (min, max)
depth (0.1, 100); photometric reprojection loss 0.85 SSIM + 0.15 L1 with a
per-pixel minimum over sources and identity-reprojection automasking;
edge-aware smoothness on mean-normalised disparity, weighted 1e-3 / 2^scale;
scales [0..3], each scale's disparity upsampled to full resolution before
the photometric term; pose from the 2-frame pose net or from ground truth.

The nets run in NCHW; the functions here keep the JAX package's NHWC
contract: images (N, H, W, 3) in [0, 1], disparities (N, h, w, 1), depth
(N, H, W). Resizes follow `jax.image.resize`'s "bilinear": half-pixel
centres, and an antialiasing filter where it shrinks. Every clip is
min(max(.)), whose derivative at a bound is jnp.clip's (`core/fp.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.core import fp
from tpu3drec_torch.core.se3 import axis_angle_to_matrix
from tpu3drec_torch.models.depth_decoder import DepthDecoder
from tpu3drec_torch.models.pose_net import PoseNet
from tpu3drec_torch.models.resnet import ResNetEncoder
from tpu3drec_torch.ops.quadpack import bilinear_sample_quad, quad_pack


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (N, h, w, C), "bilinear")`` on NHWC: half-pixel
    centres, antialiased when it shrinks (a no-op filter when it grows)."""
    if x.shape[1:3] == (h, w):
        return x
    shrink = h < x.shape[1] or w < x.shape[2]
    return _nhwc(F.interpolate(_nchw(x), size=(h, w), mode="bilinear",
                               align_corners=False, antialias=shrink))


# ---------------------------------------------------------------- depth math

def disp_to_depth(disp, min_depth: float = 0.1, max_depth: float = 100.0):
    """Sigmoid disparity -> (scaled_disp, depth), upstream monodepth2
    convention."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def transformation_from_parameters(axisangle, translation, invert: bool = False):
    """(N, 3) + (N, 3) -> cam_T_cam (N, 4, 4); ``invert`` gives the inverse
    transform (R^T, -R^T t)."""
    R = axis_angle_to_matrix(axisangle)
    t = translation
    if invert:
        R = R.transpose(-1, -2)
        t = -torch.einsum("nij,nj->ni", R, t)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(axisangle.shape[:-1] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


# ------------------------------------------------------------------- warping

def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Differentiable bilinear sampling with border clamping: img (H, W, C);
    x, y (H', W') absolute pixel coordinates. Equivalent to torch's
    ``grid_sample(padding_mode="border")`` in pixel units."""
    return bilinear_sample_quad(quad_pack(img), x, y)


def warp_coords(depth: torch.Tensor, T: torch.Tensor, fx, fy, cx, cy):
    """Backproject target depth, transform by cam_T_cam, project into the
    source camera. depth (N, H, W); T (N, 4, 4) -> (px, py) each (N, H, W)."""
    N, H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    X = (u - cx) / fx * depth
    Y = (v - cy) / fy * depth
    P = torch.stack([X, Y, depth, torch.ones_like(depth)], dim=-1)  # (N,H,W,4)
    Pc = torch.einsum("nij,nhwj->nhwi", T, P)
    z = torch.maximum(Pc[..., 2], Pc.new_full((), 1e-3))
    px = Pc[..., 0] / z * fx + cx
    py = Pc[..., 1] / z * fy + cy
    return px, py


def warp_frame(src: torch.Tensor, depth: torch.Tensor, T: torch.Tensor,
               fx, fy, cx, cy) -> torch.Tensor:
    """Warp each source (N, H, W, C) into the target view by the target's
    depth (N, H, W) and cam_T_cam (N, 4, 4)."""
    return warp_frame_quad(quad_pack(src), depth, T, fx, fy, cx, cy)


def warp_frame_quad(src_q: torch.Tensor, depth: torch.Tensor, T: torch.Tensor,
                    fx, fy, cx, cy) -> torch.Tensor:
    """`warp_frame` on a quad-packed source (N, H, W, 4C), so the loss packs
    each source once for all scales' warps."""
    px, py = warp_coords(depth, T, fx, fy, cx, cy)
    return torch.stack([bilinear_sample_quad(q, x, y) for q, x, y in zip(src_q, px, py)])


# --------------------------------------------------------------------- SSIM

def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean, stride 1, reflect pad (upstream SSIM's pooling), NCHW."""
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, stride=1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM distance in [0, 1]: clip((1 - SSIM) / 2) (upstream
    ``layers.SSIM``). NHWC in and out."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    x, y = _nchw(x), _nchw(y)
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x ** 2
    sigma_y = _avg_pool3(y * y) - mu_y ** 2
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2)
    return _nhwc(fp.clip((1 - num / den) / 2, 0.0, 1.0))


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.85 SSIM + 0.15 L1, mean over channels -> (N, H, W)."""
    l1 = torch.mean(torch.abs(pred - target), dim=-1)
    s = torch.mean(ssim(pred, target), dim=-1)
    return 0.85 * s + 0.15 * l1


def smoothness_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness on mean-normalised disparity
    (upstream ``get_smooth_loss``). disp (N, h, w, 1), img (N, h, w, 3)."""
    mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
    norm_disp = disp / (mean_disp + 1e-7)
    dx = torch.abs(norm_disp[:, :, 1:, :] - norm_disp[:, :, :-1, :])
    dy = torch.abs(norm_disp[:, 1:, :, :] - norm_disp[:, :-1, :, :])
    ix = torch.mean(torch.abs(img[:, :, 1:, :] - img[:, :, :-1, :]), dim=-1, keepdim=True)
    iy = torch.mean(torch.abs(img[:, 1:, :, :] - img[:, :-1, :, :]), dim=-1, keepdim=True)
    dx = dx * torch.exp(-ix)
    dy = dy * torch.exp(-iy)
    return torch.mean(dx) + torch.mean(dy)


# --------------------------------------------------------------------- model

class MonodepthModel(nn.Module):
    """Depth encoder/decoder + pose net, the reference's model set. Its
    methods take and return NHWC; ``train`` picks the batch norms'
    statistics per call, as in flax."""

    def __init__(self, depth_layers: int = 18, pose_layers: int = 18,
                 scales: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.encoder = ResNetEncoder(depth=depth_layers)
        self.decoder = DepthDecoder(self.encoder.num_ch_enc, scales=tuple(scales))
        self.pose_net = PoseNet(depth=pose_layers)

    def depth(self, img, train: bool = False) -> dict:
        """RGB (N, H, W, 3) in [0, 1] -> {scale: disparity (N, h, w, 1)}."""
        disps = self.decoder(self.encoder(_nchw(img), train=train))
        return {k: _nhwc(v) for k, v in disps.items()}

    def pose(self, img_a, img_b, train: bool = False):
        return self.pose_net(_nchw(img_a), _nchw(img_b), train=train)

    def forward(self, target, sources, train: bool = False):
        """target (N, H, W, 3), sources a list of (N, H, W, 3) -> (disps,
        poses) with poses[i] = (axisangle, translation)."""
        disps = self.depth(target, train=train)
        poses = [self.pose(target, s, train=train) for s in sources]
        return disps, poses

    def forward_train(self, target, prev, nxt, with_pose: bool = True):
        """Training forward, batch statistics throughout. Pose pairs follow
        the reference's temporal order: [prev, target] and [target, next]."""
        disps = self.depth(target, train=True)
        if not with_pose:
            return disps, None, None
        pose_prev = self.pose(prev, target, train=True)
        pose_next = self.pose(target, nxt, train=True)
        return disps, pose_prev, pose_next


# --------------------------------------------------------------------- loss

@dataclass(frozen=True)
class MonodepthLossConfig:
    scales: tuple = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 100.0
    smoothness_weight: float = 1e-3  # --disparity_smoothness default
    automask: bool = True            # not --disable_automasking
    fx: float = 0.9375 * 640         # InteriorNet-normalised K of the
    fy: float = 1.25 * 480           # reference
    cx: float = 0.5 * 640
    cy: float = 0.5 * 480


def monodepth_loss(
    disps: dict,
    frame_Ts: Sequence[torch.Tensor],  # cam_T_cam (N, 4, 4) target -> source
    target: torch.Tensor,              # (N, H, W, 3)
    sources: Sequence[torch.Tensor],   # list of (N, H, W, 3)
    cfg: MonodepthLossConfig,
    identity_noise: torch.Tensor | None = None,
):
    """Multi-scale photometric + smoothness loss -> (total, aux).

    ``identity_noise`` (len(sources), N, H, W) is the reference's
    randn * 1e-5 automask tiebreak; None adds a constant 1e-5."""
    N, H, W, _ = target.shape
    total = 0.0
    aux = {}
    sources_q = [quad_pack(src) for src in sources]
    ident = None
    if cfg.automask:
        # the identity reprojection is full resolution at every scale
        ident = torch.stack([reprojection_loss(src, target) for src in sources], dim=0)
        ident = ident + (identity_noise if identity_noise is not None else 1e-5)
    for scale in cfg.scales:
        disp = disps[scale]
        disp_full = resize_bilinear(disp, H, W)
        _, depth = disp_to_depth(disp_full[..., 0], cfg.min_depth, cfg.max_depth)

        reproj = torch.stack([
            reprojection_loss(warp_frame_quad(src_q, depth, T, cfg.fx, cfg.fy, cfg.cx, cfg.cy),
                              target)
            for src_q, T in zip(sources_q, frame_Ts)], dim=0)  # (S, N, H, W)
        combined = torch.cat([ident, reproj], dim=0) if cfg.automask else reproj
        # amin splits the gradient among equal minima, as jnp.min does
        photo = torch.mean(torch.amin(combined, dim=0))

        smooth = smoothness_loss(disp, resize_bilinear(target, disp.shape[1], disp.shape[2]))
        scale_loss = photo + cfg.smoothness_weight * smooth / (2 ** scale)
        total = total + scale_loss
        aux[f"loss/scale_{scale}"] = scale_loss
        if scale == 0:
            aux["loss/photometric"] = photo
            aux["loss/smooth"] = smooth
    total = total / len(cfg.scales)
    aux["loss/total"] = total
    return total, aux
