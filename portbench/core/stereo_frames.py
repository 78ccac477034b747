"""SceneFlow-like rectified stereo pairs with dense ground-truth disparity,
made on the device from a seed.

The right image is a multi-scale random texture (coarse, mid and fine
noise, bilinearly upsampled) cut from a wider canvas. The left view's
disparity is a slanted background plane of 5-60 px under 6-10 slanted
elliptical foreground blobs of 40-230 px at their centres, the nearest
(largest disparity) in front; the left image samples the canvas at
x - d(x), linearly between columns, so each left pixel shows what the
right view shows at its match. Disparities at or over the net's 192 are
kept: the published loss masks them out. ``scale`` multiplies every
disparity (a net of a smaller max disparity, at a smaller size, sees the
same scene).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MARGIN = 256  # canvas columns left of the right image: room for x - d at d <= 255
MAX_DISP = 192  # the published net's, for which the law is written
BLOBS = 10


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def texture(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 3, h, w) float32 in (0, 1)."""
    out = torch.zeros((n, 3, h, w), device=device)
    for cell, weight in ((32, 1.0), (8, 0.5), (2, 0.3)):
        low = torch.randn((n, 3, h // cell + 2, w // cell + 2), generator=gen, device=device)
        out += weight * F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return torch.sigmoid(1.5 * out)


def disparity(gen: torch.Generator, n: int, h: int, w: int, device,
              scale: float = 1.0) -> torch.Tensor:
    """(n, h, w) float32 left disparity in px."""
    y = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h - 0.5
    x = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w - 0.5
    u = lambda lo, hi, *s: _uniform(gen, (n,) + s, lo, hi, device)  # noqa: E731
    bg = (u(15, 50)[:, None, None] + u(-20, 20)[:, None, None] * x
          + u(-20, 20)[:, None, None] * y).clamp(5, 60)
    cx, cy = u(-0.5, 0.5, BLOBS), u(-0.5, 0.5, BLOBS)
    rx, ry = u(0.04, 0.2, BLOBS), u(0.05, 0.3, BLOBS)  # of the width, of the height
    theta = u(0, math.pi, BLOBS)
    centre = u(40, 230, BLOBS)
    gx, gy = u(-40, 40, BLOBS), u(-40, 40, BLOBS)  # px across the whole image
    count = torch.randint(6, BLOBS + 1, (n, 1), generator=gen, device=device)
    active = torch.arange(BLOBS, device=device)[None] < count
    e = lambda t: t[:, :, None, None]  # noqa: E731
    dx, dy = x[None, None] - e(cx), y[None, None] - e(cy)
    c, s = torch.cos(e(theta)), torch.sin(e(theta))
    a, b = (c * dx + s * dy) / e(rx), (-s * dx + c * dy) / e(ry)
    inside = (a * a + b * b <= 1.0) & e(active)
    blob = e(centre) + e(gx) * dx + e(gy) * dy
    fg = torch.where(inside, blob, torch.zeros_like(blob)).amax(dim=1)
    return (scale * torch.maximum(bg, fg)).clamp(max=MARGIN - 1)


def pairs(gen: torch.Generator, n: int, h: int, w: int, device, scale: float = 1.0) -> dict:
    """``n`` pairs as the stereo train step takes them: "left", "right"
    (n, h, w, 3) in [0, 1], "disp" (n, h, w) px, "mask" (n, h, w) ones."""
    canvas = texture(gen, n, h, w + MARGIN, device)
    right = canvas[..., MARGIN:]
    disp = disparity(gen, n, h, w, device, scale)
    src = MARGIN + torch.arange(w, device=device, dtype=torch.float32) - disp  # (n, h, w)
    i0 = src.floor().clamp(0, w + MARGIN - 2)
    frac = (src - i0)[:, None]
    i0 = i0.long()[:, None].expand(n, 3, h, w)
    left = canvas.gather(3, i0) * (1 - frac) + canvas.gather(3, i0 + 1) * frac
    return {"left": left.permute(0, 2, 3, 1).contiguous(),
            "right": right.permute(0, 2, 3, 1).contiguous(),
            "disp": disp, "mask": torch.ones_like(disp)}
