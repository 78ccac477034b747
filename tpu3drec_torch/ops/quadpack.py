"""Quad-packed bilinear sampling (port of `tpu3drec/ops/quadpack.py`).

On the TPU, packing a pixel's 2x2 neighbourhood onto the trailing axis
turned a bilinear sample into one gather row instead of four. That is a
layout trick for the TPU's gather unit, not a kernel; the port keeps its
semantics (border-clamped bilinear, equal to
``grid_sample(padding_mode="border")`` in absolute pixel coordinates) with
plain tensor indexing. `gather_corners` returns the same four values as
``quad_gather(quad_pack(img), y0, x0)`` without building the 4x larger
packed image; the SfM front end samples descriptor patches through it.
"""

from __future__ import annotations

import torch

from tpu3drec_torch.core import fp


def quad_pack(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H, W, 4C): channels [v(y,x), v(y,x+1),
    v(y+1,x), v(y+1,x+1)], edge-clamped (x+1 -> min(x+1, W-1), same for y)."""
    xp = torch.cat([img[..., :, 1:, :], img[..., :, -1:, :]], dim=-2)
    yp = torch.cat([img[..., 1:, :, :], img[..., -1:, :, :]], dim=-3)
    xyp = torch.cat([xp[..., 1:, :, :], xp[..., -1:, :, :]], dim=-3)
    return torch.cat([img, xp, yp, xyp], dim=-1)


def quad_gather(qimg: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor):
    """The four bilinear corners from a quad-packed (H, W, 4C) image at
    integer y0 in [0, H-1], x0 in [0, W-1] (any shape): (v00, v01, v10, v11),
    each y0.shape + (C,)."""
    H, W, C4 = qimg.shape
    C = C4 // 4
    v = qimg.reshape(H * W, C4)[(y0 * W + x0).long().reshape(-1)].reshape(y0.shape + (C4,))
    return v[..., :C], v[..., C:2 * C], v[..., 2 * C:3 * C], v[..., 3 * C:]


def gather_corners(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor):
    """`quad_gather(quad_pack(img), y0, x0)` by four point gathers from the
    unpacked (H, W, C) image, with the same edge clamping."""
    H, W, C = img.shape
    flat = img.reshape(H * W, C)
    y0, x0 = y0.long(), x0.long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)

    def at(y, x):
        return flat[(y * W + x).reshape(-1)].reshape(y0.shape + (C,))

    return at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)


def bilinear_sample_quad(qimg: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with border clamping from a quad-packed (H, W, 4C)
    image at absolute pixel coordinates x, y (any shape) -> x.shape + (C,)."""
    H, W, _ = qimg.shape
    x = fp.clip(x, 0.0, W - 1.0)  # jnp.clip's derivative at the border
    y = fp.clip(y, 0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    v00, v01, v10, v11 = quad_gather(qimg, y0.long(), x0.long())
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)
