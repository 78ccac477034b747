"""Pinhole camera model (port of `tpu3drec/core/camera.py`).

The reference's hard-coded intrinsics are fx=600.391 fy=600.079 cx=320
cy=240 for 640x480 frames.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3drec_torch.utils.device import resolve_device


class PinholeCamera(NamedTuple):
    """Intrinsics as float32 tensors (may carry leading batch dims)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, width, height, device=None) -> "PinholeCamera":
        dev = resolve_device(device)
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return PinholeCamera(f32(fx), f32(fy), f32(cx), f32(cy), int(width), int(height))

    @staticmethod
    def reference_default(width: int = 640, height: int = 480, device=None) -> "PinholeCamera":
        """The constants baked into the reference transform scripts."""
        return PinholeCamera.create(600.391, 600.079, 320.0, 240.0, width, height,
                                    device=device)

    @staticmethod
    def from_normalized(K_norm, width: int, height: int, device=None) -> "PinholeCamera":
        """From a normalized intrinsics matrix (fx/W, fy/H, cx/W, cy/H layout)."""
        K = torch.as_tensor(K_norm, dtype=torch.float32, device=resolve_device(device))
        return PinholeCamera.create(
            K[0, 0] * width, K[1, 1] * height, K[0, 2] * width, K[1, 2] * height,
            width, height, device=K.device,
        )

    def K(self) -> torch.Tensor:
        """3x3 intrinsics matrix (batched if fields are batched)."""
        fx = self.fx
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        rows = torch.stack(
            [fx, z, self.cx.expand(fx.shape),
             z, self.fy.expand(fx.shape), self.cy.expand(fx.shape),
             z, z, o],
            dim=-1,
        )
        return rows.reshape(fx.shape + (3, 3))

    def scaled(self, scale: float) -> "PinholeCamera":
        """Camera for an image resized by ``scale``."""
        return PinholeCamera(
            self.fx * scale, self.fy * scale, self.cx * scale, self.cy * scale,
            int(round(self.width * scale)), int(round(self.height * scale)),
        )

    def project(self, pts_cam: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixel coords (..., 2) (u, v)."""
        z = pts_cam[..., 2:3]
        z_safe = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
        u = pts_cam[..., 0:1] / z_safe * self.fx + self.cx
        v = pts_cam[..., 1:2] / z_safe * self.fy + self.cy
        return torch.cat([u, v], dim=-1)

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3):
        ``X=(u-cx)/fx*Z, Y=(v-cy)/fy*Z``."""
        X = (uv[..., 0] - self.cx) / self.fx * depth
        Y = (uv[..., 1] - self.cy) / self.fy * depth
        return torch.stack([X, Y, depth], dim=-1)
