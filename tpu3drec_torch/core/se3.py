"""SE(3) rigid transforms on torch tensors (port of `tpu3drec/core/se3.py`).

One representation: rotation ``R`` (..., 3, 3) plus translation ``t``
(..., 3). Covers the COLMAP pose-file convention (world->camera,
``p_c = R p_w + t``, whose inverse is ``p_w = R^{-1}(p_c - t)``), the
homogeneous 4x4 ``T`` of the ICP scale-correction step, and axis-angle
<-> matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3drec_torch.core.quaternion import quat_xyzw_to_matrix
from tpu3drec_torch.utils.device import resolve_device


class SE3(NamedTuple):
    """Rigid transform: x -> R @ x + t. Fields broadcast over batch dims."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        dev = resolve_device(device)
        R = torch.eye(3, dtype=dtype, device=dev).expand(tuple(batch_shape) + (3, 3))
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=dev)
        return SE3(R, t)

    @staticmethod
    def from_matrix(T: torch.Tensor) -> "SE3":
        """From homogeneous (..., 4, 4)."""
        return SE3(T[..., :3, :3], T[..., :3, 3])


def se3_from_rt(R: torch.Tensor, t: torch.Tensor) -> SE3:
    return SE3(R, t)


def se3_matrix(T: SE3) -> torch.Tensor:
    """SE3 -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(T.R.shape[:-2], T.t.shape[:-1])
    R = T.R.expand(batch + (3, 3))
    t = T.t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: SE3) -> SE3:
    """(R, t)^-1 = (R^T, -R^T t)."""
    Rt = T.R.transpose(-1, -2)
    return SE3(Rt, -torch.einsum("...ij,...j->...i", Rt, T.t))


def se3_compose(A: SE3, B: SE3) -> SE3:
    """A then-applied-after B: (A o B)(x) = A(B(x))."""
    return SE3(
        torch.einsum("...ij,...jk->...ik", A.R, B.R),
        torch.einsum("...ij,...j->...i", A.R, B.t) + A.t,
    )


def se3_apply(T: SE3, pts: torch.Tensor) -> torch.Tensor:
    """Apply to points (..., N, 3) or (..., 3)."""
    if pts.shape[-1] != 3:
        raise ValueError(f"points must have last dim 3, got {tuple(pts.shape)}")
    if pts.ndim >= 2 and T.R.ndim == pts.ndim + 1:
        return torch.einsum("...ij,...nj->...ni", T.R, pts) + T.t[..., None, :]
    return torch.einsum("...ij,...j->...i", T.R, pts) + T.t


def axis_angle_to_matrix(axisangle: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3),
    Taylor-safe near theta = 0."""
    theta2 = torch.sum(axisangle * axisangle, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + eps * eps)
    k = axisangle / theta
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack(
        [zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], dim=-1
    ).reshape(axisangle.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=axisangle.dtype, device=axisangle.device)
    return eye + s * K + (1.0 - c) * torch.einsum("...ij,...jk->...ik", K, K)


def matrix_to_axis_angle(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrix -> axis-angle (..., 3), theta in [0, pi]. ``arccos``
    is evaluated strictly inside (-1, 1) so gradients stay finite."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)[..., None]
    axis = w / torch.clamp(2.0 * sin_theta, min=eps)
    small = torch.abs(sin_theta) < 1e-6
    return torch.where(small, w * 0.5, axis * theta[..., None])


def colmap_world_to_cam(q_xyzw: torch.Tensor, t: torch.Tensor) -> SE3:
    """World->camera SE3 from a COLMAP pose row (xyzw quat + t)."""
    return SE3(quat_xyzw_to_matrix(q_xyzw), t)


def colmap_cam_to_world(q_xyzw: torch.Tensor, t: torch.Tensor) -> SE3:
    """Camera->world transform from a COLMAP pose row: ``p_w = R^{-1}(p_c - t)``."""
    return se3_inverse(colmap_world_to_cam(q_xyzw, t))
