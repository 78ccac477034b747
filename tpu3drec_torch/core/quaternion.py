"""Quaternion algebra on torch tensors (port of `tpu3drec/core/quaternion.py`).

Canonical internal order is **wxyz** (scalar-first); the convention is
explicit in every function name and adapters convert at the IO boundary
(COLMAP pose txt stores xyzw, see `utils/poseio.py`). All functions are
elementwise over leading batch dimensions and differentiable.
"""

from __future__ import annotations

import torch

from tpu3drec_torch.core import fp


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize to unit quaternion along the last axis."""
    return q / torch.clamp(fp.sqrt(fp.sum_squares(q))[..., None], min=eps)


def quat_wxyz_from_xyzw(q: torch.Tensor) -> torch.Tensor:
    """(x,y,z,w) -> (w,x,y,z)."""
    return torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)


def quat_xyzw_from_wxyz(q: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) -> (x,y,z,w)."""
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a wxyz quaternion (inverse for unit quaternions)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of wxyz quaternions (batch-broadcasting)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_wxyz_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit wxyz quaternion -> rotation matrix, shape (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_xyzw_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit xyzw quaternion -> rotation matrix (scipy `from_quat` semantics,
    the convention of the COLMAP pose txt)."""
    return quat_wxyz_to_matrix(quat_wxyz_from_xyzw(q))


def matrix_to_quat_wxyz(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit wxyz quaternion with w >= 0.

    Branch-free Shepperd-style extraction: all four candidate quaternions
    are formed and the best-conditioned one (largest pivot) is selected, so
    there is no catastrophic cancellation near w ~ 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)

    pivots = torch.stack(
        [1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
         1 - m00 + m11 - m22, 1 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
