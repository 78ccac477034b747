"""Batched triangulation (DLT), two-view and multi-view (port of
`tpu3drec/sfm/triangulate.py`). The tensor functions take leading batch
dimensions where the JAX package vmapped; the ``_np`` functions are the
host-numpy glue of incremental SfM, kept as the port's own copy.
"""

from __future__ import annotations

import numpy as np
import torch


def projection_matrix(R: torch.Tensor, t: torch.Tensor, K: torch.Tensor | None = None):
    """World->camera (R (..., 3, 3), t (..., 3)) -> (..., 3, 4) projection,
    K [R|t] if K is given."""
    P = torch.cat([R, t[..., None]], dim=-1)
    if K is not None:
        P = K @ P
    return P


def triangulate_two_view(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                         x2: torch.Tensor) -> torch.Tensor:
    """DLT: projections (..., 3, 4) and pixel coords (..., N, 2) -> (..., N, 3).
    Rows [x p3 - p1; y p3 - p2] from both views; the null vector of each
    4x4 system by SVD."""
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    A = torch.stack([
        x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)                                   # (..., N, 4, 4)
    X = torch.linalg.svd(A).Vh[..., -1, :]
    return X[..., :3] / X[..., 3:4]


def triangulate_two_view_np(P1, P2, x1, x2):
    """Host-numpy DLT, the same math as `triangulate_two_view`, for the
    incremental-SfM glue, whose groups differ in size every call."""
    P1 = np.asarray(P1)
    P2 = np.asarray(P2)
    x1 = np.asarray(x1)
    x2 = np.asarray(x2)
    A = np.stack([
        x1[:, 0:1] * P1[2] - P1[0],
        x1[:, 1:2] * P1[2] - P1[1],
        x2[:, 0:1] * P2[2] - P2[0],
        x2[:, 1:2] * P2[2] - P2[1],
    ], axis=1)
    _, _, Vt = np.linalg.svd(A)
    X = Vt[:, -1]
    return X[:, :3] / X[:, 3:4]


def reprojection_errors_np(X, R, t, K, uv):
    """Host-numpy twin of `reprojection_errors`."""
    X = np.asarray(X)
    uv = np.asarray(uv)
    Xc = X @ np.asarray(R).T + np.asarray(t)
    z = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
    u = Xc[:, 0] / z * K[0, 0] + K[0, 2]
    v = Xc[:, 1] / z * K[1, 1] + K[1, 2]
    return np.sqrt((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2)


def triangulate_multiview(Ps: torch.Tensor, uvs: torch.Tensor, mask: torch.Tensor):
    """One landmark per leading index from V masked observation slots
    (Ps (..., V, 3, 4), uvs (..., V, 2), mask (..., V)): the smallest
    eigenvector of the accumulated DLT normal matrix."""
    rows_x = uvs[..., 0:1] * Ps[..., 2, :] - Ps[..., 0, :]
    rows_y = uvs[..., 1:2] * Ps[..., 2, :] - Ps[..., 1, :]
    w = mask.to(Ps.dtype)[..., None]
    A = torch.cat([rows_x * w, rows_y * w], dim=-2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = vecs[..., :, 0]
    d = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)


def reprojection_errors(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor,
                        uv: torch.Tensor) -> torch.Tensor:
    """Pixel reprojection error magnitude (..., N): X (..., N, 3) through
    (R (..., 3, 3), t (..., 3)) against uv (..., N, 2)."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-9, torch.full_like(Xc[..., 2], 1e-9), Xc[..., 2])
    u = Xc[..., 0] / z * K[0, 0] + K[0, 2]
    v = Xc[..., 1] / z * K[1, 1] + K[1, 2]
    return torch.sqrt((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2)
