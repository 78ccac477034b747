"""Perspective-n-Point registration with batched RANSAC (port of
`tpu3drec/sfm/pnp.py`).

Per minimal 6-point sample, two hypothesis families (general-position DLT
and the planar homography decomposition), all solved in one batch of SVDs,
scored by reprojection; then two rounds of Gauss-Newton polish on the
inliers, kept only if they do not lose consensus. The (S, 6) samples come
from a ``torch.Generator`` or through ``samples=``, as in `twoview.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from tpu3drec_torch.core import fp
from tpu3drec_torch.core.se3 import axis_angle_to_matrix, matrix_to_axis_angle
from tpu3drec_torch.sfm.sampling import draw_samples, seeded_generator
from tpu3drec_torch.sfm.triangulate import reprojection_errors
from tpu3drec_torch.utils.device import FORWARD_AD_LOCK


def _diag_det(U: torch.Tensor, Vt: torch.Tensor) -> torch.Tensor:
    d = torch.linalg.det(U @ Vt)
    one = torch.ones_like(d)
    return torch.diag_embed(torch.stack([one, one, d], dim=-1))


def _dlt_pose(X: torch.Tensor, xn: torch.Tensor, w: torch.Tensor):
    """Weighted DLT for P = [R|t] from world points X (..., N, 3) and
    normalised image coordinates xn (..., N, 2); R orthogonalised."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)
    Vt = torch.linalg.svd(A, full_matrices=False).Vh
    P = Vt[..., -1, :].reshape(X.shape[:-2] + (3, 4))
    # sign so that points land in front (positive depth at the weighted mean)
    Xm = torch.einsum("...n,...ni->...i", w, X) / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    sign = torch.sign(torch.sum(P[..., 2, :3] * Xm, dim=-1) + P[..., 2, 3])
    P = P * torch.where(sign == 0, torch.ones_like(sign), sign)[..., None, None]
    M = P[..., :3]
    U, S, Vt2 = torch.linalg.svd(M)
    R = U @ _diag_det(U, Vt2) @ Vt2
    scale = torch.mean(S, dim=-1)
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    return R, t


def _planar_pose(X: torch.Tensor, xn: torch.Tensor, w: torch.Tensor):
    """Pose hypothesis for (nearly) coplanar world points: fit the plane,
    estimate the plane->image homography and decompose it into [R|t]
    (the DLT is rank-deficient on a coplanar sample)."""
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    Xm = torch.einsum("...n,...ni->...i", wn, X)
    Xc = X - Xm[..., None, :]
    C = (Xc * w[..., None]).transpose(-1, -2) @ Xc
    VtC = torch.linalg.svd(C).Vh
    e1, e2 = VtC[..., 0, :], VtC[..., 1, :]
    p = torch.stack([torch.sum(Xc * e1[..., None, :], -1), torch.sum(Xc * e2[..., None, :], -1)],
                    dim=-1)
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    zeros = torch.zeros_like(ph)
    rows_u = torch.cat([ph, zeros, -xn[..., 0:1] * ph], dim=-1)
    rows_v = torch.cat([zeros, ph, -xn[..., 1:2] * ph], dim=-1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)
    Vt9 = torch.linalg.svd(A, full_matrices=False).Vh
    H = Vt9[..., -1, :].reshape(X.shape[:-2] + (3, 3))
    s = torch.sqrt(torch.linalg.vector_norm(H[..., :, 0], dim=-1)
                   * torch.linalg.vector_norm(H[..., :, 1], dim=-1))
    H = H / torch.clamp(s, min=1e-12)[..., None, None]
    H = H * torch.where(H[..., 2, 2] < 0, -1.0, 1.0)[..., None, None]
    a1, a2, a3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    M = torch.stack([a1, a2, torch.linalg.cross(a1, a2)], dim=-1)
    U, _, Vt3 = torch.linalg.svd(M)
    Rp = U @ _diag_det(U, Vt3) @ Vt3                        # plane -> camera
    E = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)
    R = Rp @ E.transpose(-1, -2)
    t = a3 - (R @ Xm[..., None])[..., 0]
    return R, t


def _gn_refine(R0, t0, X, xn, w, iters: int = 10):
    """Gauss-Newton on (axis-angle, t) minimising the weighted normalised
    reprojection error, a fixed number of steps."""
    def residual(params):
        R = axis_angle_to_matrix(params[:3])
        Xc = X @ R.T + params[3:]
        z = torch.where(torch.abs(Xc[:, 2]) < 1e-9, torch.full_like(Xc[:, 2], 1e-9), Xc[:, 2])
        proj = Xc[:, :2] / z[:, None]
        return ((proj - xn) * w[:, None]).reshape(-1)

    params = torch.cat([matrix_to_axis_angle(R0), t0])
    eye = torch.eye(6, dtype=params.dtype, device=params.device)
    jac = jacfwd(residual)
    for _ in range(iters):
        r = residual(params)
        with FORWARD_AD_LOCK:
            J = jac(params)
        params = params - torch.linalg.solve(J.T @ J + 1e-8 * eye, J.T @ r)
    return axis_angle_to_matrix(params[:3]), params[3:]


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def pnp_ransac(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
               generator: torch.Generator | None = None, *, samples: torch.Tensor | None = None,
               num_hypotheses: int = 2048, inlier_px: float = 3.0,
               gn_iters: int = 10) -> PnPResult:
    """World->camera pose from 2D-3D correspondences X (N, 3), uv (N, 2),
    valid (N,). ``samples`` (S, 6) replaces the draw from ``generator``."""
    valid = valid.bool()
    with fp.ieee_fp32():
        xn = torch.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], dim=-1)
        if samples is None:
            gen = generator if generator is not None else seeded_generator(X.device, 0)
            samples = draw_samples(valid, num_hypotheses, 6, gen)
        samples = samples.to(device=X.device, dtype=torch.int64)
        Xs, xns = X[samples], xn[samples]
        ones = torch.ones(samples.shape, dtype=X.dtype, device=X.device)
        Rd, td = _dlt_pose(Xs, xns, ones)
        Rp, tp = _planar_pose(Xs, xns, ones)
        Rs = torch.stack([Rd, Rp], dim=1).reshape(-1, 3, 3)
        ts = torch.stack([td, tp], dim=1).reshape(-1, 3)
        errs = reprojection_errors(X, Rs, ts, K, uv)                       # (2S, N)
        inl = (errs < inlier_px) & valid
        best = torch.argmax(inl.sum(1))
        n_raw = inl[best].sum()
        R_raw, t_raw = Rs[best], ts[best]
        # local optimisation: two rounds of GN polish + re-score, kept only
        # if it does not lose consensus against the raw best hypothesis
        w = inl[best].to(X.dtype)
        R, t = R_raw, t_raw
        for _ in range(2):
            R, t = _gn_refine(R, t, X, xn, w, iters=gn_iters)
            w = ((reprojection_errors(X, R, t, K, uv) < inlier_px) & valid).to(X.dtype)
        use_lo = w.sum() >= n_raw
        R = torch.where(use_lo, R, R_raw)
        t = torch.where(use_lo, t, t_raw)
        inliers = (reprojection_errors(X, R, t, K, uv) < inlier_px) & valid
    return PnPResult(R=R, t=t, inliers=inliers, n_inliers=inliers.sum().to(torch.int32))
