"""Two-view relative geometry: essential matrix and pose recovery (port of
`tpu3drec/sfm/twoview.py`).

Batched LO-RANSAC: every hypothesis is drawn, solved (batched 8-point
SVDs) and scored (Sampson error against every correspondence) at once,
then the ``num_lo`` best are decomposed, cheirality-resolved and polished
by Gauss-Newton on the Sampson error. Where the JAX package vmapped
``estimate_relative_pose`` over image pairs, the port takes a leading pair
dimension: uv1, uv2 (P, N, 2) and valid (P, N) (a single pair works too).

Randomness: the (S, 8) minimal samples come from a ``torch.Generator``
(`sampling.draw_samples`), or are given through ``samples=`` — the tests
pass the indices the JAX package drew, and the rest agrees to float32
rounding. E is defined up to sign, and LAPACK and cuSOLVER may pick either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from tpu3drec_torch.core import fp
from tpu3drec_torch.core.se3 import axis_angle_to_matrix
from tpu3drec_torch.sfm.sampling import draw_samples, seeded_generator
from tpu3drec_torch.sfm.triangulate import projection_matrix, triangulate_two_view
from tpu3drec_torch.utils.device import FORWARD_AD_LOCK


def normalize_points(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalised camera coordinates (K^-1 applied)."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)


def eight_point(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point essential matrix from normalised correspondences
    (..., N, 2) with weights (..., N); (s, s, 0) singular values enforced.
    The null vector of the (N x 9) system needs the full V (N = 8 < 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    A = A * w[..., None]
    Vt = torch.linalg.svd(A, full_matrices=True).Vh
    E = Vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    U, S, Vt2 = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    D = torch.diag_embed(torch.stack([s, s, torch.zeros_like(s)], dim=-1))
    return U @ D @ Vt2


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) epipolar error (..., N), E (..., 3, 3)
    broadcast against x1, x2 (..., N, 2)."""
    h1, h2 = _homog(x1), _homog(x2)
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    num = torch.sum(h2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1],
                        v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], dim=-1).reshape(v.shape[:-1] + (3, 3))


def _signed_sampson(E, h1, h2):
    """Signed first-order geometric residual per correspondence (..., N)."""
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    num = torch.sum(h2 * Ex1, dim=-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.sqrt(torch.clamp(den, min=1e-18))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def _rt_residuals(params, R0, t0, B, sw, h1, h2):
    """One pose's weighted signed Sampson residuals at the 5-DoF update
    ``params`` (axis-angle, tangent translation)."""
    Rn = axis_angle_to_matrix(params[:3]) @ R0
    tn = _unit(t0 + B @ params[3:])
    return sw * _signed_sampson(_skew(tn) @ Rn, h1, h2)


def refine_relative_pose(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                         w: torch.Tensor, iters: int = 10, robust_sigma=0.0):
    """Manifold Gauss-Newton on the 5-DoF relative pose minimising the
    weighted Sampson error, batched: R (B, 3, 3), t (B, 3), x1, x2 (B, N, 2),
    w (B, N). Rotation updates are left-applied axis-angle; translation moves
    in its tangent plane and is renormalised. ``robust_sigma`` > 0 makes
    each step IRLS with Cauchy weights at the current pose. A step is kept
    only if it lowers the fixed-weight cost."""
    h1, h2 = _homog(x1), _homog(x2)
    res_b = vmap(_rt_residuals)
    jac_b = vmap(jacfwd(_rt_residuals))
    sigma = torch.as_tensor(robust_sigma, dtype=x1.dtype, device=x1.device)
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    eye5 = torch.eye(5, dtype=x1.dtype, device=x1.device)
    for _ in range(iters):
        a = torch.where((torch.abs(t[:, 0]) < 0.9)[:, None], e1, e2)
        b1 = _unit(torch.linalg.cross(t, a))
        b2 = torch.linalg.cross(t, b1)
        B = torch.stack([b1, b2], dim=-1)                                   # (B, 3, 2)
        ru = _signed_sampson(_skew(t) @ R, h1, h2)
        cauchy = w / (1.0 + (ru / torch.clamp(sigma, min=1e-12)) ** 2)
        sw = torch.sqrt(torch.where(sigma > 0.0, cauchy, w))
        z = torch.zeros(R.shape[0], 5, dtype=x1.dtype, device=x1.device)
        r = res_b(z, R, t, B, sw, h1, h2)                                   # (B, N)
        with FORWARD_AD_LOCK:
            J = jac_b(z, R, t, B, sw, h1, h2)                               # (B, N, 5)
        JtJ = J.transpose(1, 2) @ J
        Jtr = (J.transpose(1, 2) @ r[..., None])[..., 0]
        delta = torch.linalg.solve(JtJ + 1e-8 * eye5, -Jtr)
        Rn = axis_angle_to_matrix(delta[:, :3]) @ R
        tn = _unit(t + (B @ delta[:, 3:, None])[..., 0])
        r_new = res_b(z, Rn, tn, B, sw, h1, h2)
        better = torch.sum(r_new ** 2, -1) < torch.sum(r ** 2, -1)
        R = torch.where(better[:, None, None], Rn, R)
        t = torch.where(better[:, None], tn, t)
    return R, t


class TwoViewResult(NamedTuple):
    E: torch.Tensor         # (..., 3, 3)
    R: torch.Tensor         # (..., 3, 3) world(cam1) -> cam2
    t: torch.Tensor         # (..., 3) unit norm
    inliers: torch.Tensor   # (..., N) bool
    n_inliers: torch.Tensor  # (...,) int32


def decompose_essential(E: torch.Tensor):
    """E (..., 3, 3) -> 4 candidates (R1,+t), (R1,-t), (R2,+t), (R2,-t):
    Rs (..., 4, 3, 3), ts (..., 4, 3)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def _pose_from_E(E, x1, x2, inliers, probe: int):
    """Decompose E (B, 3, 3) and resolve the 4-fold ambiguity by cheirality
    on a probe subset of the lowest-error inliers."""
    err = sampson_error(E, x1, x2)
    key = torch.where(inliers, err, torch.full_like(err, torch.inf))
    probe_idx = torch.argsort(key, dim=-1, stable=True)[:, :probe]            # (B, p)
    Rs, ts = decompose_essential(E)                                           # (B, 4, ...)
    xp1 = torch.gather(x1, 1, probe_idx[..., None].expand(-1, -1, 2))[:, None]
    xp2 = torch.gather(x2, 1, probe_idx[..., None].expand(-1, -1, 2))[:, None]
    ip = torch.gather(inliers, 1, probe_idx)[:, None]
    eye = torch.eye(3, dtype=E.dtype, device=E.device).expand(Rs.shape)
    P1 = projection_matrix(eye, torch.zeros_like(ts))
    P2 = projection_matrix(Rs, ts)
    X = triangulate_two_view(P1, P2, xp1.expand(-1, 4, -1, -1), xp2.expand(-1, 4, -1, -1))
    z1 = X[..., 2]
    z2 = (X @ Rs.transpose(-1, -2) + ts[..., None, :])[..., 2]
    counts = ((z1 > 0) & (z2 > 0) & ip).sum(-1)                               # (B, 4)
    k = torch.argmax(counts, dim=-1)
    rows = torch.arange(E.shape[0], device=E.device)
    return Rs[rows, k], ts[rows, k]


def estimate_relative_pose(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                           K: torch.Tensor, generator: torch.Generator | None = None, *,
                           samples: torch.Tensor | None = None, num_hypotheses: int = 2048,
                           inlier_px: float = 1.5, probe: int = 64,
                           num_lo: int = 4) -> TwoViewResult:
    """Batched LO-RANSAC essential matrix + cheirality-resolved pose for
    pixel matches uv1, uv2 ((P,) N, 2) with validity ((P,) N). MSAC-scored
    (truncated quadratic); the ``num_lo`` best hypotheses are decomposed,
    polished on their own inlier sets with Cauchy-weighted Gauss-Newton,
    re-gated, and the lowest MSAC score wins. The returned t has unit norm.
    ``samples`` ((P,) S, 8) replaces the draw from ``generator``."""
    single = uv1.ndim == 2
    if single:
        uv1, uv2, valid = uv1[None], uv2[None], valid[None]
        samples = None if samples is None else samples[None]
    valid = valid.bool()
    P = uv1.shape[0]
    rows = torch.arange(P, device=uv1.device)
    with fp.ieee_fp32():
        x1 = normalize_points(uv1, K)
        x2 = normalize_points(uv2, K)
        thresh = (inlier_px / K[0, 0]) ** 2  # Sampson in normalised coordinates
        if samples is None:
            gen = generator if generator is not None else seeded_generator(uv1.device, 0)
            samples = draw_samples(valid, num_hypotheses, 8, gen)
        samples = samples.to(device=uv1.device, dtype=torch.int64)
        S = samples.shape[1]
        flat = samples.reshape(P, -1, 1).expand(-1, -1, 2)
        x1s = torch.gather(x1, 1, flat).reshape(P, S, 8, 2)
        x2s = torch.gather(x2, 1, flat).reshape(P, S, 8, 2)
        Es = eight_point(x1s, x2s, torch.ones(x1s.shape[:-1], dtype=x1.dtype, device=x1.device))
        errs = sampson_error(Es, x1[:, None], x2[:, None])                      # (P, S, N)
        msac = torch.sum(torch.where(valid[:, None, :], torch.clamp(errs, max=thresh),
                                     torch.zeros_like(errs)), dim=-1)
        top = torch.sort(-msac, dim=-1, descending=True, stable=True).indices[:, :num_lo]
        sigma = (inlier_px / K[0, 0]) * 0.5  # Cauchy scale: half the gate

        # the num_lo candidates of every pair, flattened to one batch
        E0 = Es[rows[:, None], top].reshape(-1, 3, 3)
        rep = lambda x: x.repeat_interleave(num_lo, dim=0)  # noqa: E731
        cx1, cx2, cvalid = rep(x1), rep(x2), rep(valid)
        inl0 = (sampson_error(E0, cx1, cx2) < thresh) & cvalid
        R, t = _pose_from_E(E0, cx1, cx2, inl0, probe)
        inl = inl0
        for _ in range(2):
            R, t = refine_relative_pose(R, t, cx1, cx2, inl.to(x1.dtype), robust_sigma=sigma)
            inl = (sampson_error(_skew(t) @ R, cx1, cx2) < thresh) & cvalid
        err = sampson_error(_skew(t) @ R, cx1, cx2)
        score = torch.sum(torch.where(cvalid, torch.clamp(err, max=thresh),
                                      torch.zeros_like(err)), dim=-1).reshape(P, num_lo)
        best = rows * num_lo + torch.argmin(score, dim=-1)
        R_r, t_r, inliers = R[best], t[best], inl[best]
        out = TwoViewResult(E=_skew(t_r) @ R_r, R=R_r, t=t_r, inliers=inliers,
                            n_inliers=inliers.sum(-1).to(torch.int32))
    if single:
        return TwoViewResult(*(x[0] for x in out))
    return out
