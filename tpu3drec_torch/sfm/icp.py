"""Iterative Closest Point with similarity (scale) alignment, and rigid
point-to-plane ICP (port of `tpu3drec/sfm/icp.py`).

The reference recovered the metric scale COLMAP cannot with an offline
open3d ICP run that wrote a 4x4 ``T_data.txt``. Here the whole loop stays
on the device: nearest neighbours come from the CUDA kernel
(`ops/csrc/icp_nn.cu`) on the card and from its plain version on the CPU,
the alignment is closed-form Umeyama (with scale), and each iteration
trims correspondences beyond a distance quantile with weights, not
compaction, so shapes stay static. Point-to-plane ICP (`icp_point_to_plane`)
takes the same nearest neighbours, one kernel launch per iteration on the
card, and solves the linearised 6x6 normal equations each iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3drec_torch.core.fp import ieee_fp32
from tpu3drec_torch.ops.icp_nn import nearest_neighbors_cuda, nearest_neighbors_plain
from tpu3drec_torch.utils.device import as_f32, resolve_device


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,3) x (M,3) -> (N,M) squared distances via the matmul identity,
    in full float32 (no TF32: the result feeds an argmin)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T
    ab = torch.matmul(a, b.T)
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def nearest_neighbors(query: torch.Tensor, ref: torch.Tensor, block: int = 2048):
    """For each query point, index (int32) + squared distance of its nearest
    ref point. CUDA tensors go through the kernel, CPU tensors through its
    plain version (``block`` reference points at a time)."""
    if query.device.type == "cuda":
        return nearest_neighbors_cuda(query.contiguous(), ref.contiguous())
    return nearest_neighbors_plain(query, ref, block)


def umeyama(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
            with_scale: bool = True):
    """Weighted similarity alignment: (s, R, t) minimizing
    sum w |s R src + t - dst|^2 (Umeyama 1991)."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    mu_s = torch.einsum("n,ni->i", w, src)
    mu_d = torch.einsum("n,ni->i", w, dst)
    sc = src - mu_s
    dc = dst - mu_d
    cov = torch.einsum("n,ni,nj->ij", w, dc, sc)  # dst x src covariance
    U, S, Vt = torch.linalg.svd(cov)
    # proper-rotation (det=+1) correction on the smallest singular vector
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    corr = torch.diag(torch.cat([torch.ones(2, dtype=cov.dtype, device=cov.device), d[None]]))
    R = U @ corr @ Vt
    if with_scale:
        var_s = torch.einsum("n,ni->", w, sc * sc)
        s = (S[0] + S[1] + S[2] * d) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * R @ mu_s
    return s, R, t


class ICPResult(NamedTuple):
    T: torch.Tensor        # (4,4) similarity transform (sR | t)
    scale: torch.Tensor    # ()
    rmse: torch.Tensor     # () final inlier RMSE
    n_inliers: torch.Tensor


def _icp_core(
    src: torch.Tensor,          # (N,3) moving cloud (padded)
    src_valid: torch.Tensor,    # (N,) bool, padded rows False
    dst: torch.Tensor,          # (M,3) fixed cloud (padded rows far away)
    iters: int = 20,
    with_scale: bool = True,
    inlier_quantile: float = 0.9,
    block: int = 2048,
    init_T: torch.Tensor | None = None,
) -> ICPResult:
    """Trimmed similarity ICP: src -> dst. Correspondences beyond the
    ``inlier_quantile`` distance get weight zero each iteration. Returns the
    4x4 T with scale folded into the rotation block: the ``T_data.txt``
    contract."""
    dtype, dev = src.dtype, src.device
    wv = src_valid.to(dtype)
    n_valid = torch.clamp(torch.sum(wv), min=1.0)
    # dst validity: padded dst rows sit at the 1e9 sentinel
    dv = (torch.abs(dst[:, 0]) < 1e8).to(dtype)
    m_valid = torch.clamp(torch.sum(dv), min=1.0)

    if init_T is None:
        # centroid + RMS-radius pre-alignment: gets translation and gross
        # scale into the NN search's basin of attraction
        mu_s = torch.einsum("n,ni->i", wv, src) / n_valid
        mu_d = torch.einsum("m,mi->i", dv, dst) / m_valid
        if with_scale:
            r_s = torch.sqrt(torch.einsum("n,n->", wv, torch.sum((src - mu_s) ** 2, dim=-1)) / n_valid)
            r_d = torch.sqrt(torch.einsum("m,m->", dv, torch.sum((dst - mu_d) ** 2, dim=-1)) / m_valid)
            s0 = r_d / torch.clamp(r_s, min=1e-12)
        else:
            s0 = torch.ones((), dtype=dtype, device=dev)
        T = torch.eye(4, dtype=dtype, device=dev)
        T[:3, :3] = s0 * torch.eye(3, dtype=dtype, device=dev)
        T[:3, 3] = mu_d - s0 * mu_s
    else:
        T = init_T.to(dtype=dtype, device=dev)

    nan = torch.full_like(wv, float("nan"))
    rmse = n_in = None
    for _ in range(iters):
        cur = src @ T[:3, :3].T + T[:3, 3]
        idx, d2 = nearest_neighbors(cur, dst, block=block)
        # trimmed weights over VALID rows only (padded src rows excluded)
        thresh = torch.nanquantile(torch.where(src_valid, d2, nan), inlier_quantile)
        w = (d2 <= thresh).to(dtype) * wv
        matched = dst[idx.long()]
        s, R, t = umeyama(cur, matched, w, with_scale=with_scale)
        dT = torch.eye(4, dtype=dtype, device=dev)
        dT[:3, :3] = s * R
        dT[:3, 3] = t
        T = dT @ T
        n_in = torch.sum(w)
        rmse = torch.sqrt(torch.sum(w * d2) / torch.clamp(n_in, min=1.0))
    A = T[:3, :3]
    scale = torch.exp(torch.log(torch.clamp(torch.linalg.det(A), min=1e-20)) / 3.0)
    return ICPResult(T=T, scale=scale, rmse=rmse, n_inliers=n_in.to(torch.int32))


def icp(
    src,
    dst,
    iters: int = 20,
    with_scale: bool = True,
    inlier_quantile: float = 0.9,
    block: int = 2048,
    init_T=None,
    bucket: int = 256,
    device=None,
) -> ICPResult:
    """Public entry: pads both clouds to ``bucket`` multiples, as the JAX
    package does (padded src rows carry zero weight, padded dst rows sit at
    the 1e9 sentinel), then runs the core on ``device``."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = resolve_device(device)
    src = as_f32(src, dev)
    dst = as_f32(dst, dev)
    n, m = src.shape[0], dst.shape[0]
    pad_n = (-n) % bucket
    pad_m = (-m) % bucket
    src_p = torch.cat([src, src.new_zeros((pad_n, 3))])
    valid = torch.arange(n + pad_n, device=dev) < n
    dst_p = torch.cat([dst, dst.new_full((pad_m, 3), 1e9)])
    if init_T is not None:
        init_T = as_f32(init_T, dev)
    return _icp_core(
        src_p, valid, dst_p, iters=iters, with_scale=with_scale,
        inlier_quantile=inlier_quantile, block=block, init_T=init_T,
    )


# ---------------------------------------------------------------------------
# Point-to-plane ICP: rigid only (scale stays with the Umeyama path above).
# ---------------------------------------------------------------------------


_EIGH_BATCH = 16_384


def knn_indices(points: torch.Tensor, valid: torch.Tensor | None = None,
                k: int = 16, block: int = 2048) -> torch.Tensor:
    """(N, k) int64 indices of each point's k nearest points (itself
    included), nearest first; rows where ``valid`` is False take part as
    points at the 1e9 sentinel.

    A running best k over reference blocks, as the JAX package's
    ``lax.top_k`` over [best, -d] is. ``top_k`` puts the lower position
    first among equal values, so the earlier neighbour wins a tie;
    ``torch.topk`` promises no order on ties, so the k largest are taken by
    a stable descending sort. The distance matmul runs in full float32."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    far = torch.where(valid[:, None], points, torch.full_like(points, 1e9))
    nblocks = -(-n // block)
    ref = torch.cat([far, far.new_full((nblocks * block - n, 3), 1e9)])
    best_d = torch.full((n, k), -float("inf"), dtype=points.dtype, device=dev)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=dev)
    with ieee_fp32():
        for b in range(nblocks):
            d = pairwise_sqdist(points, ref[b * block:(b + 1) * block])  # (N, block)
            iota = torch.arange(b * block, (b + 1) * block, device=dev).expand(n, block)
            cat_d = torch.cat([best_d, -d], dim=1)
            cat_i = torch.cat([best_i, iota], dim=1)
            best_d, sel = torch.sort(cat_d, dim=1, descending=True, stable=True)
            best_d, sel = best_d[:, :k], sel[:, :k]
            best_i = torch.gather(cat_i, 1, sel)
    return best_i


def estimate_normals(points: torch.Tensor, valid: torch.Tensor | None = None,
                     k: int = 16, block: int = 2048) -> torch.Tensor:
    """Per-point unit normals by PCA over the k nearest neighbours
    (`knn_indices`): the smallest eigenvector of the local covariance,
    accumulated in full float32 (HIGHEST precision in the reference). The
    sign of each normal is whatever ``eigh`` returns."""
    nbrs = points[knn_indices(points, valid, k, block)]  # (N, k, 3)
    mu = torch.mean(nbrs, dim=1, keepdim=True)
    c = nbrs - mu
    with ieee_fp32():
        cov = torch.einsum("nki,nkj->nij", c, c)
    # eigh returns ascending eigenvalues: column 0 is the normal direction.
    # cuSOLVER's batched eigh refuses batches of 32,768 or more 3x3 matrices
    # (CUSOLVER_STATUS_INVALID_VALUE on an H100; 16,384 pass), so batches
    # are cut; each matrix is solved on its own either way.
    nrm = torch.cat([torch.linalg.eigh(c)[1][:, :, 0] for c in cov.split(_EIGH_BATCH)])
    return nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-12)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (3,) axis-angle -> (3,3) rotation (safe at theta -> 0)."""
    th = torch.linalg.norm(w)
    z = w.new_zeros(())
    K = torch.stack([torch.stack([z, -w[2], w[1]]),
                     torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    big = th > 1e-8
    A = torch.where(big, torch.sin(th) / torch.clamp(th, min=1e-12), w.new_ones(()))
    B = torch.where(big, (1.0 - torch.cos(th)) / torch.clamp(th * th, min=1e-12),
                    w.new_full((), 0.5))
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * K + B * (K @ K)


def _icp_plane_core(
    src: torch.Tensor, src_valid: torch.Tensor,
    dst: torch.Tensor, dst_normals: torch.Tensor,
    iters: int, inlier_quantile: float, block: int,
    init_T: torch.Tensor,
) -> ICPResult:
    """Point-to-plane rigid ICP: each iteration solves the linearised 6x6
    normal equations for (omega, t) minimizing sum w ((Rp + t - q) . n)^2
    with R ~ exp([omega]x) about the current estimate. The nearest
    neighbours are one ICP-NN kernel launch per iteration on the card."""
    dtype, dev = src.dtype, src.device
    wv = src_valid.to(dtype)
    nan = torch.full_like(wv, float("nan"))
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    T = init_T.to(dtype)
    rmse = n_in = None
    with ieee_fp32():
        for _ in range(iters):
            cur = src @ T[:3, :3].T + T[:3, 3]
            idx, d2 = nearest_neighbors(cur, dst, block=block)
            thresh = torch.nanquantile(torch.where(src_valid, d2, nan), inlier_quantile)
            w = (d2 <= thresh).to(dtype) * wv
            idx = idx.long()
            q = dst[idx]
            nq = dst_normals[idx]
            r = torch.einsum("ni,ni->n", cur - q, nq)           # signed plane distance
            # J row = [ (p x n)^T , n^T ] for the residual ((Rp+t-q).n)
            J = torch.cat([torch.linalg.cross(cur, nq), nq], dim=1)  # (N, 6)
            Jw = J * w[:, None]
            H = Jw.T @ J
            g = Jw.T @ r
            H = H + 1e-6 * torch.trace(H) / 6.0 * eye6
            x = -torch.linalg.solve(H, g)
            dT = torch.eye(4, dtype=dtype, device=dev)
            dT[:3, :3] = _so3_exp(x[:3])
            dT[:3, 3] = x[3:]
            T = dT @ T
            n_in = torch.sum(w)
            rmse = torch.sqrt(torch.sum(w * r * r) / torch.clamp(n_in, min=1.0))
    return ICPResult(T=T, scale=torch.ones((), dtype=dtype, device=dev), rmse=rmse,
                     n_inliers=n_in.to(torch.int32))


def icp_point_to_plane(
    src,
    dst,
    dst_normals=None,
    iters: int = 15,
    inlier_quantile: float = 0.9,
    block: int = 2048,
    init_T=None,
    normal_k: int = 16,
    bucket: int = 256,
    device=None,
) -> ICPResult:
    """Rigid point-to-plane ICP src -> dst on ``device``. Normals are
    estimated on dst by kNN PCA when not supplied. The same bucketing and
    padding as `icp`; without ``init_T`` the centroids are pre-aligned
    (translation only: rigid, so no scale seed)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = resolve_device(device)
    src = as_f32(src, dev)
    dst = as_f32(dst, dev)
    n, m = src.shape[0], dst.shape[0]
    pad_n = (-n) % bucket
    pad_m = (-m) % bucket
    src_p = torch.cat([src, src.new_zeros((pad_n, 3))])
    valid = torch.arange(n + pad_n, device=dev) < n
    dst_p = torch.cat([dst, dst.new_full((pad_m, 3), 1e9)])
    if dst_normals is None:
        dst_normals = estimate_normals(
            dst_p, valid=torch.arange(m + pad_m, device=dev) < m,
            k=min(normal_k, max(m - 1, 1)), block=block)
    else:
        dst_normals = torch.cat([as_f32(dst_normals, dev), dst.new_zeros((pad_m, 3))])
    if init_T is None:
        T0 = torch.eye(4, dtype=torch.float32, device=dev)
        T0[:3, 3] = torch.mean(dst, dim=0) - torch.mean(src, dim=0)
    else:
        T0 = as_f32(init_T, dev)
    return _icp_plane_core(src_p, valid, dst_p, dst_normals, iters=iters,
                           inlier_quantile=inlier_quantile, block=block, init_T=T0)


def icp_scale_correction(cloud_a, cloud_b, device=None, **kw) -> torch.Tensor:
    """The reference's metric-scale-correction artifact: align cloud_b onto
    cloud_a with a similarity ICP and return the 4x4 T, ready for
    `pipelines/icp_fusion.py` / ``write_T_txt``."""
    return icp(cloud_b, cloud_a, device=device, **kw).T
