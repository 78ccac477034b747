"""Iterative Closest Point with similarity (scale) alignment (port of
`tpu3drec/sfm/icp.py`, point-to-point part).

The reference recovered the metric scale COLMAP cannot with an offline
open3d ICP run that wrote a 4x4 ``T_data.txt``. Here the whole loop stays
on the device: nearest neighbours come from the CUDA kernel
(`ops/csrc/icp_nn.cu`) on the card and from its plain version on the CPU,
the alignment is closed-form Umeyama (with scale), and each iteration
trims correspondences beyond a distance quantile with weights, not
compaction, so shapes stay static.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def icp_scale_correction(cloud_a, cloud_b, device=None, **kw) -> torch.Tensor:
    """The reference's metric-scale-correction artifact: align cloud_b onto
    cloud_a with a similarity ICP and return the 4x4 T, ready for
    `pipelines/icp_fusion.py` / ``write_T_txt``."""
    return icp(cloud_b, cloud_a, device=device, **kw).T
