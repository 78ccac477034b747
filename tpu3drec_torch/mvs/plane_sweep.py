"""Plane-sweep multi-view stereo depth, the dmrecon analogue (port of
`tpu3drec/mvs/plane_sweep.py`).

D fronto-parallel planes in the reference view, uniform in inverse depth;
every source view is warped onto each plane by one homography per
(source, plane) and scored with windowed ZNCC, which is invariant to
per-frame exposure gain and bias. The warp is the quad-packed bilinear
sample of `ops/quadpack.py`; the window statistics are zero-padded box sums
taken as tap sums (one shifted add per tap, so the result does not depend
on the batch, as a convolution's may); the sweep goes through the planes in
chunks, so only one chunk of warped views is held at a time.

Per pixel: the refined depth (3-point parabola around the winning plane),
the winning ZNCC score and the number of source views that observed it.
`geometric_consistency` then cross-validates the per-view depth maps
against each other before TSDF fusion.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu3drec_torch.core import fp
from tpu3drec_torch.ops.quadpack import quad_gather, quad_pack
from tpu3drec_torch.utils.device import as_f32, resolve_device


def relative_pose(R_ref, t_ref, R_src, t_src):
    """(R, t) mapping reference-camera coordinates to source-camera ones;
    both poses world->cam: x_s = (R_s R_r^T) x_r + (t_s - R_s R_r^T t_r)."""
    R_rel = R_src @ R_ref.T
    t_rel = t_src - R_rel @ t_ref
    return R_rel, t_rel


def _plane_homographies(K, R_rel, t_rel, inv_depths):
    """(D, 3, 3) pixel homographies ref->src for the fronto-parallel planes
    z_ref = 1 / inv_depth: H(d) = K (R_rel + inv_d t_rel n^T) K^-1,
    n = [0, 0, 1] in the reference camera."""
    Kinv = torch.linalg.inv(K)
    n = K.new_tensor([0.0, 0.0, 1.0])
    outer = t_rel[:, None] * n[None, :]
    Hs = R_rel[None] + inv_depths[:, None, None] * outer[None]
    return K[None] @ Hs @ Kinv[None]


def _box_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """(..., H, W) -> the same-shape sum over a (window, window) box with
    zero padding (SAME): a column pass, then a row pass, each a sum of
    shifted copies in tap order."""
    lo = (window - 1) // 2
    hi = window - 1 - lo
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, lo, hi))
    acc = xp[..., 0:h, :]
    for k in range(1, window):
        acc = acc + xp[..., k:k + h, :]
    xp = F.pad(acc, (lo, hi))
    acc = xp[..., 0:w]
    for k in range(1, window):
        acc = acc + xp[..., k:k + w]
    return acc


def _warp(qimg: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`ops/quadpack.py::bilinear_sample_quad` of a one-channel quad-packed
    image at x in [0, W-1], y in [0, H-1], with the corners' sum as XLA's
    CPU compiler contracts it into fused multiply-adds, so that the float32
    ZNCC costs round as the JAX package's do."""
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    v00, v01, v10, v11 = (c[..., 0] for c in quad_gather(qimg, y0.long(), x0.long()))
    acc = fp.fma(v00 * (1 - wx), 1 - wy, v01 * wx * (1 - wy))
    return fp.fma(v11 * wx, wy, fp.fma(v10 * (1 - wx), wy, acc))


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)``: start (1 - s) +
    stop s with s = i / (num - 1), the stop value itself last."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    out = fp.fma(stop_t.expand_as(s), s, start_t * (1 - s))
    return torch.cat([out, stop_t[None]])


def plane_sweep_depth(ref_img, src_imgs, K, R_ref, t_ref, Rs_src, ts_src,
                      d_min: float, d_max: float, n_planes: int = 96, window: int = 5,
                      chunk: int = 8, device=None):
    """Dense reference-view depth by plane-sweep ZNCC stereo.

    ref_img (H, W) grayscale in [0, 1], src_imgs (S, H, W), K (3, 3), poses
    world->cam (R_ref (3, 3), t_ref (3,), Rs_src (S, 3, 3), ts_src (S, 3)).
    Returns (depth (H, W), zncc (H, W) winning score in [-1, 1], n_valid
    (H, W) int32 source views covering the winner) on ``device``. Pixels no
    source observed get depth 0."""
    dev = resolve_device(device)
    ref_img, src_imgs, K = (as_f32(a, dev) for a in (ref_img, src_imgs, K))
    R_ref, t_ref, Rs_src, ts_src = (as_f32(a, dev) for a in (R_ref, t_ref, Rs_src, ts_src))
    H, W = ref_img.shape
    S = src_imgs.shape[0]
    if n_planes % chunk:
        raise ValueError(f"n_planes {n_planes} not divisible by chunk {chunk}")
    # the planes and the homographies of every (source, plane), (S, D, 3,
    # 3): a few hundred 3x3 products, on the host, so that every device
    # sweeps with the same matrices
    cpu = torch.device("cpu")
    inv_ds = _linspace(1.0 / d_max, 1.0 / d_min, n_planes, cpu)
    K_h, R_h, t_h, Rs_h, ts_h = (a.to(cpu) for a in (K, R_ref, t_ref, Rs_src, ts_src))
    Hmats = torch.stack([_plane_homographies(K_h, *relative_pose(R_h, t_h, Rs_h[s], ts_h[s]),
                                             inv_ds) for s in range(S)]).to(dev)
    inv_ds = inv_ds.to(dev)
    # the reference window's statistics, shared by every plane and source
    npix = _box_sum(torch.ones_like(ref_img), window)
    ref_mean = _box_sum(ref_img, window) / npix
    ref_var = torch.clamp_min(_box_sum(ref_img * ref_img, window) / npix - ref_mean ** 2, 0.0)
    qsrc = [quad_pack(im[..., None]) for im in src_imgs]
    u = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)

    cost = torch.empty((n_planes, H, W), dtype=torch.float32, device=dev)
    zncc = torch.empty_like(cost)
    nvalid = torch.empty((n_planes, H, W), dtype=torch.int32, device=dev)
    for c0 in range(0, n_planes, chunk):
        warped, inb = [], []
        for s in range(S):
            Hm = Hmats[s, c0:c0 + chunk, :, :, None, None]  # (C, 3, 3, 1, 1)
            # Hm @ [u, v, 1], each row as XLA's CPU dot forms it
            p = [fp.fma(Hm[:, i, 1], v, Hm[:, i, 0] * u) + Hm[:, i, 2] for i in range(3)]
            zw = p[2]
            den = torch.where(torch.abs(zw) < 1e-9, zw.new_full((), 1e-9), zw)
            x, y = p[0] / den, p[1] / den
            ok = (zw > 1e-6) & (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
            sample = _warp(qsrc[s], fp.clip(x, 0, W - 1), fp.clip(y, 0, H - 1))
            warped.append(torch.where(ok, sample, 0.0))
            inb.append(ok)
        warped = torch.stack(warped, dim=1)  # (C, S, H, W)
        inb = torch.stack(inb, dim=1)
        w_mean = _box_sum(warped, window) / npix
        w_var = torch.clamp_min(_box_sum(warped * warped, window) / npix - w_mean ** 2, 0.0)
        cross = _box_sum(ref_img * warped, window) / npix - ref_mean * w_mean
        # 1/sqrt rounded once, in float64: torch.rsqrt rounds differently on
        # the card and on the CPU
        z = cross * torch.sqrt((ref_var * w_var + 1e-8).double()).reciprocal().float()
        # a window must be mostly in view to count
        oks = _box_sum(inb.to(torch.float32), window) / npix > 0.8
        z = torch.where(oks, z, -1.0)
        nv = oks.sum(1, dtype=torch.int32)
        # the mean ZNCC over the observing sources; unobserved pixels -> -1
        zs = torch.where(oks, z, 0.0)
        zsum = zs[:, 0]
        for s in range(1, S):  # in source order, the same on every device
            zsum = zsum + zs[:, s]
        zm = zsum / torch.clamp_min(nv, 1)
        zm = torch.where(nv > 0, zm, -1.0)
        cost[c0:c0 + chunk] = 1.0 - zm
        zncc[c0:c0 + chunk] = zm
        nvalid[c0:c0 + chunk] = nv

    D = n_planes
    best = torch.argmin(cost, dim=0)  # the first index on ties

    def take(vol, idx):
        return torch.gather(vol, 0, idx[None])[0]

    c0_ = take(cost, torch.clamp(best - 1, 0, D - 1))
    c1_ = take(cost, best)
    c2_ = take(cost, torch.clamp(best + 1, 0, D - 1))
    # 3-point parabola minimum in plane index (inverse depth is linear in it)
    denom = c0_ - 2 * c1_ + c2_
    big = torch.abs(denom) > 1e-9
    off = torch.where(big, 0.5 * (c0_ - c2_) / torch.where(big, denom, 1.0), 0.0)
    off = fp.clip(off, -0.5, 0.5)
    # interior planes only: at the sweep's ends the parabola is one-sided
    off = torch.where((best > 0) & (best < D - 1), off, 0.0)
    idx = best.to(torch.float32) + off
    step_id = (inv_ds[-1] - inv_ds[0]) / (D - 1)
    inv_d = fp.fma(idx, step_id.expand_as(idx), inv_ds[0].expand_as(idx))
    depth = 1.0 / torch.clamp_min(inv_d, 1e-9)
    best_nv = take(nvalid, best)
    depth = torch.where(best_nv > 0, depth, 0.0)
    return depth, take(zncc, best), best_nv


def _consistency_counts(depths, K, Rs, ts, ref_idx: int, rel_err: float = 0.02):
    """For reference view ``ref_idx``: project every pixel's depth into
    every other view and count the views whose own depth map agrees within
    ``rel_err`` (relative). Returns (H, W) int32 counts."""
    F_, H, W = depths.shape
    d_ref = depths[ref_idx]
    R_r, t_r = Rs[ref_idx], ts[ref_idx]
    Kinv = torch.linalg.inv(K)
    u = torch.arange(W, dtype=torch.float32, device=depths.device).expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=depths.device)[:, None].expand(H, W)
    pix = torch.stack([u, v, torch.ones_like(u)], -1)
    pts_ref = torch.einsum("ij,hwj->hwi", Kinv, pix) * d_ref[..., None]
    count = torch.zeros((H, W), dtype=torch.int32, device=depths.device)
    for s in range(F_):
        if s == ref_idx:
            continue
        R_rel = Rs[s] @ R_r.T
        t_rel = ts[s] - R_rel @ t_r
        p_s = torch.einsum("ij,hwj->hwi", R_rel, pts_ref) + t_rel
        z = p_s[..., 2]
        uv = torch.einsum("ij,hwj->hwi", K, p_s)
        den = torch.where(torch.abs(uv[..., 2]) < 1e-9, uv.new_full((), 1e-9), uv[..., 2])
        x, y = uv[..., 0] / den, uv[..., 1] / den
        xi = torch.clamp(torch.round(x).to(torch.int64), 0, W - 1)
        yi = torch.clamp(torch.round(y).to(torch.int64), 0, H - 1)
        d_obs = depths[s][yi, xi]
        inb = ((z > 1e-6) & (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
               & (d_obs > 0) & (d_ref > 0))
        count += (inb & (torch.abs(d_obs - z) <= rel_err * z)).to(torch.int32)
    return count


def geometric_consistency(depths, K, Rs, ts, rel_err: float = 0.02, min_consistent: int = 2,
                          device=None) -> np.ndarray:
    """Cross-view depth validation (scene2pset's confidence filter): a
    pixel's depth survives only if at least ``min_consistent`` other views'
    depth maps agree with it within ``rel_err`` relative error.

    depths (F, H, W); Rs / ts (F, 3, 3) / (F, 3) world->cam. Returns an
    (F, H, W) bool numpy mask."""
    dev = resolve_device(device)
    depths, K, Rs, ts = (as_f32(a, dev) for a in (depths, K, Rs, ts))
    with fp.ieee_fp32():
        counts = torch.stack([_consistency_counts(depths, K, Rs, ts, f, rel_err=rel_err)
                              for f in range(depths.shape[0])])
    return ((counts >= min_consistent) & (depths > 0)).cpu().numpy()
