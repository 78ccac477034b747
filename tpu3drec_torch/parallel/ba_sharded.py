"""Landmark-sharded bundle adjustment: a distributed Schur complement
(port of `tpu3drec/parallel/ba_sharded.py`).

Observation-sharded BA (`sfm/ba.py::ba_solve` with a mesh) keeps the whole
landmark state (points, V-block inverses, back-substitution) on every
rank. Here the landmarks are partitioned over a mesh axis:

* landmark i lives on shard i // Ls (contiguous blocks, Ls = ceil(L/N));
* every observation is routed to its landmark's shard and carries a LOCAL
  landmark index, so V-block assembly, V^-1 and back-substitution are
  rank-local with no communication;
* cameras are replicated: U, b_c and each CG iteration's S.v product
  reduce with one all-reduce of (F, 6) over the axis.

The LM / PCG math of `sfm.ba.ba_solve` (Huber IRLS, additive damping,
block-Jacobi-preconditioned CG on the reduced camera system, early exit),
including per-observation metric depth-prior rows: a depth residual is
landmark-local like a reprojection residual, so it shards with its
observation. Every stop test reads all-reduced values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.parallel.mesh import Mesh, all_gather, all_reduce
from tpu3drec_torch.sfm.ba import (
    BAProblem, BAResult, _huber_cost, _obs_jacobians, _seg_sum, huber_weights, residuals)


class _ShardedParts(NamedTuple):
    """Host-prepped, shard-ready arrays (leading dim = n_shards * per-shard)."""

    points: np.ndarray        # (N*Ls, 3) padded landmark blocks
    cam_idx: np.ndarray       # (N*Oc,) global camera ids
    pt_idx_local: np.ndarray  # (N*Oc,) LOCAL landmark ids in [0, Ls)
    uv: np.ndarray            # (N*Oc, 2)
    weight: np.ndarray        # (N*Oc,) 0 = padding
    L: int                    # original landmark count
    Ls: int                   # landmarks per shard
    Oc: int                   # observation capacity per shard
    depth: np.ndarray | None = None  # (N*Oc,) metric z per obs, 0 = none


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def prepare_landmark_shards(p: BAProblem, n_shards: int) -> _ShardedParts:
    """Route observations to their landmark's shard; pad to static shapes.

    Per-shard observation capacity is the max over shards (rounded up to a
    multiple of 128); imbalance shows up as padded slots, not wrong
    answers.
    """
    pts = _np(p.points)
    cam_idx = _np(p.cam_idx)
    pt_idx = _np(p.pt_idx)
    uv = _np(p.uv)
    w = _np(p.weight)

    L = pts.shape[0]
    Ls = -(-L // n_shards)
    pts_pad = np.zeros((n_shards * Ls, 3), pts.dtype)
    pts_pad[:L] = pts

    shard_of = pt_idx // Ls
    counts = np.bincount(shard_of, minlength=n_shards)
    Oc = int(-(-max(int(counts.max()), 1) // 128) * 128)

    ci = np.zeros((n_shards, Oc), cam_idx.dtype)
    pl = np.zeros((n_shards, Oc), pt_idx.dtype)
    ob = np.zeros((n_shards, Oc, 2), uv.dtype)
    ww = np.zeros((n_shards, Oc), w.dtype)
    dd = None
    if p.depth is not None:
        d_all = _np(p.depth)
        dd = np.zeros((n_shards, Oc), d_all.dtype)
    for s in range(n_shards):
        sel = np.nonzero(shard_of == s)[0]
        n = sel.size
        ci[s, :n] = cam_idx[sel]
        pl[s, :n] = pt_idx[sel] - s * Ls
        ob[s, :n] = uv[sel]
        ww[s, :n] = w[sel]
        if dd is not None:
            dd[s, :n] = d_all[sel]

    return _ShardedParts(
        points=pts_pad, cam_idx=ci.reshape(-1), pt_idx_local=pl.reshape(-1),
        uv=ob.reshape(-1, 2), weight=ww.reshape(-1), L=L, Ls=Ls, Oc=Oc,
        depth=None if dd is None else dd.reshape(-1),
    )


def ba_solve_landmark_sharded(
    p: BAProblem,
    mesh: Mesh,
    axis: str = "space",
    max_lm_iters: int = 20,
    cg_iters: int = 20,
    huber_px: float = 2.0,
    init_lambda: float = 1e-3,
    fix_cam_mask=None,
) -> BAResult:
    """LM bundle adjustment with landmark state sharded over ``mesh[axis]``.

    Every rank passes the whole problem ``p`` (the host prepares the shards,
    as in the reference) and keeps its block of landmarks and their
    observations on the mesh's device. The same sums as `sfm.ba.ba_solve`,
    reassociated per shard, including metric depth-prior rows when
    ``p.depth`` is set. Returns a BAResult with the full point array
    (gathered once at the end) on every rank.
    """
    has_depth = p.depth is not None
    n_shards = mesh.axis_size(axis)
    s = mesh.axis_index(axis)
    F = p.cam_params.shape[0]
    parts = prepare_landmark_shards(p, n_shards)
    Ls, Oc = parts.Ls, parts.Oc
    dev, dt = mesh.device, p.cam_params.dtype

    def mine(a, n, as_dtype):
        return torch.as_tensor(a[s * n:(s + 1) * n], dtype=as_dtype, device=dev)

    loc = BAProblem(
        cam_params=p.cam_params.to(dev),
        points=mine(parts.points, Ls, dt),
        cam_idx=mine(parts.cam_idx, Oc, torch.int64),
        pt_idx=mine(parts.pt_idx_local, Oc, torch.int64),
        uv=mine(parts.uv, Oc, dt),
        weight=mine(parts.weight, Oc, dt),
        K=p.K.to(dev),
        depth=mine(parts.depth, Oc, dt) if has_depth else None,
        depth_weight=p.depth_weight,
    )
    cam_idx, pt_idx_l, w_in = loc.cam_idx, loc.pt_idx, loc.weight

    if fix_cam_mask is None:
        fix_cam_mask = torch.cat([torch.zeros(1), torch.ones(F - 1)])
    fix_cam_mask = torch.as_tensor(fix_cam_mask, dtype=dt, device=dev)
    cam_free = fix_cam_mask[:, None] if fix_cam_mask.ndim == 1 else fix_cam_mask
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    ein = torch.einsum

    def psum(x):
        return all_reduce(mesh, x, axis)

    def cost_of(cams, pts):
        r = residuals(loc._replace(cam_params=cams, points=pts))
        c = _huber_cost(torch.linalg.vector_norm(r[..., :2], dim=-1), huber_px)
        if has_depth:
            c = c + _huber_cost(torch.abs(r[..., 2]), huber_px)
        return psum(torch.sum(c * w_in))

    def seg_l(vals):  # landmark-local segment sum (no communication)
        return _seg_sum(vals, pt_idx_l, Ls)

    def seg_c(vals):  # camera segment sum + cross-shard reduce
        return psum(_seg_sum(vals, cam_idx, F))

    def lm_step(cams, pts, lam, cost):
        prob = loc._replace(cam_params=cams, points=pts)
        r = residuals(prob)
        w = w_in * huber_weights(r, huber_px)
        Jc, Jp = _obs_jacobians(prob)
        if has_depth:
            # row-wise IRLS sqrt-weight on the depth row: the residual row
            # and both Jacobian rows scale
            a = torch.abs(r[..., 2])
            s_d = torch.sqrt(torch.where(a <= huber_px, torch.ones_like(a),
                                         huber_px / torch.clamp(a, min=1e-12)))
            scale = torch.stack([torch.ones_like(s_d), torch.ones_like(s_d), s_d], 1)
            r = r * scale
            Jc = Jc * scale[..., None]
            Jp = Jp * scale[..., None]
        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None, None]

        U = seg_c(ein("oia,oib->oab", wJc, Jc))
        V = seg_l(ein("oia,oib->oab", wJp, Jp))
        b_c = -seg_c(ein("oia,oi->oa", wJc, r))
        b_p = -seg_l(ein("oia,oi->oa", wJp, r))

        U_l = U + lam * eye6
        V_l = V + lam * eye3
        V_inv = torch.linalg.inv(V_l + 1e-12 * eye3)  # (Ls, 3, 3)

        y = ein("lab,lb->la", V_inv, b_p)
        Wy = ein("oia,oib,ob->oa", wJc, Jp, y[pt_idx_l])
        b_tilde = (b_c - seg_c(Wy)) * cam_free
        U_inv = torch.linalg.inv(U_l + 1e-12 * eye6)

        def S_matvec(v):
            v = v * cam_free
            Uv = ein("fab,fb->fa", U_l, v)
            JcV = ein("oib,ob->oi", Jc, v[cam_idx])
            WtV = seg_l(ein("oia,oi->oa", wJp, JcV))
            z = ein("lab,lb->la", V_inv, WtV)
            Jpz = ein("oib,ob->oi", Jp, z[pt_idx_l])
            WVWt = seg_c(ein("oia,oi->oa", wJc, Jpz))  # the one (F, 6) all-reduce
            return (Uv - WVWt) * cam_free

        def M_inv(v):
            return ein("fab,fb->fa", U_inv, v) * cam_free

        # PCG on the replicated camera system: its vectors and dot products
        # are the same on every rank
        x = torch.zeros_like(b_tilde)
        rr = b_tilde
        z = M_inv(rr)
        pd = z
        rz = torch.sum(rr * z)
        for _ in range(cg_iters):
            Sp = S_matvec(pd)
            alpha = rz / torch.clamp(torch.sum(pd * Sp), min=1e-20)
            x = x + alpha * pd
            rr = rr - alpha * Sp
            z = M_inv(rr)
            rz_new = torch.sum(rr * z)
            pd = z + rz_new / torch.clamp(rz, min=1e-20) * pd
            rz = rz_new
        dc = x

        Jcdc = ein("oib,ob->oi", Jc, dc[cam_idx])
        Wtdc = seg_l(ein("oia,oi->oa", wJp, Jcdc))
        dp = ein("lab,lb->la", V_inv, b_p - Wtdc)

        new_cams = cams + (dc * cam_free).reshape(F, 6)
        new_pts = pts + dp
        new_cost = cost_of(new_cams, new_pts)
        accept = new_cost < cost
        cams = torch.where(accept, new_cams, cams)
        pts = torch.where(accept, new_pts, pts)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e6))
        cost_out = torch.where(accept, new_cost, cost)
        rel = torch.abs(cost - cost_out) / torch.clamp(cost, min=1e-12)
        cost_floor = 1e-8 * torch.clamp(psum(torch.sum(w_in)), min=1.0)
        stop = ((accept & (rel < 1e-7)) | (cost_out <= cost_floor)
                | (~accept & (lam >= 1e6)))
        return cams, pts, lam, cost_out, stop

    with fp.ieee_fp32():
        init_cost = cost_of(loc.cam_params, loc.points)
        cams, pts, cost = loc.cam_params, loc.points, init_cost
        lam = torch.as_tensor(init_lambda, dtype=dt, device=dev)
        it = 0
        while it < max_lm_iters:
            cams, pts, lam, cost, stop = lm_step(cams, pts, lam, cost)
            it += 1
            if bool(all_reduce(mesh, stop.to(torch.int32).reshape(1), axis, "max")):
                break
    points = all_gather(mesh, pts.contiguous(), axis).reshape(-1, 3)[:parts.L]
    return BAResult(cam_params=cams, points=points, initial_cost=init_cost, final_cost=cost,
                    n_iters=it)
