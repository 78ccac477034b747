"""Global bundle adjustment over a stitched long-sequence trajectory (port
of `tpu3drec/sfm/global_refine.py`).

Windowed SfM, stitching and the pose graph hold locally but drift globally:
windows get BA, the stitched whole never sees a reprojection objective.
This is COLMAP's global BA for the windowed pipeline: one joint bundle
adjustment over every localized frame, with landmarks built from
sequence-level tracks (a track that spans a window boundary constrains both
windows through one 3D point).

Descriptor matching runs through the matcher kernel in pair buckets of
``MATCH_CHUNK``; verification and triangulation are host numpy (per-pair
sizes vary every call); the joint solve is `sfm/ba.py::ba_solve` with
depth priors, on its ``torch.func`` Jacobian path (the BA-blocks kernel's
path refuses depth priors, as the reference's does).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3drec_torch.core.se3 import axis_angle_to_matrix, matrix_to_axis_angle
from tpu3drec_torch.sfm.ba import BAProblem, ba_solve
from tpu3drec_torch.sfm.incremental import build_tracks
from tpu3drec_torch.sfm.matching import match_pairs
from tpu3drec_torch.sfm.triangulate import reprojection_errors_np, triangulate_two_view_np
from tpu3drec_torch.utils.device import resolve_device

MATCH_CHUNK = 128  # pairs per matcher call; short chunks are padded with their first pair


def _poses_wc_from_Ts(Ts):
    """cam->world 4x4s -> dict frame -> (R, t) world->cam (finite only)."""
    out = {}
    for f, T in enumerate(Ts):
        if T is None or not np.isfinite(T).all():
            continue
        R = T[:3, :3].T
        out[f] = (R.astype(np.float32), (-R @ T[:3, 3]).astype(np.float32))
    return out


def _match_sequential(descs, valid, reg, skips, ratio, device=None):
    """Descriptor-match (i, i+skip) pairs among registered frames, in
    buckets of ``MATCH_CHUNK`` pairs, on ``device`` (None means the card).
    Returns {(i, j): (idx_a, idx_b)} raw matches."""
    regset = set(reg)
    pairs = [(i, i + s) for s in skips for i in reg
             if (i + s) in regset]
    if not pairs:
        return {}
    device = resolve_device(device)
    descs_d = torch.as_tensor(descs, dtype=torch.float32, device=device)
    valid_d = torch.as_tensor(valid, dtype=torch.bool, device=device)
    out = {}
    for s in range(0, len(pairs), MATCH_CHUNK):
        chunk = pairs[s:s + MATCH_CHUNK]
        pad = MATCH_CHUNK - len(chunk)
        arr = np.asarray(chunk + [chunk[0]] * pad, np.int32)
        m = match_pairs(descs_d, valid_d, arr, ratio=ratio)
        m_ia = m.idx_a.cpu().numpy()
        m_ib = m.idx_b.cpu().numpy()
        m_ok = m.valid.cpu().numpy()
        for q, (i, j) in enumerate(chunk):
            sel = m_ok[q]
            out[(i, j)] = (m_ia[q][sel].astype(np.int64),
                           m_ib[q][sel].astype(np.int64))
    return out


def _verify_against_poses(pair_matches, xy, poses, K, max_err_px):
    """Keep matches consistent with the CURRENT trajectory: triangulate
    each match under the pair's stitched poses, require cheirality + a
    reprojection bound in both views. Sequential pairs are locally
    accurate even on a drifted trajectory, so this needs no RANSAC — and
    unlike an epipolar gate it also rejects along-epipolar mismatches."""
    Kn = np.asarray(K, np.float64)
    out = {}
    for (i, j), (ia, ib) in pair_matches.items():
        if len(ia) < 8:
            continue
        R1, t1 = poses[i]
        R2, t2 = poses[j]
        P1 = Kn @ np.concatenate([R1, t1[:, None]], axis=1)
        P2 = Kn @ np.concatenate([R2, t2[:, None]], axis=1)
        u1 = xy[i, ia]
        u2 = xy[j, ib]
        X = triangulate_two_view_np(P1, P2, u1, u2)
        e1 = reprojection_errors_np(X, R1, t1, Kn, u1)
        e2 = reprojection_errors_np(X, R2, t2, Kn, u2)
        z1 = (X @ R1.T + t1)[:, 2]
        z2 = (X @ R2.T + t2)[:, 2]
        ok = (e1 < max_err_px) & (e2 < max_err_px) & (z1 > 0) & (z2 > 0) \
            & np.isfinite(X).all(axis=1)
        if ok.sum() >= 8:
            out[(i, j)] = (ia[ok], ib[ok])
    return out


def _closure_pair_matches(closures, xy, max_px: float = 0.5):
    """Closure inlier pixel coords -> keypoint-index matches. The closure
    verifier stores (uv_i, uv_j) gathered FROM the keypoint arrays, so an
    exact nearest lookup in xy recovers the indices; anything farther than
    ``max_px`` (should never happen) is dropped."""
    out = {}
    for c in closures or []:
        if len(c.uv_i) < 8:
            continue
        d_i = np.linalg.norm(xy[c.i][None, :, :] - c.uv_i[:, None, :], axis=2)
        d_j = np.linalg.norm(xy[c.j][None, :, :] - c.uv_j[:, None, :], axis=2)
        ia = d_i.argmin(axis=1)
        ib = d_j.argmin(axis=1)
        ok = (d_i.min(axis=1) < max_px) & (d_j.min(axis=1) < max_px)
        if ok.sum() >= 8:
            key = (min(c.i, c.j), max(c.i, c.j))
            if c.i <= c.j:
                out[key] = (ia[ok].astype(np.int64), ib[ok].astype(np.int64))
            else:
                out[key] = (ib[ok].astype(np.int64), ia[ok].astype(np.int64))
    return out


def _init_landmarks(tracks, xy, poses, K, depth_maps, max_err_px):
    """Initial 3D point per track: depth-anchored from the first observing
    frame with valid metric depth at the keypoint (RGB-D path — exact as
    the sensor), else widest-baseline two-view triangulation gated on
    reprojection + cheirality."""
    Kn = np.asarray(K, np.float64)
    points = {}
    todo = []
    for tid, obs in tracks.items():
        reg = sorted(f for f in obs if f in poses)
        if len(reg) < 2:
            continue
        if depth_maps is not None:
            anchored = False
            for f in reg:
                u, v = xy[f, obs[f]]
                ui, vi = int(round(u)), int(round(v))
                Hd, Wd = depth_maps[f].shape
                if not (0 <= ui < Wd and 0 <= vi < Hd):
                    continue
                z = float(depth_maps[f][vi, ui])
                if z <= 1e-3:
                    continue
                R, t = poses[f]
                Xc = np.array([(u - Kn[0, 2]) / Kn[0, 0] * z,
                               (v - Kn[1, 2]) / Kn[1, 1] * z, z], np.float32)
                points[tid] = (R.T @ (Xc - t)).astype(np.float32)
                anchored = True
                break
            if anchored:
                continue
        f1, f2 = reg[0], reg[-1]
        todo.append((tid, f1, f2, obs[f1], obs[f2]))
    # batched per frame pair (host numpy — group sizes vary every call)
    by_pair = {}
    for tid, f1, f2, k1, k2 in todo:
        by_pair.setdefault((f1, f2), []).append((tid, k1, k2))
    for (f1, f2), items in by_pair.items():
        R1, t1 = poses[f1]
        R2, t2 = poses[f2]
        P1 = Kn @ np.concatenate([R1, t1[:, None]], axis=1)
        P2 = Kn @ np.concatenate([R2, t2[:, None]], axis=1)
        u1 = np.stack([xy[f1, k1] for _, k1, _ in items])
        u2 = np.stack([xy[f2, k2] for _, _, k2 in items])
        X = triangulate_two_view_np(P1, P2, u1, u2)
        e1 = reprojection_errors_np(X, R1, t1, Kn, u1)
        e2 = reprojection_errors_np(X, R2, t2, Kn, u2)
        z1 = (X @ R1.T + t1)[:, 2]
        z2 = (X @ R2.T + t2)[:, 2]
        ok = (e1 < max_err_px) & (e2 < max_err_px) & (z1 > 0) & (z2 > 0) \
            & np.isfinite(X).all(axis=1)
        for m, (tid, _, _) in enumerate(items):
            if ok[m]:
                points[tid] = X[m].astype(np.float32)
    return points


def global_bundle_adjust(
    Ts,                    # list of (4,4) cam->world | None per frame
    features,              # sequence-level (Keypoints, descs) host arrays
    K: np.ndarray,
    depth_maps: np.ndarray | None = None,
    closures=None,         # verified LoopClosures (loopclosure.py) | None
    skips=(1, 2),          # sequential pair gaps to match
    max_err_px: float = 4.0,
    depth_weight: float = 2.0,
    rounds: int = 2,       # BA -> filter -> BA cycles (COLMAP §2.5 style)
    verbose: bool = False,
    device=None,
):
    """One joint reprojection(+depth-prior) bundle adjustment over every
    finite-pose frame of ``Ts``, on ``device`` (None means the card).
    Returns the refined Ts (same layout; frames the solve could not
    constrain keep their input pose)."""
    dev = resolve_device(device)
    kps, descs = features
    xy = np.asarray(kps.xy)
    valid = np.asarray(kps.valid)
    poses = _poses_wc_from_Ts(Ts)
    reg = sorted(poses)
    if len(reg) < 3:
        return Ts

    pair_matches = _match_sequential(descs, valid, reg, skips, ratio=0.85, device=dev)
    pair_matches = _verify_against_poses(pair_matches, xy, poses, K,
                                         max_err_px)
    # closure pairs arrive pre-verified (two-view RANSAC in loopclosure);
    # these are the only LONG-range reprojection constraints in the problem
    for key, v in _closure_pair_matches(closures, xy).items():
        if key[0] in poses and key[1] in poses:
            pair_matches.setdefault(key, v)
    if len(pair_matches) < 2:
        return Ts
    tracks = build_tracks(pair_matches)
    points = _init_landmarks(tracks, xy, poses, K, depth_maps, max_err_px)
    if verbose:
        print(f"[global-ba] {len(pair_matches)} verified pairs -> "
              f"{len(tracks)} tracks, {len(points)} landmarks over "
              f"{len(reg)} frames")
    if len(points) < 32:
        return Ts

    fidx = {f: i for i, f in enumerate(reg)}
    for _round in range(rounds):
        tids = sorted(points)
        tidx = {t: i for i, t in enumerate(tids)}
        cam_i, pt_i, uvs, dvals = [], [], [], []
        for t in tids:
            for f, k in tracks[t].items():
                if f not in fidx:
                    continue
                cam_i.append(fidx[f])
                pt_i.append(tidx[t])
                uvs.append(xy[f, k])
                if depth_maps is not None:
                    u, v = xy[f, k]
                    ui, vi = int(round(u)), int(round(v))
                    Hd, Wd = depth_maps[f].shape
                    dvals.append(float(depth_maps[f][vi, ui])
                                 if 0 <= ui < Wd and 0 <= vi < Hd else 0.0)
        O = len(cam_i)
        if O < 64:
            return Ts
        F, L = len(reg), len(tids)
        # the reference's static-shape buckets: padded observations carry
        # weight 0, padded cameras are frozen
        O_pad = 1 << (O - 1).bit_length()
        F_pad = max(4, 1 << (F - 1).bit_length())
        L_pad = max(64, 1 << (L - 1).bit_length())
        cam_idx = np.zeros(O_pad, np.int32)
        pt_idx = np.zeros(O_pad, np.int32)
        uv = np.zeros((O_pad, 2), np.float32)
        w = np.zeros(O_pad, np.float32)
        cam_idx[:O] = cam_i
        pt_idx[:O] = pt_i
        uv[:O] = np.asarray(uvs)
        w[:O] = 1.0
        cam_params = np.zeros((F_pad, 6), np.float32)
        cam_params[:F, :3] = matrix_to_axis_angle(
            torch.as_tensor(np.stack([poses[f][0] for f in reg]), device=dev)).cpu().numpy()
        cam_params[:F, 3:] = np.stack([poses[f][1] for f in reg])
        cam_params[F:] = cam_params[F - 1]
        pts = np.stack([points[t] for t in tids]).astype(np.float32)
        pts = np.concatenate([pts, np.repeat(pts[-1:], L_pad - L, axis=0)])
        depth = None
        if depth_maps is not None:
            depth = np.zeros(O_pad, np.float32)
            depth[:O] = np.asarray(dvals, np.float32)
        mask = np.ones((F_pad, 6), np.float32)
        mask[0] = 0.0       # gauge: first frame frozen
        mask[F:] = 0.0      # padded cameras frozen
        if depth_maps is None:
            # scale gauge unobservable: pin one translation component
            t1 = cam_params[min(1, F - 1), 3:]
            mask[min(1, F - 1), 3 + int(np.argmax(np.abs(t1)))] = 0.0
        prob = BAProblem.from_numpy(cam_params, pts, cam_idx, pt_idx, uv, w, K,
                                    depth=depth, depth_weight=depth_weight, device=dev)
        res = ba_solve(prob, max_lm_iters=15, cg_iters=30,
                       fix_cam_mask=torch.as_tensor(mask, device=dev))
        new_cams = res.cam_params.cpu().numpy()
        new_pts = res.points.cpu().numpy()
        if not (np.isfinite(new_cams[:F]).all()
                and np.isfinite(new_pts[:L]).all()):
            if verbose:
                print("[global-ba] solve diverged, keeping input trajectory")
            return Ts
        if verbose:
            print(f"[global-ba] round {_round}: cost "
                  f"{float(res.initial_cost):.1f} -> "
                  f"{float(res.final_cost):.1f} in {int(res.n_iters)} iters "
                  f"(F={F} L={L} O={O})")
        # per-frame trust region: the input trajectory is already a
        # refined estimate and BA is a polish. A camera whose center
        # moved far beyond the fleet median did not converge — it is
        # pinned by a handful of wrong-but-verified observations
        # (measured on s00/500: frames 297-303 flew 27-250 m while the
        # median move was ~2 m). Revert those frames; the surviving
        # majority still gets the polish.
        old_c = np.stack([
            -poses[f][0].T @ poses[f][1] for f in reg])
        new_R = axis_angle_to_matrix(res.cam_params[:F, :3]).cpu().numpy()
        new_c = np.stack([
            -new_R[i].T @ new_cams[i, 3:] for i in range(F)])
        move = np.linalg.norm(new_c - old_c, axis=1)
        cap = 10.0 * max(float(np.median(move)), 0.05)
        runaway = move > cap
        if verbose and runaway.any():
            print(f"[global-ba] trust region: {int(runaway.sum())} "
                  f"cameras reverted (moved > {cap:.2f} m)")
        for f, i in fidx.items():
            if runaway[i]:
                continue
            poses[f] = (new_R[i].astype(np.float32),
                        new_cams[i, 3:].astype(np.float32))
        for t, i in tidx.items():
            points[t] = new_pts[i]
        if _round < rounds - 1:
            # COLMAP's post-BA cycle: drop observations off the refined
            # model, drop starved landmarks, go again
            Kn = np.asarray(K, np.float64)
            dead = []
            for tid in list(points):
                X = points[tid]
                obs = tracks.get(tid, {})
                bad = []
                for f, k in obs.items():
                    if f not in poses:
                        continue
                    R, t = poses[f]
                    Xc = R @ X + t
                    if Xc[2] <= 1e-6:
                        bad.append(f)
                        continue
                    u = Xc[0] / Xc[2] * Kn[0, 0] + Kn[0, 2]
                    v = Xc[1] / Xc[2] * Kn[1, 1] + Kn[1, 2]
                    kp = xy[f, k]
                    if (u - kp[0]) ** 2 + (v - kp[1]) ** 2 > max_err_px ** 2:
                        bad.append(f)
                for f in bad:
                    del obs[f]
                if len(obs) < 2:
                    dead.append(tid)
            for tid in dead:
                del points[tid]
            if len(points) < 32:
                break

    out = list(Ts)
    for f, (R, t) in poses.items():
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        out[f] = T
    return out
