"""Incremental SfM driver (port of `tpu3drec/sfm/incremental.py`).

The view-registration loop is host Python, as in the reference; every
numeric stage inside is a batched call on the device: detection and
description over all frames at once, matching of all pairs through the
matcher kernel, two-view verification of all pairs in one batch, RANSAC
hypothesis batches, and BA over observation arrays. Tracks come from a
host union-find over keypoint matches.

Randomness: each RANSAC call draws from its own ``torch.Generator``
seeded from ``seed`` and the call's place in the run (as the reference
splits ``PRNGKey(seed)``), so a run is reproducible on one device.
``Reconstruction.seconds`` holds the wall seconds of each stage. Program
spans (`utils/tracing.py`): the root ``sfm.job``; ``sfm.detect``,
``sfm.match`` and ``sfm.verify`` from the same stage clock; one
``sfm.register.frame`` a frame tried in the registration loop, holding
``sfm.pnp`` a RANSAC call (counter ``sfm.pnp.attempts``, one a
registration ladder) and the BA its acceptance triggers; ``sfm.ba`` a BA
call.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.core.se3 import axis_angle_to_matrix, matrix_to_axis_angle
from tpu3drec_torch.sfm.ba import BAProblem, ba_solve
from tpu3drec_torch.sfm.features import Keypoints, detect_and_describe
from tpu3drec_torch.sfm.matching import guided_match_pairs, match_pairs, sequential_pairs
from tpu3drec_torch.sfm.pnp import pnp_ransac
from tpu3drec_torch.sfm.sampling import seeded_generator
from tpu3drec_torch.sfm.triangulate import reprojection_errors_np, triangulate_two_view_np
from tpu3drec_torch.sfm.twoview import estimate_relative_pose
from tpu3drec_torch.utils.device import resolve_device
from tpu3drec_torch.utils.tracing import count, record, span

# generator streams of one run (the reference's PRNG key splits)
_VERIFY, _INIT, _PNP, _PNP_LOOSE = 1, 2, 3, 4
STAGES = ("detect", "match", "verify", "register", "ba")


@dataclass
class Reconstruction:
    """Host-side reconstruction state."""

    K: np.ndarray
    poses: dict = field(default_factory=dict)      # frame -> (R, t) world->cam
    points: dict = field(default_factory=dict)     # track id -> (3,) world
    tracks: dict = field(default_factory=dict)     # track id -> {frame: kp_idx}
    keypoints: np.ndarray | None = None            # (F, Kp, 2)
    scale_anchor: int = 1                          # frame whose translation fixes scale
    seconds: dict = field(default_factory=dict)    # stage -> wall seconds

    def registered_frames(self):
        return sorted(self.poses.keys())

    def cameras_as_params(self, device=None):
        """(frames, (F, 6) float32 [axis-angle | t]); the rotations are
        converted on ``device`` (``None``: the card) in one batch."""
        dev = resolve_device(device)
        frames = self.registered_frames()
        R = torch.as_tensor(np.stack([np.asarray(self.poses[f][0], np.float32) for f in frames]),
                            device=dev)
        out = np.zeros((len(frames), 6), np.float32)
        out[:, :3] = matrix_to_axis_angle(R).cpu().numpy()
        out[:, 3:] = np.stack([self.poses[f][1] for f in frames])
        return frames, out


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            self.parent[x] = p = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(pair_matches: dict) -> dict:
    """{(i, j): (idx_a, idx_b)} keypoint matches -> {track: {frame: kp}}.
    A frame seen twice in one track loses both observations; a track left
    with fewer than two is dropped."""
    uf = _UnionFind()
    for (i, j), (ia, ib) in pair_matches.items():
        for a, b in zip(ia, ib):
            uf.union((i, int(a)), (j, int(b)))
    groups = {}
    for node in list(uf.parent):
        groups.setdefault(uf.find(node), []).append(node)
    tracks = {}
    tid = 0
    for members in groups.values():
        if len(members) < 2:
            continue
        frames = [f for f, _ in members]
        if len(set(frames)) != len(frames):
            counts = Counter(frames)
            members = [(f, k) for f, k in members if counts[f] == 1]
            if len(members) < 2:
                continue
        tracks[tid] = {f: k for f, k in members}
        tid += 1
    return tracks


def _median_triangulation_angle_deg(K, R, t, uv1, uv2) -> float:
    """Median ray-intersection angle (degrees) of the two-view
    triangulations under (R, t) with unit baseline; points behind either
    camera excluded (COLMAP's init-pair parallax criterion)."""
    if len(uv1) == 0:
        return 0.0
    K = np.asarray(K, np.float64)
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, np.reshape(t, (3, 1))])
    X = np.asarray(triangulate_two_view_np(P1, P2, uv1, uv2), np.float64)
    Xc2 = X @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    ok = (X[:, 2] > 1e-6) & (Xc2[:, 2] > 1e-6)
    if ok.sum() < 4:
        return 0.0
    d1 = X[ok]
    d2 = X[ok] - (-np.asarray(R, np.float64).T @ np.asarray(t, np.float64))
    cos = np.sum(d1 * d2, axis=1) / np.maximum(
        np.linalg.norm(d1, axis=1) * np.linalg.norm(d2, axis=1), 1e-12)
    return float(np.median(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_sfm(
    images: np.ndarray,          # (F, H, W) grayscale float [0, 1]
    K: np.ndarray,
    max_keypoints: int = 512,
    overlap: int = 3,
    ba_every: int = 3,
    min_track_len: int = 2,
    seed: int = 0,
    upright: bool = True,
    ratio: float = 0.85,
    depth_maps: np.ndarray | None = None,
    depth_weight: float = 2.0,
    guided_min_inliers: int = 40,
    min_parallax_deg: float = 4.0,
    features=None,
    verbose: bool = False,
    device=None,
) -> Reconstruction:
    """Full incremental reconstruction of a sequential image set on
    ``device`` (None means the card). ``depth_maps`` (F, H, W) adds metric
    depth priors to BA; ``features`` takes precomputed (Keypoints, descs)."""
    dev = resolve_device(device)
    with span("sfm.job"), fp.ieee_fp32():
        return _run_sfm(images, K, max_keypoints, overlap, ba_every, min_track_len, seed,
                        upright, ratio, depth_maps, depth_weight, guided_min_inliers,
                        min_parallax_deg, features, verbose, dev)


def _run_sfm(images, K, max_keypoints, overlap, ba_every, min_track_len, seed, upright, ratio,
             depth_maps, depth_weight, guided_min_inliers, min_parallax_deg, features, verbose,
             dev):
    F = images.shape[0]
    if F < 2:
        raise ValueError(f"incremental SfM needs >= 2 frames, got {F}")
    rec = Reconstruction(K=np.asarray(K, np.float32))
    rec.seconds = {s: 0.0 for s in STAGES}
    K_t = torch.tensor(rec.K, device=dev)
    clock = time.perf_counter_ns()

    def lap(stage):
        nonlocal clock
        now = time.perf_counter_ns()
        rec.seconds[stage] += (now - clock) * 1e-9
        if stage in ("detect", "match", "verify"):  # the others come in pieces
            record("sfm." + stage, clock, now)
        clock = now

    def bundle_adjust(maps):
        lap("register")
        with span("sfm.ba"):
            _run_ba(rec, tracks, xy, maps, depth_weight, dev)
        lap("ba")

    # 1. detection + description, batched over frames
    if features is not None:
        kps, descs = features
        kps = Keypoints.from_numpy(*(np.asarray(x) for x in kps), device=dev)
        descs = torch.tensor(np.asarray(descs, np.float32), device=dev)
    else:
        kps, descs = detect_and_describe(
            torch.as_tensor(np.asarray(images, np.float32), device=dev),
            max_keypoints=max_keypoints, upright=upright)
    xy = kps.xy.cpu().numpy()          # (F, Kp, 2)
    rec.keypoints = xy
    lap("detect")

    # 2. sequential matching, all pairs in one call of the matcher kernel
    pairs = sequential_pairs(F, overlap=overlap)
    m = match_pairs(descs, kps.valid, pairs, ratio=ratio)
    _sync(dev)
    lap("match")

    # 2b. geometric verification of every pair in one batch
    pairs_t = torch.as_tensor(pairs, dtype=torch.int64, device=dev)
    uv_a = torch.gather(kps.xy[pairs_t[:, 0]], 1, m.idx_a.long()[..., None].expand(-1, -1, 2))
    uv_b = torch.gather(kps.xy[pairs_t[:, 1]], 1, m.idx_b.long()[..., None].expand(-1, -1, 2))
    tv = estimate_relative_pose(uv_a, uv_b, m.valid, K_t,
                                seeded_generator(dev, seed, _VERIFY), inlier_px=1.5)
    geo_valid = (m.valid & tv.inliers).cpu().numpy()
    geo_n = tv.n_inliers.cpu().numpy()

    # 2c. guided matching for starved verified pairs only
    starved = [p for p in range(len(pairs)) if 0 < int(geo_n[p]) < guided_min_inliers]
    if starved:
        sp = torch.as_tensor(starved, dtype=torch.int64, device=dev)
        guided = guided_match_pairs(descs, kps.valid, kps.xy, pairs_t[sp], tv.E[sp], K_t)
        g_ib_all = guided.idx_b.cpu().numpy()
        g_valid_all = guided.valid.cpu().numpy()
        g_ib = {int(p): g_ib_all[q] for q, p in enumerate(starved)}
        g_valid = {int(p): g_valid_all[q] for q, p in enumerate(starved)}
    else:
        g_ib, g_valid = {}, {}

    m_valid = m.valid.cpu().numpy()
    m_ia = m.idx_a.cpu().numpy()
    m_ib = m.idx_b.cpu().numpy()
    pair_matches = {}
    for p, (i, j) in enumerate(pairs):
        if int(geo_n[p]) >= 12:
            sel = geo_valid[p]
        elif int(m_valid[p].sum()) >= 8 and int(geo_n[p]) >= 8:
            sel = geo_valid[p]
        else:
            continue
        # guided matches first, RANSAC inliers overwrite on conflict
        a_to_b = {}
        if p in g_valid:
            a_to_b = {int(a): int(b) for a, b in zip(np.nonzero(g_valid[p])[0],
                                                     g_ib[p][g_valid[p]])}
        for a, b in zip(m_ia[p][sel], m_ib[p][sel]):
            a_to_b[int(a)] = int(b)
        ia = np.fromiter(a_to_b.keys(), np.int64, len(a_to_b))
        ib = np.fromiter(a_to_b.values(), np.int64, len(a_to_b))
        pair_matches[(int(i), int(j))] = (ia, ib)

    tracks = build_tracks(pair_matches)
    rec.tracks = tracks
    if verbose:
        print(f"[sfm] {len(tracks)} tracks from {len(pair_matches)} pairs")

    # 3. two-view initialisation: the first pair (0, k) by ascending k whose
    # median triangulation angle clears min_parallax_deg; otherwise the
    # best-supported pair
    def _corr_0k(k):
        if (0, k) in pair_matches:
            return pair_matches[(0, k)]
        ia, ib = [], []
        for obs in tracks.values():
            if 0 in obs and k in obs:
                ia.append(obs[0])
                ib.append(obs[k])
        return np.asarray(ia, np.int64), np.asarray(ib, np.int64)

    init_pair = None
    fallback_pair = None
    fallback_score = 0
    for k in range(1, F):
        ia, ib = _corr_0k(k)
        if len(ia) < 16:
            if k > overlap:
                break
            continue
        uv1 = np.zeros((max_keypoints, 2), np.float32)
        uv2 = np.zeros((max_keypoints, 2), np.float32)
        vmask = np.zeros(max_keypoints, bool)
        uv1[: len(ia)] = xy[0, ia]
        uv2[: len(ib)] = xy[k, ib]
        vmask[: len(ia)] = True
        tv0 = estimate_relative_pose(torch.as_tensor(uv1, device=dev),
                                     torch.as_tensor(uv2, device=dev),
                                     torch.as_tensor(vmask, device=dev), K_t,
                                     seeded_generator(dev, seed, _INIT, k))
        n_inl = int(tv0.n_inliers)
        if n_inl < max(12, int(0.5 * len(ia))):
            continue
        R_, t_ = tv0.R.cpu().numpy(), tv0.t.cpu().numpy()
        inl = tv0.inliers.cpu().numpy()[: len(ia)]
        med_ang = _median_triangulation_angle_deg(rec.K, R_, t_, xy[0, ia][inl], xy[k, ib][inl])
        if med_ang >= min_parallax_deg:
            init_pair = (k, R_, t_)
            break
        if n_inl > fallback_score:
            fallback_score = n_inl
            fallback_pair = (k, R_, t_)
    if init_pair is None:
        init_pair = fallback_pair
    if init_pair is None:
        raise ValueError("no pair with enough matches to initialize")
    k, R1, t1 = init_pair
    rec.poses[0] = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    rec.poses[k] = (R1, t1.astype(np.float32))
    rec.scale_anchor = k
    lap("verify")

    _triangulate_new(rec, tracks, xy, min_track_len)
    if depth_maps is not None:
        # the seed has unit baseline but the depth priors are metric: pre-scale
        ratios = []
        for f in (0, k):
            R, t = rec.poses[f]
            dm = depth_maps[f]
            Hd, Wd = dm.shape
            for tid, X in rec.points.items():
                if f not in tracks.get(tid, {}):
                    continue
                Xc = R @ X + t
                if Xc[2] <= 1e-6:
                    continue
                u = int(round(Xc[0] / Xc[2] * rec.K[0, 0] + rec.K[0, 2]))
                v = int(round(Xc[1] / Xc[2] * rec.K[1, 1] + rec.K[1, 2]))
                if 0 <= u < Wd and 0 <= v < Hd and dm[v, u] > 1e-3:
                    ratios.append(dm[v, u] / Xc[2])
        if len(ratios) >= 5:
            s0 = float(np.median(ratios))
            for f, (R, t) in rec.poses.items():
                rec.poses[f] = (R, t * s0)
            for tid in rec.points:
                rec.points[tid] = rec.points[tid] * s0
        for f in (0, k):
            _depth_anchor_points(rec, tracks, xy, depth_maps, f)
    # polish the seed without depth priors before growing
    bundle_adjust(None)
    if verbose:
        print(f"[sfm] init pair (0, {k}): {len(rec.points)} landmarks")

    # 4. incremental registration, two passes
    def _gather_2d3d(f):
        X2d, X3d = [], []
        for tid, obs in tracks.items():
            if tid in rec.points and f in obs:
                X3d.append(rec.points[tid])
                X2d.append(xy[f, obs[f]])
        return X3d, X2d

    def _try_pnp(f, X3d, X2d):
        """Registration ladder: a 3 px gate at 30% consensus, then 6 px at
        60%."""
        n = len(X3d)
        cap = max(64, 1 << (n - 1).bit_length())
        Xp = np.zeros((cap, 3), np.float32)
        up = np.zeros((cap, 2), np.float32)
        vm = np.zeros(cap, bool)
        Xp[:n] = np.asarray(X3d)
        up[:n] = np.asarray(X2d)
        vm[:n] = True
        attempt = pnp_attempts.get(f, 0)
        pnp_attempts[f] = attempt + 1
        count("sfm.pnp.attempts")
        args = (torch.as_tensor(Xp, device=dev), torch.as_tensor(up, device=dev),
                torch.as_tensor(vm, device=dev), K_t)
        with span("sfm.pnp"):
            res = pnp_ransac(*args, seeded_generator(dev, seed, _PNP, f, attempt))
            n_inl = int(res.n_inliers)
        if n_inl >= max(8, int(0.3 * n)):
            return res, n_inl, False
        with span("sfm.pnp"):
            res2 = pnp_ransac(*args, seeded_generator(dev, seed, _PNP_LOOSE, f % 6, attempt),
                              inlier_px=6.0)
            n2 = int(res2.n_inliers)
        if n2 >= max(12, int(0.6 * n)):
            return res2, n2, True
        if verbose:
            print(f"[sfm] frame {f}: PnP rejected ({n_inl}/{n} at 3px, {n2}/{n} at 6px)")
        return None, n_inl, False

    ba_retry_done: set = set()
    pnp_attempts: dict = {}
    for _pass in range(2):
        for f in range(F):
            if f in rec.poses:
                continue
            with span("sfm.register.frame"):
                X3d, X2d = _gather_2d3d(f)
                if len(X3d) < 8:
                    if verbose:
                        print(f"[sfm] frame {f}: only {len(X3d)} 2D-3D, skipping")
                    continue
                res, n_inl, loose = _try_pnp(f, X3d, X2d)
                if res is None and len(X3d) >= 30 and f not in ba_retry_done:
                    # one polish + retriangulate + retry per frame
                    ba_retry_done.add(f)
                    bundle_adjust(depth_maps)
                    X3d, X2d = _gather_2d3d(f)
                    if len(X3d) >= 8:
                        res, n_inl, loose = _try_pnp(f, X3d, X2d)
                        if res is not None and verbose:
                            print(f"[sfm] frame {f}: registered after BA retry")
                if res is None:
                    continue
                rec.poses[f] = (res.R.cpu().numpy(), res.t.cpu().numpy())
                if depth_maps is not None:
                    _depth_anchor_points(rec, tracks, xy, depth_maps, f)
                _triangulate_new(rec, tracks, xy, min_track_len)
                # a loose-gate acceptance leans on BA at once
                if loose or (len(rec.poses) % ba_every == 0):
                    bundle_adjust(depth_maps)
                if verbose:
                    print(f"[sfm] frame {f}: {n_inl}/{len(X3d)} PnP inliers, "
                          f"{len(rec.points)} landmarks")
    bundle_adjust(depth_maps)
    return rec


def _filter_observations(rec: Reconstruction, tracks, xy, max_err_px: float = 4.0) -> int:
    """Drop track observations whose reprojection error against the current
    model exceeds ``max_err_px``, and landmarks left with < 2 observations."""
    removed = 0
    dead = []
    for tid in list(rec.points.keys()):
        X = rec.points[tid]
        obs = tracks.get(tid, {})
        bad = []
        for f, k in obs.items():
            if f not in rec.poses:
                continue
            R, t = rec.poses[f]
            Xc = R @ X + t
            if Xc[2] <= 1e-6:
                bad.append(f)
                continue
            u = Xc[0] / Xc[2] * rec.K[0, 0] + rec.K[0, 2]
            v = Xc[1] / Xc[2] * rec.K[1, 1] + rec.K[1, 2]
            kp = xy[f, k]
            if (u - kp[0]) ** 2 + (v - kp[1]) ** 2 > max_err_px ** 2:
                bad.append(f)
        for f in bad:
            del obs[f]
            removed += 1
        if len(obs) < 2:
            dead.append(tid)
    for tid in dead:
        del rec.points[tid]
    return removed


def _depth_anchor_points(rec: Reconstruction, tracks, xy, depth_maps, f: int) -> int:
    """New landmarks for frame ``f``'s tracks straight from its metric depth
    map: X = R^T (z K^-1 [u v 1] - t); dropout pixels fall through to DLT."""
    R, t = rec.poses[f]
    dm = depth_maps[f]
    Hd, Wd = dm.shape
    K = rec.K
    n_new = 0
    for tid, obs in tracks.items():
        if tid in rec.points or f not in obs:
            continue
        u, v = xy[f, obs[f]]
        ui, vi = int(round(u)), int(round(v))
        if not (0 <= ui < Wd and 0 <= vi < Hd):
            continue
        z = float(dm[vi, ui])
        if z <= 1e-3:
            continue
        Xc = np.array([(u - K[0, 2]) / K[0, 0] * z, (v - K[1, 2]) / K[1, 1] * z, z], np.float32)
        rec.points[tid] = (R.T @ (Xc - t)).astype(np.float32)
        n_new += 1
    return n_new


def _triangulate_new(rec: Reconstruction, tracks, xy, min_track_len):
    """Triangulate tracks seen in >= 2 registered frames (widest registered
    pair), grouped by frame pair, on the host."""
    todo = []
    for tid, obs in tracks.items():
        if tid in rec.points:
            continue
        reg = sorted(f for f in obs if f in rec.poses)
        if len(reg) >= max(2, min_track_len):
            f1, f2 = reg[0], reg[-1]
            todo.append((tid, f1, f2, obs[f1], obs[f2]))
    if not todo:
        return
    by_pair = {}
    for tid, f1, f2, k1, k2 in todo:
        by_pair.setdefault((f1, f2), []).append((tid, k1, k2))
    K = np.asarray(rec.K)
    for (f1, f2), items in by_pair.items():
        R1, t1 = rec.poses[f1]
        R2, t2 = rec.poses[f2]
        P1 = K @ np.concatenate([R1, t1[:, None]], axis=1)
        P2 = K @ np.concatenate([R2, t2[:, None]], axis=1)
        u1 = np.stack([xy[f1, k1] for _, k1, _ in items])
        u2 = np.stack([xy[f2, k2] for _, _, k2 in items])
        Xn = triangulate_two_view_np(P1, P2, u1, u2)
        e1 = reprojection_errors_np(Xn, R1, t1, K, u1)
        e2 = reprojection_errors_np(Xn, R2, t2, K, u2)
        z1 = (Xn @ R1.T + t1)[:, 2]
        z2 = (Xn @ R2.T + t2)[:, 2]
        ok = (e1 < 4.0) & (e2 < 4.0) & (z1 > 0) & (z2 > 0)
        for m, (tid, _, _) in enumerate(items):
            if ok[m]:
                rec.points[tid] = Xn[m].astype(np.float32)


def _run_ba(rec: Reconstruction, tracks, xy, depth_maps=None, depth_weight=2.0, device=None):
    """Global BA over all registered frames and landmarks (static-padded:
    observations to a power of two, cameras and landmarks to buckets, as the
    reference pads them). With depth_maps each observation carries the
    metric depth at its keypoint as a prior row."""
    dev = resolve_device(device)
    frames, cam_params = rec.cameras_as_params(dev)
    fidx = {f: i for i, f in enumerate(frames)}
    tids = [t for t in rec.points]
    tidx = {t: i for i, t in enumerate(tids)}
    cam_i, pt_i, uvs, dvals = [], [], [], []
    for t in tids:
        for f, k in tracks[t].items():
            if f in fidx:
                cam_i.append(fidx[f])
                pt_i.append(tidx[t])
                uvs.append(xy[f, k])
                if depth_maps is not None:
                    u, v = xy[f, k]
                    ui, vi = int(round(u)), int(round(v))
                    H, W = depth_maps[f].shape
                    dvals.append(float(depth_maps[f][vi, ui])
                                 if 0 <= ui < W and 0 <= vi < H else 0.0)
    if len(cam_i) < 10 or len(frames) < 2:
        return
    O = len(cam_i)
    cap = 1 << (O - 1).bit_length()
    cam_idx = np.zeros(cap, np.int64)
    pt_idx = np.zeros(cap, np.int64)
    uv = np.zeros((cap, 2), np.float32)
    w = np.zeros(cap, np.float32)
    cam_idx[:O] = cam_i
    pt_idx[:O] = pt_i
    uv[:O] = np.asarray(uvs)
    w[:O] = 1.0
    points = np.stack([rec.points[t] for t in tids]).astype(np.float32)
    # padded cameras replicate the last pose, padded landmarks the last
    # point; neither has observations, so LM damping keeps them fixed
    F, L = len(frames), len(tids)
    F_pad = max(4, 1 << (F - 1).bit_length())
    L_pad = max(64, 1 << (L - 1).bit_length())
    cam_params = np.concatenate([cam_params, np.repeat(cam_params[-1:], F_pad - F, axis=0)])
    points = np.concatenate([points, np.repeat(points[-1:], L_pad - L, axis=0)])
    depth = None
    if depth_maps is not None:
        depth = np.zeros(cap, np.float32)
        depth[:O] = np.asarray(dvals, np.float32)
    prob = BAProblem.from_numpy(cam_params, points, cam_idx, pt_idx, uv, w, rec.K,
                                depth=depth, depth_weight=depth_weight, device=dev)
    # gauge: freeze the first frame; without depth also pin the largest
    # translation component of the scale anchor
    mask = np.ones((F_pad, 6), np.float32)
    mask[0] = 0.0
    mask[F:] = 0.0
    if depth_maps is None:
        anchor = (rec.scale_anchor if rec.scale_anchor in fidx
                  else frames[min(1, len(frames) - 1)])
        t_anchor = cam_params[fidx[anchor], 3:]
        mask[fidx[anchor], 3 + int(np.argmax(np.abs(t_anchor)))] = 0.0
    res = ba_solve(prob, max_lm_iters=10, cg_iters=15,
                   fix_cam_mask=torch.as_tensor(mask, device=dev))
    Rs = axis_angle_to_matrix(res.cam_params[:F, :3]).cpu().numpy()
    new_cams = res.cam_params.cpu().numpy()
    new_pts = res.points.cpu().numpy()
    for i, f in enumerate(frames):
        rec.poses[f] = (Rs[i].astype(np.float32), new_cams[i, 3:].astype(np.float32))
    for t, i in tidx.items():
        rec.points[t] = new_pts[i]
    # COLMAP's post-BA cycle: filter outliers, re-triangulate lost tracks
    _filter_observations(rec, tracks, xy)
    _triangulate_new(rec, tracks, xy, min_track_len=2)
