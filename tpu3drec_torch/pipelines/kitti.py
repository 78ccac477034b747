"""KITTI odometry pipeline: windowed SfM over long sequences, stitched
(port of `tpu3drec/pipelines/kitti.py`).

Long sequences are reconstructed in overlapping windows, each one `run_sfm`
call on the device; consecutive windows are stitched by aligning their
shared frames. Loop closures (`sfm/loopclosure.py`) relocalize frames the
stitcher could not place and add closure edges; pending windows are bridged
across small odometry gaps; a switchable pose graph (`sfm/posegraph.py`)
and a global bundle adjustment (`sfm/global_refine.py`) refine the whole.
Every device call runs on ``device`` (None means the card); the stitching
logic is host numpy, as in the reference.

Multi-process: when the process group holds more than one process
(`parallel/multihost.py`), each process reconstructs its `process_slice`
of the windows; the window pose dicts are packed into fixed shapes (float32
poses, as the reference packs them), gathered, and every process runs the
same stitching, loop closure and refinement. ``parallel_windows`` > 1
reconstructs a process's windows concurrently in threads on its one
device. Each window's generators come from ``cfg.seed + widx``, so a
window reconstructs the same whichever process or thread owns it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.core.se3 import axis_angle_to_matrix, matrix_to_axis_angle
from tpu3drec_torch.parallel.multihost import process_allgather, process_count, process_slice
from tpu3drec_torch.sfm.features import Keypoints, detect_and_describe
from tpu3drec_torch.sfm.incremental import run_sfm
from tpu3drec_torch.sfm.posegraph import (
    PoseGraph, edge_residuals, optimize_pose_graph, optimize_pose_graph_switchable)
from tpu3drec_torch.utils.device import resolve_device
from tpu3drec_torch.utils.trajectory_eval import ate, rpe, trajectory_length

# the stages of `run_windowed_sfm` whose wall seconds `debug_state` receives
STAGES = ("detect", "windows", "stitch", "loop_closure", "pose_graph", "global_ba")


@dataclass
class KittiRunConfig:
    window: int = 12
    stride: int = 7           # window step; overlap = window - stride
                              # (>= 3 shared frames needed for a robust
                              # similarity stitch; 2-frame stitches drift)
    max_keypoints: int = 512
    overlap_matches: int = 3  # sequential matching overlap inside a window
    pose_graph: bool = True   # GN pose-graph refinement over window edges
    loop_closure: bool = True # detect + verify revisits, add closure edges
    lc_min_gap: int = 10      # min frame separation for a closure candidate
    lc_sim: float = 0.85      # global-descriptor similarity gate (mean-pool)
    lc_method: str = "vlad"   # retrieval: "vlad" (k-means vocab + VLAD,
                              # wider revisit margins — the COLMAP
                              # vocab-tree analogue) or "mean" (round-1
                              # mean pooling). vlad became the default in
                              # round 3 once the PnP registration ladder
                              # removed the split-island failure mode that
                              # made relocalization anchor-set-sensitive
                              # (ROUND_NOTES round 2).
    global_ba: bool = True    # final global bundle adjustment over the
                              # stitched+pose-graph-refined trajectory
                              # (sfm/global_refine.py — COLMAP's global-BA
                              # analogue; the round-4 7%-drift fix)
    seed: int = 0
    verbose: bool = False
    parallel_windows: int = 1  # >1: reconstruct this many windows
                               # concurrently in threads on the one
                               # device (windows are independent; only
                               # stitching is order-dependent)


def _poses_to_T(rec, frames):
    """Registered frames -> dict frame -> 4x4 cam->world."""
    out = {}
    for f in frames:
        R, t = rec.poses[f]
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        out[f] = T
    return out


def _similarity_from_pose_pairs(src_Ts, dst_Ts):
    """Similarity (s, R, t) aligning src poses onto dst.

    The ROTATION comes from the chordal mean of the per-frame rotation
    deltas (dst_R src_R^T), never from camera centers: center-based
    umeyama leaves the roll about the path direction unobservable when
    the shared centers are (near-)collinear — which is every straight
    stretch of a driving sequence. Measured on the 500-frame s00 run:
    every stitch seam (frame 4 mod 7) carried a relative-rotation error
    up to 170 deg from exactly this degeneracy, and those ~70 broken
    seams WERE the "drift". Scale is the center-spread least-squares fit
    (unit when fewer than 2 distinct centers — metric depth-prior
    windows stitch at 1 anyway); translation aligns the centroids."""
    src_c = np.stack([T[:3, 3] for T in src_Ts])
    dst_c = np.stack([T[:3, 3] for T in dst_Ts])
    # chordal rotation averaging: R = argmax tr(R^T A), A = sum(dst src^T)
    A = np.zeros((3, 3))
    for s_T, d_T in zip(src_Ts, dst_Ts):
        A += d_T[:3, :3] @ s_T[:3, :3].T
    U, _, Vt = np.linalg.svd(A)
    R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    sb = src_c.mean(axis=0)
    db = dst_c.mean(axis=0)
    src_d = src_c - sb
    dst_d = dst_c - db
    src_spread = float(np.sum(src_d * src_d))
    dst_spread = float(np.sum(dst_d * dst_d))
    if (src_spread > 1e-10) != (dst_spread > 1e-10):
        # one side moved, the other claims stationary: inconsistent
        # anchor data — refuse (caller keeps the window pending)
        return None
    if src_spread > 1e-10:
        # least-squares scale given R: sum<dst_d, R src_d> / sum|src_d|^2
        s = float(np.sum(dst_d * (src_d @ R.T)) / src_spread)
        if s <= 1e-6:
            return None  # pathological anti-aligned fit
    else:
        s = 1.0  # both stationary: rigid attach (metric windows)
    t = db - s * R @ sb
    return s, R, t


def _detect_sequence(images: np.ndarray, max_keypoints: int, chunk: int = 16, device=None):
    """Detect and describe the whole sequence once, ``chunk`` frames per
    batched call on the device, each chunk's result moved to the host
    once. Windows overlap and loop closure needs every frame, so detecting
    per window would run the front end ~2.5x per frame. Returns
    (Keypoints (F, ...), descs (F, K, D)) as host arrays."""
    dev = resolve_device(device)
    parts = []
    for s in range(0, images.shape[0], chunk):
        sub = torch.as_tensor(np.asarray(images[s:s + chunk], np.float32), device=dev)
        kps, descs = detect_and_describe(sub, max_keypoints=max_keypoints, upright=True)
        parts.append((tuple(x.cpu().numpy() for x in kps), descs.cpu().numpy()))
    kps = Keypoints(*(np.concatenate(xs) for xs in zip(*[p[0] for p in parts])))
    descs = np.concatenate([p[1] for p in parts])
    return kps, descs


def _allgather_window_locals(window_locals, my_windows, window_size):
    """Exchange per-window pose dicts across processes: pack each process's
    windows into fixed-shape arrays (-1-padded, poses as float32, as the
    reference packs them), gather, and unpack into the global window order.
    A tiny payload (frames x 4x4 per window): the reconstructions never
    leave their process."""
    n_windows = len(window_locals)
    # every process packs the same wmax (the gather needs one shape)
    wmax = -(-n_windows // process_count())
    widx = np.full(wmax, -1, np.int32)
    fids = np.full((wmax, window_size), -1, np.int32)
    mats = np.zeros((wmax, window_size, 4, 4), np.float32)
    for row, w in enumerate(my_windows):
        local = window_locals[w]
        if local is None:
            continue
        widx[row] = w
        for col, (f, T) in enumerate(sorted(local.items())):
            fids[row, col] = f
            mats[row, col] = T
    g_widx, g_fids, g_mats = (process_allgather(a) for a in (widx, fids, mats))
    out = [None] * n_windows
    for pi in range(g_widx.shape[0]):
        for row in range(wmax):
            w = int(g_widx[pi, row])
            if w < 0:
                continue
            local = {}
            for col in range(window_size):
                f = int(g_fids[pi, row, col])
                if f >= 0:
                    local[f] = np.asarray(g_mats[pi, row, col], np.float64)
            if local:
                out[w] = local
    return out


def run_windowed_sfm(
    images: np.ndarray,   # (F, H, W) grayscale float [0,1]
    K: np.ndarray,
    cfg: KittiRunConfig = None,
    depth_maps: np.ndarray | None = None,  # (F, H, W) metric depth: windows
                                           # run with BA depth priors ->
                                           # metric trajectory, unit stitch
                                           # scales, metric closures
    debug_state: dict | None = None,  # pass a dict to receive the
                                      # intermediate state (stitched Ts,
                                      # window_edges, closures, features)
                                      # and the wall seconds per stage
    device=None,
):
    """Reconstruct a long sequence window by window on ``device`` (None
    means the card), stitched into one trajectory. Returns (Ts (F, 4, 4)
    cam->world | None per missing frame, list of per-window
    reconstructions)."""
    cfg = cfg or KittiRunConfig()
    dev = resolve_device(device)
    seconds = {s: 0.0 for s in STAGES}
    clock = time.perf_counter()

    def lap(stage):
        nonlocal clock
        now = time.perf_counter()
        seconds[stage] += now - clock
        clock = now

    F = images.shape[0]
    kps_all, descs_all = _detect_sequence(images, cfg.max_keypoints, device=dev)
    lap("detect")
    global_T: dict[int, np.ndarray] = {}
    pending: list = []       # windows awaiting stitchable shared frames
    window_edges: list = []  # (f1, f2, T_rel_window_scale, stitch_scale)
    recs = []

    # window starts are known up front: reconstructions are mutually
    # independent; only the stitching pass below is order-dependent
    starts = []
    s = 0
    while s < F - 1:
        starts.append(s)
        if min(s + cfg.window, F) >= F:
            break
        s += cfg.stride

    def _reconstruct(widx):
        start = starts[widx]
        end = min(start + cfg.window, F)
        feats = (Keypoints(*(a[start:end] for a in kps_all)), descs_all[start:end])
        try:
            return run_sfm(
                images[start:end], K,
                max_keypoints=cfg.max_keypoints,
                overlap=cfg.overlap_matches,
                seed=cfg.seed + widx, verbose=cfg.verbose,
                features=feats,
                depth_maps=None if depth_maps is None else depth_maps[start:end],
                device=dev,
            )
        except ValueError as e:
            # a window that cannot initialize must not kill the sequence —
            # later windows overlap it and cover its frames
            if cfg.verbose:
                print(f"[kitti] window at {start} failed: {e}")
            return None

    # window-sharded multi-process SfM: each process reconstructs its
    # contiguous slice of windows (all of them in one process); the
    # per-window pose dicts (tiny) are exchanged so every process runs the
    # identical stitch. `recs` holds only this process's reconstructions.
    my_windows = range(*process_slice(len(starts)).indices(len(starts)))
    window_recs = [None] * len(starts)
    if cfg.parallel_windows > 1:
        # windows in threads on the one device: PyTorch releases the GIL in
        # its ops, so the host work of different windows interleaves. One
        # full-fp32 scope around the pool keeps every thread's nested scope
        # restoring full fp32.
        import concurrent.futures as cf

        with fp.ieee_fp32(), cf.ThreadPoolExecutor(cfg.parallel_windows) as ex:
            for w, rec in zip(my_windows, ex.map(_reconstruct, my_windows)):
                window_recs[w] = rec
    else:
        for w in my_windows:
            window_recs[w] = _reconstruct(w)
    lap("windows")

    window_locals = [None] * len(starts)
    for widx in my_windows:
        rec = window_recs[widx]
        if rec is None:
            continue
        recs.append(rec)
        local = _poses_to_T(rec, rec.registered_frames())
        window_locals[widx] = {starts[widx] + f: T for f, T in local.items()}
    if process_count() > 1:
        window_locals = _allgather_window_locals(window_locals, list(my_windows), cfg.window)

    # order-dependent stitching pass (cheap host math)
    for widx, local in enumerate(window_locals):
        if local is None:
            continue

        stitched, stitch_scale = _try_stitch(global_T, local, cfg)
        if not stitched:
            pending.append(local)
        else:
            # odometry edges from this window (consecutive registered
            # frames), with the stitch scale mapping them to global units
            loc_frames = sorted(local)
            for f1, f2 in zip(loc_frames[:-1], loc_frames[1:]):
                T_rel = np.linalg.inv(local[f1]) @ local[f2]
                window_edges.append((f1, f2, T_rel, stitch_scale))
    lap("stitch")

    Ts = [global_T.get(f) for f in range(F)]
    closures = []
    if cfg.loop_closure:
        closure_edges, closures = _closure_edges(
            (kps_all, descs_all), K, Ts, cfg, depth_maps=depth_maps, device=dev)

        def unlock_shared() -> bool:
            # retry stitching disconnected segments against the updated
            # global frame (each stitched window may unlock the next)
            any_prog = False
            progress = True
            while progress and pending:
                progress = False
                for local in list(pending):
                    stitched, scale = _try_stitch(global_T, local, cfg)
                    if stitched:
                        pending.remove(local)
                        progress = any_prog = True
                        loc_frames = sorted(local)
                        for f1, f2 in zip(loc_frames[:-1], loc_frames[1:]):
                            T_rel = np.linalg.inv(local[f1]) @ local[f2]
                            window_edges.append((f1, f2, T_rel, scale))
                        if cfg.verbose:
                            print(f"[kitti] relocalization unlocked window "
                                  f"{min(local)}..{max(local)}")
            return any_prog

        Ts = _relocalize(Ts, closures, cfg, K=K, depth_maps=depth_maps)
        for f, T in enumerate(Ts):
            if T is not None:
                global_T[f] = T
        unlock_shared()
        # bridge odometry gaps: a single track break inside one window
        # leaves every LATER window fully reconstructed but pending (the
        # stitch chain is broken and mid-loop frames have no revisits for
        # relocalization). Directly match across the small frame gap
        # between the anchored trajectory and each pending window,
        # metricize the baseline from depth priors, attach rigidly.
        while _bridge_pending(global_T, pending, (kps_all, descs_all), K,
                              depth_maps, cfg, window_edges, device=dev):
            unlock_shared()
        Ts = [global_T.get(f) for f in range(F)]
        window_edges += closure_edges
        lap("loop_closure")
    if debug_state is not None:
        debug_state.update(
            stitched_Ts=[None if T is None else T.copy() for T in Ts],
            window_edges=list(window_edges),
            closures=closures,
            features=(kps_all, descs_all),
            seconds=seconds,
            window_seconds=[None if r is None else dict(r.seconds) for r in window_recs])
    if cfg.pose_graph:
        Ts = _refine_with_pose_graph(Ts, window_edges, verbose=cfg.verbose, device=dev)
        lap("pose_graph")
    if cfg.global_ba:
        from tpu3drec_torch.sfm.global_refine import global_bundle_adjust

        ba_Ts = global_bundle_adjust(
            Ts, (kps_all, descs_all), K, depth_maps=depth_maps,
            closures=closures if cfg.loop_closure else None,
            verbose=cfg.verbose, device=dev)
        # acceptance guard: global BA optimizes reprojection, which does
        # not see trajectory shape — at long-sequence scale a truncated-CG
        # step can cut reprojection cost while BENDING the trajectory. The
        # window odometry edges are independent measurements; a BA result
        # that contradicts them is rejected, keeping the pose-graph
        # trajectory.
        before = _edge_consistency(Ts, window_edges)
        after = _edge_consistency(ba_Ts, window_edges)
        if after <= max(1.5 * before, before + 0.05):
            Ts = ba_Ts
        elif cfg.verbose:
            print(f"[kitti] global BA rejected: odometry-edge consistency "
                  f"{before:.3f} -> {after:.3f}")
        lap("global_ba")
    return Ts, recs


def _edge_consistency(Ts, window_edges) -> float:
    """Median robust residual of the ODOMETRY edges against a candidate
    trajectory (rotation priced at 10x like the pose graph). The
    acceptance metric for refinement stages — independent of ground
    truth, cheap, and sensitive to exactly the failure mode reprojection
    cost cannot see (local trajectory bending)."""
    from scipy.spatial.transform import Rotation as ScipyR

    res = []
    for e in window_edges:
        if len(e) > 4 and e[4] == "closure":
            continue
        f1, f2, T_rel, s_w = e[:4]
        if (Ts[f1] is None or Ts[f2] is None
                or not (np.isfinite(Ts[f1]).all()
                        and np.isfinite(Ts[f2]).all()
                        and np.isfinite(T_rel).all())):
            continue
        Tr = T_rel.copy()
        Tr[:3, 3] *= s_w
        M = np.linalg.inv(Tr) @ np.linalg.inv(Ts[f1]) @ Ts[f2]
        rot = np.linalg.norm(ScipyR.from_matrix(M[:3, :3]).as_rotvec())
        res.append(10.0 * rot + float(np.linalg.norm(M[:3, 3])))
    # MEAN, not median/p90: BA damage is concentrated (a few frames off
    # by 27-250 m among ~2 m moves — measured on s00/500). The median
    # misses it entirely and p90 barely moves (0.022 -> 0.053), while
    # the mean separates 130x (0.011 -> 1.42). Genuinely noisy seams are
    # bounded (~0.2) and cannot fake a catastrophic mean.
    return float(np.mean(res)) if res else float("inf")


def _try_stitch(global_T: dict, local: dict, cfg) -> tuple[bool, float]:
    """Stitch a window's local poses into the global frame via shared
    frames. Returns (stitched, scale). The first window defines the frame."""
    if not global_T:
        global_T.update(local)
        return True, 1.0
    shared = sorted(set(local) & set(global_T))
    if len(shared) < 2:
        if cfg.verbose:
            print(f"[kitti] window {min(local)}..{max(local)}: "
                  f"<2 shared frames, pending")
        return False, 1.0
    sim = _similarity_from_pose_pairs(
        [local[f] for f in shared], [global_T[f] for f in shared]
    )
    if sim is None:  # degenerate 2-anchor geometry: keep pending
        if cfg.verbose:
            print(f"[kitti] window {min(local)}..{max(local)}: "
                  f"degenerate 2-anchor stitch, pending")
        return False, 1.0
    s, R, t = sim
    # scale sanity: a near-stationary anchor set (all shared centers within
    # noise of each other) makes the similarity scale 0/eps or eps/0 and a
    # single accepted stitch then poisons the whole trajectory with
    # inf/NaN poses downstream. Depth-prior runs should stitch near unit
    # scale; even without priors, 1e3 off means the anchors carried no
    # baseline. Keep the window pending — a later (longer-baseline) shared
    # set usually unlocks it.
    if not np.isfinite(s) or not (1e-3 < s < 1e3) or not np.isfinite(t).all():
        if cfg.verbose:
            print(f"[kitti] window {min(local)}..{max(local)}: "
                  f"stitch scale {s:.2e} rejected, pending")
        return False, 1.0
    S = np.eye(4)
    S[:3, :3] = s * R
    S[:3, 3] = t
    for f, T in local.items():
        if f in global_T:
            continue
        Tg = S @ T
        # renormalize the rotation block (similarity scales it)
        U, _, Vt = np.linalg.svd(Tg[:3, :3])
        Tg[:3, :3] = U @ Vt
        global_T[f] = Tg
    return True, float(s)


def closure_metric_magnitude(c, K: np.ndarray,
                             depth_maps: np.ndarray) -> float | None:
    """Metric translation magnitude of a verified closure from depth priors.

    The two-view geometry fixes (R_rel, t_dir) up to scale. Triangulating
    the inlier correspondences with a UNIT baseline gives each match a
    depth z_unit proportional to the true one: z_metric = |t| * z_unit.
    With a metric depth map for frame i (the same prior BA consumes,
    `sfm/ba.py` depth rows), |t| = median(depth(u,v) / z_unit) — closure
    edges get MEASURED metric translation instead of the drifted estimate
    (the round-1 gap: `VERDICT.md` item 5).

    Returns None when too few matches carry usable depth (caller falls
    back to the estimate-derived magnitude)."""
    from tpu3drec_torch.sfm.triangulate import triangulate_two_view_np

    if len(c.uv_i) < 5:
        return None
    # host numpy, as in the reference: a few dozen matches per closure
    Kn = np.asarray(K, np.float32)
    P1 = Kn @ np.concatenate([np.eye(3, dtype=np.float32),
                              np.zeros((3, 1), np.float32)], axis=1)
    P2 = Kn @ np.concatenate([np.asarray(c.R_rel, np.float32),
                              np.asarray(c.t_dir, np.float32)[:, None]], axis=1)
    X = triangulate_two_view_np(P1, P2, c.uv_i, c.uv_j)
    z_unit = X[:, 2]
    dm = depth_maps[c.i]
    H, W = dm.shape
    u = np.clip(np.round(c.uv_i[:, 0]).astype(int), 0, W - 1)
    v = np.clip(np.round(c.uv_i[:, 1]).astype(int), 0, H - 1)
    d_met = dm[v, u]
    ok = (z_unit > 1e-6) & (d_met > 1e-6) & np.isfinite(z_unit)
    if ok.sum() < 5:
        return None
    mag = float(np.median(d_met[ok] / z_unit[ok]))
    # sanity: a near-zero unit-baseline depth (degenerate triangulation)
    # inflates the ratio without bound; a kilometre-scale closure
    # translation is never real on these workloads
    if not np.isfinite(mag) or mag > 1e4:
        return None
    return mag


def _relocalize(Ts, closures, cfg, K=None, depth_maps=None):
    """Anchor frames the sequential stitcher could not place using verified
    closures to localized frames (re-localization).

    With metric depth priors the full relative pose is observable: the
    revisited frame is placed at partner_T @ T_rel with the measured
    rotation AND the depth-recovered metric translation
    (closure_metric_magnitude) — a revisit offset by metres lands at its
    true pose. Without depth (pure monocular) the magnitude is
    unobservable and the frame is placed at the partner's center with the
    measured relative rotation (exact only for true revisits).

    PARTNER DIVERSITY: each localized partner anchors at most one frame
    (first pass); a partner is reused only for frames nothing else can
    anchor (second pass). In the monocular path two frames anchored at
    the SAME partner's center coincide, and the pending-window re-stitch
    then computes its scale from the distance between coincident anchors
    — a measured whole-tail scale collapse on the occluded orbit. Anchors
    at distinct partners inherit the partners' true spacing, which for
    revisits matches the anchored frames' spacing."""
    out = list(Ts)
    used_partners: set = set()

    def place(c, allow_reuse: bool) -> None:
        a, b = c.i, c.j
        if out[a] is not None and out[b] is None:
            partner, target, invert = a, b, False
        elif out[b] is not None and out[a] is None:
            partner, target, invert = b, a, True
        else:
            return
        if not allow_reuse and partner in used_partners:
            return
        if not np.isfinite(out[partner]).all():
            return  # never anchor to a poisoned pose
        mag = 0.0
        if depth_maps is not None and K is not None:
            m = closure_metric_magnitude(c, K, depth_maps)
            if m is not None:
                mag = m
        # T maps cam_b coords -> cam_a coords (see _closure_edges)
        Rba = c.R_rel.T
        tba = -Rba @ (c.t_dir * mag)
        T = np.eye(4)
        if invert:
            T[:3, :3] = Rba.T
            T[:3, 3] = -Rba.T @ tba
        else:
            T[:3, :3] = Rba
            T[:3, 3] = tba
        out[target] = out[partner] @ T
        used_partners.add(partner)
        if cfg.verbose:
            print(f"[kitti] relocalized frame {target} via closure to "
                  f"{partner} (|t|={mag:.2f})")

    for c in closures:          # pass 1: distinct partners only
        place(c, allow_reuse=False)
    for c in closures:          # pass 2: whatever remains
        place(c, allow_reuse=True)
    return out


def _bridge_pending(global_T, pending, features, K, depth_maps, cfg,
                    window_edges, max_gap: int = 4,
                    min_inliers: int = 20, device=None) -> bool:
    """Anchor pending windows across small odometry gaps.

    A pending window is fully reconstructed but shares <2 frames with the
    anchored trajectory (its predecessor broke mid-window). Its boundary
    frames are only a few frames away from anchored ones — directly
    match such (anchored g, pending s) pairs, verify with two-view
    RANSAC, recover the metric baseline from depth priors
    (closure_metric_magnitude), place s, and attach the whole window
    RIGIDLY (depth-prior windows are metric, so the stitch scale is 1 by
    construction). The bridge pair also becomes a pose-graph edge
    (closure class: its error model is two-view, not odometry).

    Returns True if any window was attached (caller re-runs the pending
    re-stitch loop — each attachment may unlock the next window by
    normal shared-frame stitching). Monocular runs (no depth) skip
    bridging: a single pair cannot metricize the attachment scale.
    """
    if depth_maps is None or not pending:
        return False
    import types

    from tpu3drec_torch.sfm.matching import match_pairs
    from tpu3drec_torch.sfm.twoview import estimate_relative_pose

    dev = resolve_device(device)
    kps, descs = features
    xy = np.asarray(kps.xy)
    descs_d = torch.as_tensor(descs, dtype=torch.float32, device=dev)
    valid_d = torch.as_tensor(kps.valid, dtype=torch.bool, device=dev)
    K_d = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    bridged = False
    for local in list(pending):
        anchored = {f for f, T in global_T.items() if np.isfinite(T).all()}
        cands = sorted(
            (abs(g - s), g, s)
            for s in local
            for g in range(s - max_gap, s + max_gap + 1)
            if g in anchored and g not in local)
        placed = None
        for rank, (_, g, s) in enumerate(cands[:6]):
            m = match_pairs(descs_d, valid_d, np.asarray([[g, s]], np.int32))
            sel = m.valid[0].cpu().numpy()
            if sel.sum() < min_inliers:
                continue
            uv1 = np.zeros((xy.shape[1], 2), np.float32)
            uv2 = np.zeros((xy.shape[1], 2), np.float32)
            vmask = np.zeros(xy.shape[1], bool)
            n = int(sel.sum())
            uv1[:n] = xy[g, m.idx_a[0].cpu().numpy()[sel]]
            uv2[:n] = xy[s, m.idx_b[0].cpu().numpy()[sel]]
            vmask[:n] = True
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg.seed + 7919 * g + s)
            tv = estimate_relative_pose(
                torch.as_tensor(uv1, device=dev), torch.as_tensor(uv2, device=dev),
                torch.as_tensor(vmask, device=dev), K_d, gen)
            if int(tv.n_inliers) < min_inliers:
                continue
            inl = tv.inliers.cpu().numpy()[:n]
            c = types.SimpleNamespace(
                i=g, j=s, R_rel=tv.R.cpu().numpy(), t_dir=tv.t.cpu().numpy(),
                uv_i=uv1[:n][inl], uv_j=uv2[:n][inl],
                n_inliers=int(tv.n_inliers))
            mag = closure_metric_magnitude(c, K, depth_maps)
            if mag is None:
                continue
            Rba = c.R_rel.T
            tba = -Rba @ (c.t_dir * mag)
            T_rel = np.eye(4)
            T_rel[:3, :3] = Rba
            T_rel[:3, 3] = tba
            T_s = global_T[g] @ T_rel
            placed = (g, s, T_rel, T_s)
            break
        if placed is None:
            continue
        g, s, T_rel, T_s = placed
        S = T_s @ np.linalg.inv(local[s])
        if not np.isfinite(S).all():
            continue
        for f, T in local.items():
            if f not in global_T:
                Tg = S @ T
                U, _, Vt = np.linalg.svd(Tg[:3, :3])
                Tg[:3, :3] = U @ Vt
                global_T[f] = Tg
        loc_frames = sorted(local)
        for f1, f2 in zip(loc_frames[:-1], loc_frames[1:]):
            window_edges.append(
                (f1, f2, np.linalg.inv(local[f1]) @ local[f2], 1.0))
        window_edges.append((g, s, T_rel, 1.0, "closure"))
        pending.remove(local)
        bridged = True
        if cfg.verbose:
            print(f"[kitti] bridged gap {g}->{s}: window "
                  f"{min(local)}..{max(local)} attached (|t|={mag:.2f})")
    return bridged


def _closure_edges(features, K, Ts, cfg, depth_maps=None, device=None):
    """Detect loop closures over the whole sequence and convert them to
    pose-graph edges (SURVEY C3: COLMAP's vocab-tree loop detection).
    ``features`` is the sequence-level (Keypoints, descs) pair detected
    once by `run_windowed_sfm` (no re-detection).

    Closure rotation + bearing come from the verified two-view geometry.
    The translation magnitude is MEASURED from depth priors when available
    (closure_metric_magnitude — same priors BA consumes); only the pure-
    monocular path falls back to the current (drifted) stitched estimate."""
    from tpu3drec_torch.sfm.loopclosure import detect_loop_closures

    kps, descs = features
    closures = detect_loop_closures(
        descs, kps.valid, np.asarray(kps.xy), K,
        min_gap=cfg.lc_min_gap, sim_threshold=cfg.lc_sim, seed=cfg.seed,
        method=cfg.lc_method, device=device,
    )
    edges = []
    for c in closures:
        if Ts[c.i] is None or Ts[c.j] is None:
            continue  # edge needs both localized; relocalization handles rest
        dist = None
        src = "depth"
        if depth_maps is not None:
            dist = closure_metric_magnitude(c, K, depth_maps)
        if dist is None:
            dist = float(np.linalg.norm(Ts[c.j][:3, 3] - Ts[c.i][:3, 3]))
            src = "estimate"
        T_rel = np.eye(4)
        T_rel[:3, :3] = c.R_rel.T
        T_rel[:3, 3] = -c.R_rel.T @ (c.t_dir * dist)
        # tagged "closure": the pose-graph refiner must NOT gate these on
        # their initial residual — that residual is the drift they remove
        edges.append((c.i, c.j, T_rel, 1.0, "closure"))
        if cfg.verbose:
            print(f"[kitti] loop closure {c.i}<->{c.j} "
                  f"({c.n_inliers} inliers, |t| {dist:.2f} from {src})")
    return edges, closures


def _distribute_closure_error(Ts, window_edges, verbose: bool = False):
    """Closure-guided chain relaxation: the GN initializer for big loops.

    A long stitched chain can arrive with an ENORMOUS loop-closing error
    (measured on the 500-frame city block: the revisit frames sat 110 m
    away and rotated 94-175 deg from their closures' prediction). From
    that basin Gauss-Newton cannot converge — the se(3) log map is
    singular at pi, and jacfwd through a near-pi residual is NaN. The
    classic fix (g2o spanning-tree init / ORB-SLAM loop correction):
    pick a closure, compute the world-frame correction D that moves the
    current pose of its far frame onto the closure's prediction, and
    apply D FRACTIONALLY along the chain — identity at the near frame,
    full D at the far frame, slerp in between, rotations anchored at the
    near frame's position so it stays fixed. After relaxation every
    closure residual is small and the switchable pose graph + global BA
    operate in their convergent regime.

    The driving closure is chosen by consensus: each candidate's
    relaxation is scored by the median residual it leaves over ALL
    closure edges (a false closure relaxes the chain to a shape the
    true-closure majority rejects). No-op when the worst closure
    residual is already modest (small-loop / mid-scale runs)."""
    from scipy.spatial.transform import Rotation as ScipyR

    closures = [(f1, f2, T_rel) for e in window_edges
                if len(e) > 4 and e[4] == "closure"
                for (f1, f2, T_rel, s_w) in [e[:4]]
                if Ts[f1] is not None and Ts[f2] is not None
                and np.isfinite(Ts[f1]).all() and np.isfinite(Ts[f2]).all()
                and np.isfinite(T_rel).all()]
    if not closures:
        return Ts
    odo_steps = [np.linalg.norm((np.linalg.inv(Ts[f1]) @ Ts[f2])[:3, 3])
                 for e in window_edges if len(e) <= 4 or e[4] != "closure"
                 for (f1, f2, T_rel, s_w) in [e[:4]]
                 if abs(f2 - f1) == 1 and Ts[f1] is not None
                 and Ts[f2] is not None]
    step = float(np.median(odo_steps)) if odo_steps else 1.0

    def residual_of(T_i, T_j, T_rel):
        M = np.linalg.inv(T_rel) @ np.linalg.inv(T_i) @ T_j
        rot = np.linalg.norm(ScipyR.from_matrix(M[:3, :3]).as_rotvec())
        return rot, float(np.linalg.norm(M[:3, 3]))

    r0 = [residual_of(Ts[i], Ts[j], Tr) for i, j, Tr in closures]
    worst_rot = max(r for r, _ in r0)
    worst_trans = max(t for _, t in r0)
    if worst_rot < np.radians(30.0) and worst_trans < 10.0 * step:
        return Ts  # GN's basin — no relaxation needed

    def relax(i, j, T_rel, Ts):
        lo, hi = (i, j) if i < j else (j, i)
        # desired pose of j given i and the measured closure
        T_j_des = Ts[i] @ T_rel
        D = T_j_des @ np.linalg.inv(Ts[j])        # world-frame correction
        a = Ts[i][:3, 3]                          # anchor: frame i fixed
        R_D = D[:3, :3]
        u = R_D @ a + D[:3, 3] - a                # translation seen at a
        rv = ScipyR.from_matrix(R_D).as_rotvec()
        out = list(Ts)
        for f in range(lo, len(Ts)):
            if out[f] is None or not np.isfinite(out[f]).all():
                continue
            alpha = min(max((f - lo) / max(hi - lo, 1), 0.0), 1.0)
            R_a = ScipyR.from_rotvec(alpha * rv).as_matrix()
            C = np.eye(4)
            C[:3, :3] = R_a
            C[:3, 3] = a - R_a @ a + alpha * u
            out[f] = C @ out[f]
        return out

    best = None
    for k, (i, j, Tr) in enumerate(closures):
        cand = relax(i, j, Tr, Ts)
        med = np.median([residual_of(cand[ii], cand[jj], TT)[1]
                         for ii, jj, TT in closures])
        if best is None or med < best[0]:
            best = (med, k, cand)
    med, k, relaxed = best
    if verbose:
        i, j, _ = closures[k]
        print(f"[kitti] chain relaxation via closure {i}<->{j}: worst "
              f"closure residual {worst_trans:.1f} m/"
              f"{np.degrees(worst_rot):.0f} deg -> median {med:.2f} m")
    return relaxed


def _refine_with_pose_graph(Ts, window_edges, verbose: bool = False, device=None):
    """Pose-graph refinement over the stitched trajectory: every window
    contributes relative-pose edges between its registered frames (overlap
    regions get edges from multiple windows — consensus), optimized with
    Gauss-Newton (`sfm/posegraph.py`). Edge translations are rescaled by
    each window's stitch scale so all measurements share the global scale.

    Edge robustness is CLASS-AWARE (the round-4 accuracy gap, VERDICT r4
    weak 1): odometry edges are locally consistent with the stitched
    initial guess by construction, so an odometry edge far off the guess
    (10x the odometry median) is a mis-registration and is hard-gated as
    before. Loop-closure edges are the OPPOSITE — their initial residual
    IS the accumulated drift they exist to remove (measured on the
    500-frame city block: closure residuals ~28 m against a 0.0004 m
    odometry median; the old class-blind gate zeroed every closure, so
    the graph faithfully reproduced 7.07%-of-trajectory drift). Closures
    are therefore never gated against the initial guess; instead the
    whole graph runs 3 IRLS rounds of Huber reweighting — closures that
    stay inconsistent AFTER the graph has bent toward the consistent
    majority (false positives) lose their weight gradually."""
    dev = resolve_device(device)
    # big-loop initializer: bring enormous closure errors into GN's basin
    # first (see _distribute_closure_error)
    Ts = _distribute_closure_error(Ts, window_edges, verbose=verbose)

    # non-finite poses/edges must not enter the graph: GN's dense solve
    # spreads a single NaN to EVERY pose (measured on the 500-frame city
    # block: one poisoned anchor turned 98.6% coverage into all-NaN output)
    present = [i for i, T in enumerate(Ts)
               if T is not None and np.isfinite(T).all()]
    if len(present) < 3 or not window_edges:
        return Ts
    idx_of = {f: i for i, f in enumerate(present)}

    def to6(Tstack):
        """(N, 4, 4) -> (N, 6) [axis-angle of the float32 rotation | t]."""
        Tstack = np.asarray(Tstack)
        aa = matrix_to_axis_angle(torch.as_tensor(Tstack[:, :3, :3], dtype=torch.float32,
                                                  device=dev)).cpu().numpy()
        return np.concatenate([aa, Tstack[:, :3, 3]], axis=1)

    poses6 = to6(np.stack([Ts[f] for f in present])).astype(np.float32)
    ei, ej, rel, w, is_closure = [], [], [], [], []
    for edge in window_edges:
        f1, f2, T_rel, s_w = edge[:4]
        kind = edge[4] if len(edge) > 4 else "odo"
        if f1 not in idx_of or f2 not in idx_of:
            continue
        if not (np.isfinite(T_rel).all() and np.isfinite(s_w)):
            continue
        Tr = T_rel.copy()
        Tr[:3, 3] *= s_w
        ei.append(idx_of[f1])
        ej.append(idx_of[f2])
        rel.append(Tr)
        w.append(1.0)
        is_closure.append(kind == "closure")
    if len(ei) < 2:
        return Ts
    is_closure = np.asarray(is_closure)
    rel = to6(np.stack(rel))
    g = PoseGraph(
        poses=torch.as_tensor(poses6, device=dev),
        edge_i=torch.as_tensor(ei, dtype=torch.int64, device=dev),
        edge_j=torch.as_tensor(ej, dtype=torch.int64, device=dev),
        rel=torch.as_tensor(rel, dtype=torch.float32, device=dev),
        weight=torch.as_tensor(w, dtype=torch.float32, device=dev),
    )

    # hard gate for ODOMETRY edges only: a single mis-registered boundary
    # frame yields an odometry edge with a huge residual that deforms the
    # whole graph under plain GN (measured: one 27.9-norm edge among
    # 0.0004-median edges turned a 0.15 ATE into 1.03)
    r0 = np.linalg.norm(edge_residuals(g.poses, g).cpu().numpy(), axis=1)
    odo = ~is_closure
    if odo.any():
        # gate floor scales with the odometry step: overlapping windows'
        # duplicate edges agree to ~1e-4, so 10x their residual median is
        # meaninglessly tight — an absolute 0.05 m floor gated 17
        # LEGITIMATE overlap edges on the m00 loop and the optimizer
        # dumped the whole loop correction into the freed junctions
        # (64 m jumps). A real mis-registration is off by a sizable
        # fraction of the inter-frame step; smaller disagreements are
        # information, not outliers.
        step = np.median([np.linalg.norm(rel[k][3:])
                          for k in range(len(rel)) if odo[k]])
        gate = max(10.0 * np.median(r0[odo]), 0.5 * step, 0.05)
        w_robust = np.where(odo & (r0 >= gate), 0.0, 1.0).astype(np.float32)
    else:
        w_robust = np.ones(len(r0), np.float32)
    if w_robust.sum() < 2:
        return Ts

    # CONNECTIVITY REPAIR: hard-gating must never disconnect the graph.
    # A free node whose every edge is zero-weighted is constrained only
    # by the 1e-6 damping and flies off to ~1e13 in one GN step (measured
    # on m00: 17 gated overlap edges cut frames 18-33 loose; the
    # scale-aligned ATE then collapses the whole trajectory to a point
    # and reads as a uniform ~16 m error). Restore gated edges in
    # ascending-residual order wherever they reconnect components
    # (spanning-tree repair); freeze any node still unreachable from the
    # gauge so it keeps its stitched pose instead of exploding.
    nF = len(present)
    parent = list(range(nF))

    def _find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def _union(a, b):
        ra, rb = _find(a), _find(b)
        if ra != rb:
            parent[rb] = ra

    # ODOMETRY-ONLY union: closures are hypotheses (their switches may
    # collapse), not structural links. Counting them here left a gated
    # junction "connected" the long way around the loop, and the
    # optimizer then hinged the whole trajectory at that junction.
    for k in range(len(ei)):
        if w_robust[k] > 0 and not is_closure[k]:
            _union(ei[k], ej[k])
    n_restored = 0
    for k in np.argsort(r0):
        if is_closure[k]:
            continue
        if w_robust[k] == 0 and _find(ei[k]) != _find(ej[k]):
            w_robust[k] = 1.0
            _union(ei[k], ej[k])
            n_restored += 1
    root0 = _find(0)
    node_free = np.array(
        [1.0 if (_find(i) == root0 and i != 0) else 0.0
         for i in range(nF)], np.float32)
    if verbose:
        print(f"[kitti] pose graph: {int(odo.sum())} odometry + "
              f"{int(is_closure.sum())} closure edges, "
              f"{int((w_robust == 0).sum())} gated "
              f"({n_restored} restored for connectivity, "
              f"{int((node_free == 0).sum()) - 1} nodes frozen)")
        worst = np.argsort(r0)[::-1][:10]
        for k in worst:
            print(f"[kitti]   edge {present[ei[k]]}->{present[ej[k]]} "
                  f"r0={r0[k]:.3f} w={w_robust[k]:.0f} "
                  f"{'closure' if is_closure[k] else 'odo'}")

    g = g._replace(weight=torch.as_tensor(w_robust, device=dev))
    if is_closure.any():
        # switchable constraints (posegraph.py): closures are priced by
        # the optimizer itself — true closures stay on (their drift
        # redistributes cheaply over the whole odometry chain), false
        # ones collapse to switch 0 instead of folding the trajectory
        poses_cur, switches, _ = optimize_pose_graph_switchable(
            g, torch.as_tensor(is_closure, device=dev), iters=15, rot_weight=10.0,
            fix_node_mask=torch.as_tensor(node_free, device=dev), device=dev)
        if verbose:
            sw = switches.cpu().numpy()[is_closure]
            print(f"[kitti] pose graph switches: "
                  f"{int((sw > 0.5).sum())}/{len(sw)} closures kept "
                  f"(min {sw.min():.2f})")
    else:
        poses_cur, _ = optimize_pose_graph(
            g, iters=10, rot_weight=10.0,
            fix_node_mask=torch.as_tensor(node_free, device=dev), device=dev)
    opt = poses_cur.cpu().numpy()
    if not np.isfinite(opt).all():
        return Ts  # a diverged solve must not poison the trajectory
    # post-solve sanity: a pose that moved further than the whole
    # trajectory span did not converge — keep its input (a kink the
    # global BA can still repair beats a runaway coordinate)
    span = float(np.ptp(poses6[:, 3:], axis=0).max()) + 1.0
    moved = np.linalg.norm(opt[:, 3:] - poses6[:, 3:], axis=1)
    runaway = moved > 10.0 * span
    if runaway.any():
        if verbose:
            print(f"[kitti] pose graph: {int(runaway.sum())} runaway "
                  "poses reverted to stitched values")
        opt[runaway] = poses6[runaway]

    Rs = axis_angle_to_matrix(torch.as_tensor(opt[:, :3], device=dev)).cpu().numpy()
    out = list(Ts)
    for f, i in idx_of.items():
        T = np.eye(4)
        T[:3, :3] = Rs[i]
        T[:3, 3] = opt[i, 3:]
        out[f] = T
    return out


def evaluate_sequence(Ts, gt_T: np.ndarray):
    """ATE/RPE of the stitched trajectory vs ground truth (frames missing
    from the reconstruction are skipped; non-finite poses — e.g. from a
    degenerate stitch scale — count as missing rather than poisoning the
    whole metric with NaN)."""
    sel = [i for i, T in enumerate(Ts)
           if T is not None and np.isfinite(T).all()]
    if len(sel) < 3:
        return {
            "ate_rms": float("inf"), "rpe_trans": float("inf"),
            "rpe_rot": float("inf"), "coverage": len(sel) / max(len(Ts), 1),
            "traj_len": trajectory_length(gt_T[:, :3, 3]),
        }
    est_c = np.stack([Ts[i][:3, 3] for i in sel])
    gt_c = gt_T[sel][:, :3, 3]
    ate_rms, aligned, sim = ate(est_c, gt_c)
    t_rpe, r_rpe = rpe(np.stack([Ts[i] for i in sel]), gt_T[sel])
    return {
        "ate_rms": ate_rms,
        "rpe_trans": t_rpe,
        "rpe_rot": r_rpe,
        "coverage": len(sel) / len(Ts),
        "traj_len": trajectory_length(gt_c),
    }
