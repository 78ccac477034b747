"""Long-sequence ATE run of the PyTorch/CUDA port: one synthetic
KITTI-layout sequence through `tpu3drec_torch.pipelines.kitti`.

The sequences are those of `tools/ate_benchmark.py` (the JAX package's
benchmark), rebuilt here on `tpu3drec_torch` alone: a ray-cast urban block
(`data/capture_sim.py::PlanarScene`) driven around by a camera at 640x192
with KITTI's intrinsics scaled, per-frame exposure jitter and sensor noise,
and noisy sparse metric depth priors. The frames equal the benchmark's bit
for bit, with its optional `degrade` stack too (`--degrade`: motion blur,
defocus, vignetting, exposure jitter and sensor noise of
`tpu3drec_torch/data/degrade.py`, drawn from the benchmark's generator).
Frames are ray-cast in parallel worker processes; the noise is then drawn
serially in frame order, as the benchmark draws it.

With ``--nproc N`` the windows are split over N processes, as the
benchmark's ``--nproc`` does (`pipelines/kitti.py`'s window split over a
process group): this process renders the frames once, then starts N
processes on one coordinator (all on the one card, or ``--device``), each
reconstructs its slice of the windows, the window poses are exchanged, and
process 0 writes the row; the processes have NPROC_TIMEOUT_S seconds.
``--hold`` records every launch of the batched matcher kernel in the run
(each process's, with ``--nproc``) and holds each against the kernel's
plain version on the same inputs, bit for bit; with ``--nproc`` it also
holds the window-pose exchange to its inputs: each window a process
reconstructed comes back in its own slot with its own frames and the
float32 rounding of its poses, bit for bit, and every process holds the
same exchanged poses. The row then gives each process's launches, largest
difference and exchanged windows.

Usage:
  python tools/ate_torch.py --seq m00 --frames 150            # on the card
  python tools/ate_torch.py --seq m00 --frames 16 --device cpu
  python tools/ate_torch.py --seq m00 --frames 150 --out ate_m00.json
  python tools/ate_torch.py --seq m00 --frames 150 --degrade
  python tools/ate_torch.py --seq m00 --frames 150 --nproc 2
  python tools/ate_torch.py --frames-from frames.npz --nproc 2  # frames saved by --save-frames
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# seconds for the N processes of ``--nproc`` (m00/150 on 2 processes
# takes ~1-1.5 minutes on an H100)
NPROC_TIMEOUT_S = 900

# KITTI-like geometry at half resolution
WIDTH, HEIGHT = 640, 192
FX = 718.856 / 1241.0 * WIDTH   # KITTI seq-00 P0 scaled
FY = 718.856 / 376.0 * HEIGHT
CX, CY = 0.489 * WIDTH, 0.493 * HEIGHT

SEQ_LAYOUTS = {
    # name -> (scene seed, n_boxes, block half-extents (x, z) in metres
    #          [, corner radius as a fraction of min extent])
    "s00": (11, 26, (42.0, 60.0)),
    "s01": (23, 32, (55.0, 40.0)),
    "s02": (37, 22, (35.0, 35.0)),
    # mid-scale loop: a small block with a wide corner radius, so that 150
    # frames keep the per-frame spacing (~0.7 m) and corner yaw rate
    # (~3 deg/frame) of the 500-frame s00 run
    "m00": (11, 30, (16.0, 16.0), 0.8),
}


def city_block_trajectory(n_frames: int, ext_x: float, ext_z: float,
                          speed: float = 1.06, corner_frac: float = 0.35):
    """Rounded-rectangle drive returning to the start: four straights and
    four 90-degree turns (world->cam (R, t) pairs, KITTI convention: x
    right, y down, z forward). The path parameter wraps by the true
    perimeter, so every frame advances uniformly and ``speed`` > 1
    revisits the start for loop closure."""
    from scipy.spatial.transform import Rotation as ScipyR

    r = min(ext_x, ext_z) * corner_frac
    sx, sz = ext_x - r, ext_z - r

    def _corner(u, r, c, phi0):
        a = phi0 + u / r
        p = np.array([c[0] + r * np.cos(a), c[1] + r * np.sin(a)])
        return p, a + np.pi / 2

    # walk the rounded rectangle counterclockwise from (-sx, -ext_z)
    segs = [
        (2 * sx, lambda u: (np.array([-sx + u, -ext_z]), 0.0)),
        (np.pi / 2 * r, lambda u: _corner(u, r, (sx, -sz), -np.pi / 2)),
        (2 * sz, lambda u: (np.array([ext_x, -sz + u]), np.pi / 2)),
        (np.pi / 2 * r, lambda u: _corner(u, r, (sx, sz), 0.0)),
        (2 * sx, lambda u: (np.array([sx - u, ext_z]), np.pi)),
        (np.pi / 2 * r, lambda u: _corner(u, r, (-sx, sz), np.pi / 2)),
        (2 * sz, lambda u: (np.array([-ext_x, sz - u]), -np.pi / 2)),
        (np.pi / 2 * r, lambda u: _corner(u, r, (-sx, -sz), np.pi)),
    ]
    per = sum(length for length, _ in segs)
    s_vals = np.linspace(0.0, per, n_frames, endpoint=False)

    def point(s):
        for length, fn in segs:
            if s <= length:
                return fn(s)
            s -= length
        return segs[-1][1](length)

    poses = []
    for s in s_vals * speed % per:
        p, heading = point(float(s))
        # camera looks along +z rotated by heading about y (KITTI frame)
        R = ScipyR.from_rotvec([0.0, -heading, 0.0]).as_matrix()
        C = np.array([p[0], -1.6, p[1]])  # 1.6 m above ground (y down)
        poses.append((R.astype(np.float32), (-R @ C).astype(np.float32)))
    return poses


def build_scene(seed: int, n_boxes: int, ext, corner_frac: float = 0.35):
    """Urban canyon around the block: textured ground and buildings lining
    both sides of the street ring, with an ~8 m corridor kept clear along
    the rounded-rectangle drive path; clearance is measured to a building's
    closest edge."""
    from tpu3drec_torch.data.capture_sim import PlanarScene

    rng = np.random.default_rng(seed)
    ex, ez = ext
    E = max(ex, ez) * 2.0
    mk = PlanarScene._make_quad
    quads = [mk(rng, [-E, 0.0, -E], [2 * E, 0, 0], [0, 0, 2 * E], n_tex=10)]
    r = min(ex, ez) * corner_frac

    def ring_dist(px, pz):
        # unsigned distance to the rounded-rectangle street centerline
        qx, qz = abs(px) - (ex - r), abs(pz) - (ez - r)
        outside = np.hypot(max(qx, 0.0), max(qz, 0.0))
        inside = min(max(qx, qz), 0.0)
        return abs(outside + inside - r)

    placed = 0
    guard = 0
    while placed < n_boxes and guard < 50 * n_boxes:
        guard += 1
        px = rng.uniform(-1.35 * ex, 1.35 * ex)
        pz = rng.uniform(-1.35 * ez, 1.35 * ez)
        d = ring_dist(px, pz)
        w = rng.uniform(4.0, 12.0)
        h = rng.uniform(4.0, 16.0)
        dd = rng.uniform(4.0, 12.0)
        if not (4.0 + max(w, dd) / 2 < d < 26.0):
            continue
        x0, x1 = px - w / 2, px + w / 2
        y0, y1 = -h, 0.0
        z0, z1 = pz - dd / 2, pz + dd / 2
        quads += [
            mk(rng, [x0, y1, z0], [x1 - x0, 0, 0], [0, y0 - y1, 0]),
            mk(rng, [x0, y1, z1], [x1 - x0, 0, 0], [0, y0 - y1, 0]),
            mk(rng, [x0, y1, z0], [0, 0, z1 - z0], [0, y0 - y1, 0]),
            mk(rng, [x1, y1, z0], [0, 0, z1 - z0], [0, y0 - y1, 0]),
            mk(rng, [x0, y0, z0], [x1 - x0, 0, 0], [0, 0, z1 - z0]),
        ]
        placed += 1
    return PlanarScene(quads=quads)


def camera():
    from tpu3drec_torch.utils.config import CameraConfig

    return CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, width=WIDTH, height=HEIGHT)


_scene = None


def _init_worker(scene):
    global _scene
    _scene = scene


def _render(pose):
    R, t = pose
    return _scene.render(R, t, camera(), max_depth=120.0)


def render_sequence(name: str, n_frames: int, workers: int | None = None,
                    degrade: bool = False):
    """The ``n_frames`` noisy frames of sequence ``name`` with their depth
    priors: (images (F,H,W) float32, depths (F,H,W) float32, gt_T (F,4,4)
    float64). ``workers`` processes ray-cast the frames (default: one per
    CPU). ``degrade`` adds the full photometric stack of
    `data/degrade.py` on top, as the benchmark's ``--degrade`` does."""
    layout = SEQ_LAYOUTS[name]
    seed, n_boxes, ext = layout[:3]
    corner_frac = layout[3] if len(layout) > 3 else 0.35
    scene = build_scene(seed, n_boxes, ext, corner_frac=corner_frac)
    poses = city_block_trajectory(n_frames, *ext, corner_frac=corner_frac)
    workers = min(workers or os.cpu_count() or 1, len(poses))
    if workers > 1:
        # spawned workers: the parent may hold a CUDA context, which a
        # forked child must not inherit
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(workers, mp_context=ctx, initializer=_init_worker,
                                    initargs=(scene,)) as ex:
            frames = list(ex.map(_render, poses))
    else:
        _init_worker(scene)
        frames = [_render(p) for p in poses]
    rng = np.random.default_rng(seed + 1)
    images, depths, gt_T = [], [], []
    for (R, t), (rgb, d) in zip(poses, frames):
        g = rgb.mean(-1).astype(np.float32) / 255.0
        # exposure jitter (per-frame gain/bias) + sensor noise
        gain = 1.0 + 0.12 * rng.standard_normal()
        bias = 0.03 * rng.standard_normal()
        g = np.clip(g * gain + bias + 0.01 * rng.standard_normal(g.shape), 0, 1)
        # noisy sparse depth prior: 1% multiplicative noise, 35% dropout
        keep = rng.uniform(size=d.shape) > 0.35
        d = np.where(keep, d * (1 + 0.01 * rng.standard_normal(d.shape)),
                     0.0).astype(np.float32)
        images.append(g.astype(np.float32))
        depths.append(d)
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        gt_T.append(T)
    images = np.stack(images)
    if degrade:
        from tpu3drec_torch.data.degrade import degrade_sequence

        images = degrade_sequence(images, poses, camera(), np.random.default_rng(seed + 2))
    return images, np.stack(depths), np.stack(gt_T).astype(np.float64)


def run_sequence(name: str, n_frames: int, max_keypoints: int = 512, window: int = 12,
                 stride: int = 7, depth_priors: bool = True, workers: int | None = None,
                 device=None, degrade: bool = False, frames=None):
    """Render sequence ``name`` (or take ``frames``, the (images, depths,
    gt_T) of `render_sequence`) and run it through `run_windowed_sfm` on
    ``device`` (None means the card) with the benchmark's settings (loop
    closure, closure gap 30). Returns the metrics of `evaluate_sequence`
    and the seconds of rendering and of each stage, unrounded."""
    from tpu3drec_torch.pipelines.kitti import (
        KittiRunConfig, evaluate_sequence, run_windowed_sfm)

    t0 = time.perf_counter()
    if frames is None:
        images, depths, gt_T = render_sequence(name, n_frames, workers=workers, degrade=degrade)
        render_s = time.perf_counter() - t0
    else:
        (images, depths, gt_T), render_s = frames, None
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    cfg = KittiRunConfig(window=window, stride=stride, max_keypoints=max_keypoints,
                         loop_closure=True, lc_min_gap=30)
    state = {}
    t0 = time.perf_counter()
    Ts, recs = run_windowed_sfm(images, K, cfg, depth_maps=depths if depth_priors else None,
                                debug_state=state, device=device)
    wall = time.perf_counter() - t0
    m = evaluate_sequence(Ts, gt_T)
    m = {k: float(v) for k, v in m.items()}
    m.update(seq=name, frames=len(images), degrade=degrade, wall_s=wall,
             render_s=render_s, frames_per_s=len(images) / wall,
             ate_pct_traj=100.0 * m["ate_rms"] / m["traj_len"],
             stage_s=state["seconds"], windows=len(state["window_seconds"]),
             windows_owned=len(recs),
             window_s=[None if w is None else sum(w.values()) for w in state["window_seconds"]],
             window_stage_s=_stage_sums(state["window_seconds"]),
             closures=len(state["closures"]))
    return m


def _held_run(run):
    """``run()`` with every call of the batched matcher recorded, and every
    window-pose exchange (`kitti._allgather_window_locals`, called when the
    windows are split over processes). Each matcher call is then held
    against `topk2_scores_batched_plain` on its own inputs, and each
    exchange's output against its input: every window this process
    reconstructed must come back in its slot with the same frames and the
    float32 rounding of its poses. Returns (run's result, [launches,
    calls, calls bit-equal, largest absolute difference, own windows, own
    windows exchanged exactly], the exchanged windows' digest: per window
    its frame count, frame-id sum and pose sum)."""
    from tpu3drec_torch.ops import matcher
    from tpu3drec_torch.pipelines import kitti
    from tpu3drec_torch.utils.profiling import held_against, recording

    matcher.reset_launches()
    with recording(matcher, "topk2_scores_batched") as calls, \
            recording(kitti, "_allgather_window_locals") as exchanges:
        m = run()
    launches = matcher.launches
    equal, err, _ = held_against(calls, matcher.topk2_scores_batched_plain)
    own = exact = 0
    digest = np.zeros((0, 3))
    for (window_locals, my_windows, _), out in exchanges:
        for w in my_windows:
            if window_locals[w]:
                own += 1
                exact += (out[w] is not None and sorted(out[w]) == sorted(window_locals[w])
                          and all(np.array_equal(out[w][f], np.float32(T).astype(np.float64))
                                  for f, T in window_locals[w].items()))
        digest = np.array([[0, 0, 0] if d is None else
                           [len(d), sum(d), sum(float(T.sum()) for T in d.values())]
                           for d in out], np.float64)
    return m, np.array([launches, len(calls), equal, err, own, exact], np.float64), digest


def _spawn(args, frames_path: str) -> int:
    """Run ``args.nproc`` processes of this tool as the ranks of the window
    split, on one file-store coordinator, within NPROC_TIMEOUT_S
    (`parallel/multihost.py::spawn_local`); print their output."""
    import tempfile

    from tpu3drec_torch.parallel.multihost import spawn_local

    with tempfile.TemporaryDirectory(prefix="ate_torch_") as tmp:
        cmd = [sys.executable, os.path.abspath(__file__), "--seq", args.seq,
               "--frames", str(args.frames), "--max-keypoints", str(args.max_keypoints),
               "--nproc", str(args.nproc), "--frames-from", frames_path, "--coord",
               "file://" + os.path.join(tmp, "store")]
        if args.no_depth_priors:
            cmd.append("--no-depth-priors")
        if args.degrade:
            cmd.append("--degrade")
        if args.device:
            cmd += ["--device", args.device]
        if args.hold:
            cmd.append("--hold")
        if args.out:
            cmd += ["--out", args.out]
        outs = spawn_local(lambda r: cmd + ["--worker", str(r)], args.nproc, NPROC_TIMEOUT_S)
    print("".join(outs), end="", flush=True)
    return 0


def _stage_sums(window_seconds):
    """Seconds of each `run_sfm` stage summed over the windows."""
    out = {}
    for w in window_seconds:
        for k, v in (w or {}).items():
            out[k] = out.get(k, 0.0) + v
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seq", default="m00", choices=sorted(SEQ_LAYOUTS))
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--max-keypoints", type=int, default=512)
    p.add_argument("--no-depth-priors", action="store_true")
    p.add_argument("--degrade", action="store_true",
                   help="add the full photometric degradation stack (data/degrade.py)")
    p.add_argument("--workers", type=int, default=None, help="render processes (default: CPUs)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--out", default=None, help="also write the metrics as JSON here")
    p.add_argument("--nproc", type=int, default=1,
                   help=">1: split the windows over N processes (pipelines/kitti.py)")
    p.add_argument("--frames-from", default=None,
                   help="an .npz of images, depths and gt_T (--save-frames) to run")
    p.add_argument("--save-frames", default=None, help="save the rendered frames here")
    p.add_argument("--hold", action="store_true",
                   help="hold every matcher launch against its plain version, and the "
                        "window-pose exchange against each window's own poses")
    p.add_argument("--worker", type=int, default=None)   # internal: this process's rank
    p.add_argument("--coord", default=None)              # internal: the coordinator
    args = p.parse_args(argv)

    frames = None
    if args.frames_from:
        with np.load(args.frames_from) as z:
            frames = (z["images"], z["depths"], z["gt_T"])
    if args.nproc > 1 and args.worker is None:
        # the parent: render once, then start the processes on the frames
        if args.frames_from:
            return _spawn(args, args.frames_from)
        import tempfile

        frames = render_sequence(args.seq, args.frames, workers=args.workers,
                                 degrade=args.degrade)
        with tempfile.TemporaryDirectory(prefix="ate_frames_") as tmp:
            path = args.save_frames or os.path.join(tmp, "frames.npz")
            np.savez(path, images=frames[0], depths=frames[1], gt_T=frames[2])
            return _spawn(args, path)
    if args.worker is not None:
        from tpu3drec_torch.parallel.multihost import init_distributed

        if not init_distributed(args.coord, args.nproc, args.worker):
            raise RuntimeError("the process group did not start")
    elif args.save_frames:
        frames = frames or render_sequence(args.seq, args.frames, workers=args.workers,
                                           degrade=args.degrade)
        np.savez(args.save_frames, images=frames[0], depths=frames[1], gt_T=frames[2])
    run = lambda: run_sequence(  # noqa: E731
        args.seq, args.frames, max_keypoints=args.max_keypoints,
        depth_priors=not args.no_depth_priors, workers=args.workers, device=args.device,
        degrade=args.degrade, frames=frames)
    if args.hold:
        m, held, digest = _held_run(run)
        if args.nproc > 1:
            from tpu3drec_torch.parallel.multihost import process_allgather

            held = process_allgather(held)
            digests = process_allgather(digest)
            m["exchange_same_on_all"] = bool((digests == digests[:1]).all())
            m["exchange_by_process"] = [{"own_windows": int(h[4]), "exact": int(h[5])}
                                        for h in held]
        m["matcher_by_process"] = [{"launches": int(h[0]), "calls": int(h[1]),
                                    "bit_equal": int(h[2]), "max_abs_err": float(h[3])}
                                   for h in np.reshape(held, (-1, 6))]
    else:
        m = run()
    m["nproc"] = args.nproc
    if args.worker:  # only process 0 writes the row
        return 0
    line = json.dumps(m)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
