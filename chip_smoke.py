#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpu3drec_torch/`) on one card.

    python3 chip_smoke.py                 # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse-cpu  # phases 3-16 at a tiny size on the CPU

Phases, one flushed line each with its wall seconds:
  1. device: the card's name and count, and nvidia-smi's name and power limit
  2. build: every kernel of the port, from the sources in this checkout
     (`tpu3drec_torch/ops/csrc/*.cu`), one nvcc process per source, in
     parallel, then the host map-export library (`utils/csrc/native_io.cpp`)
  3. ICP-NN kernel vs plain: the ICP nearest-neighbour kernel against its
     plain PyTorch version at ragged shapes, with exact ties, and at the
     slice's shape (one 480x640 frame at stride 2 against another); times of
     the kernel, the plain version and one library call, and the kernel's bound
  4. fusion: 16 frames of 480x640 depth of a seeded corridor scene with the
     reference camera -> world points -> binary PLY + .bt at 0.1 m
  5. ICP scale correction: a 76,800-point cloud from the fused map against
     a copy under a known similarity, through the CLI: `icp` (50
     iterations), `icp-fuse`, `ply2bt`
  6. matcher kernel vs plain: ragged, tied, all-invalid and Kb > 2048 cases,
     phase 8's shape (30 pairs x 512 x 512, padded rows invalid) and
     P=8 x K=4096 x D=128 in both directions, bit for bit; times of the
     kernel, the plain version, a bmm+topk yardstick, and the bound
  7. BA-blocks kernel vs plain at O = 1, 31, 33, 511, 513, 65,536 and
     262,144, bit for bit, timed at 65,536 (inside the 50 MB L2) and at
     262,144 (112 MB, past it); then `ba_solve(use_pallas_blocks=True)` (the
     kernel's path) against the jacfwd path on a 64-camera, 8192-landmark,
     65,536-observation problem, with every run of the kernel in the
     block-path solve (the first LM step eager, the rest replays of a CUDA
     graph of the step) counted in the profiler's trace and held against
     the plain version on the inputs the solve gave it
  8. SfM: 12 seeded frames of 480x640 with the reference camera through
     `sfm_pipeline.run` (512 keypoints, overlap 3) -> pose txt + sparse PLY;
     registered frames, ATE after similarity alignment, time per stage; the
     matcher's launches on the path held against the plain version on the
     descriptors and valid masks the path gave them, and timed at that shape
  9. long sequence: the m00 loop of `tools/ate_torch.py` (150 frames of
     640x192, rendered in worker processes) through
     `pipelines/kitti.py::run_windowed_sfm` with 512 keypoints, window 12,
     stride 7, depth priors, loop closure (gap 30), the switchable pose
     graph and global BA; the seconds of each stage, ATE / RPE / coverage
     against the JAX package's CPU row, failing above 2% of the trajectory
     or below 0.95 coverage; every matcher launch of the run held against
     the plain version, and the kernel timed at the global BA's
     128 x 512 x 512
 10. monocular: 12 frames of 480x640 rendered in worker processes
     (`tools/train_convergence_torch.py`'s scene and trajectory, the loss
     config's K); the full MonodepthModel (ResNet18 depth + ResNet18 pose,
     26.8M parameters) from the seed takes 10 GT-pose steps at batch 1, its
     first held against the same step on the CPU (loss within 1e-4 relative;
     the card's float32 gradients within half their norm of the step's
     float64 gradients; the card's Adam update equal to the CPU's Adam on
     the card's gradients), then one pose-net step; warm ms per step in float32 (IEEE) and
     bfloat16 with peak memory; `infer_depth_maps` on the 12 frames at
     480x640 and at 192x640 (batch 8), frames/s, one frame's depth held
     against the CPU's (1e-4 relative); the inferred depth and the true
     poses fused by `run_arrays` into PLY + .bt. No kernel of the port is on
     this path (the nets are cuDNN convolutions); the line `monocular {...}`
     before the kernels line carries its numbers, the card's name and its
     power limit
 11. stereo (configuration 3): PSMNet trained through the CLI (`train-stereo
     --sim 4 --epochs 3` at StereoTrainConfig's published 256x512, batch 4,
     max_disp 64, feat_ch 32); the first step of a seeded model on 8
     rendered pairs (`tools/stereo_convergence_torch.py`'s scene) held against
     the same step on the CPU (loss within 1e-4 relative, batch statistics
     within 1e-4, the card's Adam update equal to the CPU's Adam on the
     card's gradients) and its float32 gradients against a float64 run on
     the card (within STEREO_GRAD_BOUND of their norm); warm ms per step in
     float32 (IEEE) and bfloat16 with peak memory and kernels per step; the
     CLI's trained model (`load_trained`) through `pipelines/stereo.run` on
     12 pairs of 480x640 with the reference camera, batch 4, into PLY + .bt,
     `infer_disparity` frames/s, one pair's disparity held against the CPU
     (1e-4 relative); the line `stereo {...}`
 12. MVS: `run_mvs` on 12 rendered views of 480x640 (tests/test_mvs.py's
     urban scene, the reference camera) with MvsConfig's defaults (96
     planes, 4 sources, window 5) over the scene's depth range; seconds per
     stage, sweep ms per view, the TSDF grid's dims and bytes, the mesh's
     size, the share of mesh vertices within 3 voxels of the rendered
     surface (>= 0.9), and one view's plane sweep held against the CPU's
     (winning planes, n_valid, ZNCC and depth, as tests/test_torch_mvs.py
     holds it against the JAX package's); the line `mvs {...}`
 13. occupancy: phase 4's 16 frames stored as .npy depth through the CLI's
     `occupancy` (the reference camera, 0.1 m, 128 samples, 50 m range):
     seconds per scan split into the device scan and the device merge,
     occupied and free voxels, peak memory; the first 2 frames through the
     same CLI on the card and on the CPU, whose `.bt` files must be
     byte-equal
 14. point-to-plane ICP: phase 5's 76,800-point cloud against a copy under
     a known rigid motion, normals estimated (k=16), 15 iterations: the
     transform within 1e-3 of the truth, 15 ICP-NN launches per call, each
     held against the plain version bit for bit; a 4,800-point subsample on
     the card and on the CPU (transforms within 1e-4, normals equal up to
     sign on >= 99% within 1e-4); `estimate_normals` and `_icp_plane_core`
     seconds; this path's launches join phase 5's in the kernels line
 15. serve: the port's C++ sender (`utils/csrc/stream_sender.cpp`, built
     here with one `c++`) streams a capture blob of phase 4's 16 frames with
     RGB to the CLI's `serve` at batch 4 in its own process, and to
     `stream_fuse` in this one; the `.bt`, the PLY and the sorted points
     equal `run_arrays` on the same frames; frames per second
 16. autonomy: `mission-sim` through the CLI (1200 ticks; exit 0 only when
     the mission ends LANDED), ticks per second, its phases and trajectory
     against a CPU run; `label_components`, `largest_blob`, `detect_rings`,
     `match_templates` and `decode_marker` on 480x640 frames rendered with
     numpy (a ring gate, a pad, a marker, a number board), on the card and
     on the CPU: integer outputs equal, floats within stated tolerances
 17. sharded (2 ranks of this script on the one card, joined over gloo
     through a file store; every CUDA tensor of a collective staged through
     host memory and counted): the ring search at phase 5's 76,800 x 76,800
     cloud (2 ICP-NN launches a call on each rank, each held against the
     plain version; d2 bit-equal to the single-process kernel's, indices
     equal but at exact ties across shards), the sharded voxel count of
     phase 4's map (equal to `unique_voxels`'), observation-sharded
     `ba_solve(use_pallas_blocks=True)` (one BA-blocks launch an LM
     iteration on each rank, held against the plain version) and
     `ba_solve_landmark_sharded` on phase 7's 64-camera, 8,192-landmark,
     65,536-observation problem (final costs within 1e-3 of the
     single-process solves'), the x-sharded TSDF of phase 12's grid (each
     slab equal to the whole grid's slice) and
     `marching_tetrahedra_sharded_soup` (the single-process triangles, in
     order), one data-parallel monocular step at 480x640 with a frame a
     rank (loss within 1e-4 of the single-process batch-2 step's, gradients
     within half their norm of it, the ranks' parameters equal, the Adam
     update as phase 10 holds it) and one tensor-parallel step (model=2)
     against the replicated step (loss within 1e-4, gradients within half
     their norm)
 18. entry_points: the CLI's `rgbd` as 2 processes (`--coordinator
     localhost:<port> --num-processes 2`) on phase 13's `.npy` frames, its
     `.bt` byte-equal and its PLY the same point set as one process's; the
     window split of phase 9's m00 frames through `tools/ate_torch.py
     --nproc 2 --hold` (each window's exchanged poses the float32 rounding
     of its own, in its own slot, the same on both processes; coverage
     equal to phase 9's, |ATE difference| within M00_ATE_DELTA_PCT points
     of the trajectory; every matcher launch of each process bit-equal to
     the plain version)
Phases 13, 15 and 16 launch none of the kernels and fail unless every count
is still 0 after them; their numbers, and phase 14's, are the lines
`occupancy`, `point_to_plane`, `serve` and `autonomy` before the kernels
line; phases 17-18's are the line `multiprocess` (seconds, each rank's
launches and staged bytes by collective, the backend). A failed or
timed-out rank fails its phase. Phases 17-18 run on the card only
(`--rehearse-cpu` skips them; `tests/test_torch_parallel*.py`,
`tests/test_torch_multihost.py` and `tools/dryrun_multichip_torch.py
--device cpu` run their paths on the CPU).
Phase 4 also writes the `.bt` and the PLY of `run_arrays` with the writers'
Python path (`run_arrays_s_python`, files byte-equal to the native ones) and
an ASCII PLY of one frame's points by each backend (byte-equal).
A kernel's `ms` is its device time (`kernel_times`: torch.profiler's CUDA
activity, summed over the wrapper's __global__s, mean per call) and its
`call_ms` the wrapper's time per call (CUDA events around a loop of calls,
host work included); `kernel_ms` mirrors `ms`. On the CPU `ms` is None.
Each kernel's launch count is zeroed just before the path that runs it
(phases 4-5 for icp_nn, the block-path solve of phase 7 for ba_blocks,
phase 8 and again phase 9 for matcher; in each rank of phases 17-18, the
ring search, the observation-sharded solve and the window split) and read just after; phases 10, 11
and 12, whose paths run none of them, each zero all three and fail unless
each is still 0 after them. The last lines are the kernels as
one JSON object (with each __global__'s registers and spill bytes as ptxas
reported them, and the reference splits the ICP-NN and matcher kernels
used at their timed shapes), nvidia-smi's line and `{"ok": true, "device": {...}}`. Any
failed check exits non-zero before that. Inputs come from numpy's
default_rng(--seed); files go to a temporary directory, kernels to build/.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))



def bound(flops: float, bytes_moved: float):
    """(ms, what bounds it): the least time of work on the card, the larger
    of its fp32 operations over the peak rate and its bytes over the memory
    rate, by the roofline of `tpu3drec_torch/utils/profiling.py` with one
    H100 SXM's published peaks (`profiling.H100`)."""
    from tpu3drec_torch.utils.profiling import H100, roofline

    r = roofline(1.0, flops, bytes_moved, chip=H100)  # at 1 s the peak share is the bound
    return r.fraction_of_peak * 1e3, "operations" if r.compute_bound else "bytes"


NN_FLOP_PER_PAIR = 9  # the count the JAX package's cost model uses
# Phase 11: the card's float32 gradients of the first stereo step against a
# float64 run of it, as a share of the gradient's norm
# (measured on an H100: 9.0e-4, the CPU's 1.1e-3; a wrong backward is off
# by the gradient's own size)
STEREO_GRAD_BOUND = 1e-2

# The reference camera (CLI defaults) and the slice's frame size.
FX, FY, CX, CY, W, H = 600.391, 600.079, 320.0, 240.0, 640, 480


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


class Phase:
    """Prints one line per phase with its wall seconds; an exception inside
    propagates and ends the run with a non-zero exit."""

    def __init__(self, name: str):
        self.name = name
        self.info = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        secs = time.perf_counter() - self.t0
        state = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        extra = " ".join(f"{k}={v}" for k, v in self.info.items())
        log(f"[phase {self.name}] {state} {secs:.2f}s {extra}".rstrip())
        return False


def import_port():
    """The port from this checkout, never one installed elsewhere."""
    sys.path.insert(0, HERE)
    import tpu3drec_torch

    where = os.path.dirname(os.path.abspath(tpu3drec_torch.__file__))
    check(where == os.path.join(HERE, "tpu3drec_torch"),
          f"tpu3drec_torch imported from {where}, not from this checkout")
    # the port's call recorders, for every phase after this one
    global held_against, patched, recording
    from tpu3drec_torch.utils.profiling import held_against, patched, recording


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, reps: int, warmup: int = 1) -> float:
    """Mean ms per call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync(dev)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_times(fn, names, dev, reps: int, warmup: int = 1):
    """(device ms, call ms) of a kernel's wrapper ``fn``.

    The device time is the summed mean device duration, over ``reps``
    calls, of the kernels whose names hold one of ``names`` (each
    ``__global__`` the wrapper launches, the first of them on every call),
    from torch.profiler's CUDA activity: the card's own time, whatever the
    host does between launches. The call time is ``time_ms``'s: CUDA events
    around a loop of calls, so a wrapper whose host work outlasts its kernel
    shows the host. On the CPU there is no device time (None)."""
    call_ms = time_ms(fn, dev, reps, warmup)
    if dev.type != "cuda":
        return None, call_ms
    sync(dev)
    with profiled(dev) as prof:
        for _ in range(reps):
            fn()
        sync(dev)
    # each __global__ runs at most once a call: the call's device time is the
    # sum of their mean durations. The trace may miss a few launches (seen
    # once, 45 of 50 kept), so a mean over those it kept, if most of them.
    us = {n: [] for n in names}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in e.name:
                us[n].append(e.time_range.elapsed_us())
                break
    seen = len(us[names[0]])
    check(2 * seen >= reps, f"the profiler saw {seen} launches of {names[0]} in {reps} calls")
    return sum(sum(v) / len(v) for v in us.values() if v) / 1e3, call_ms


def hold_against_plain(calls, plain, name: str) -> float:
    """Each recorded call's result against ``plain`` on the same arguments,
    bit for bit (`utils/profiling.py::held_against`); returns the largest
    absolute difference (0.0)."""
    check(len(calls) > 0, f"{name}: the main path made no call")
    equal, max_err, first = held_against(calls, plain)
    check(equal == len(calls), f"{name}: {len(calls) - equal} of {len(calls)} calls differ, "
          f"the first at (call, output) {first}, max err {max_err}")
    return max_err


@contextlib.contextmanager
def replays_recorded(calls):
    """Inside ``recording``: a call made while BA's LM step was captured in
    a CUDA graph (`sfm/ba.py::_LMGraph`) ran nothing then, and the clones
    ``recording`` took of it were captured with it, so that each replay
    writes that replay's arguments and result into them. After every
    replay this keeps a copy of them in ``calls``; on the way out it drops
    the captured entries, so ``calls`` holds one entry a run. The solve has
    to capture its graph inside the block: a graph captured before it
    replays without clones."""
    from tpu3drec_torch.sfm import ba
    from tpu3drec_torch.utils.profiling import _clone

    captured = {}

    def wrap(name, fn):
        def capture(graph, *args):
            first = len(calls)
            fn(graph, *args)
            captured[graph] = calls[first:]

        def replay(graph):
            fn(graph)
            calls.extend(_clone(c) for c in captured.get(graph, ()))
        return capture if name == "capture" else replay

    try:
        with patched(ba._LMGraph, ("capture", "replay"), wrap):
            yield calls
    finally:
        gone = {id(c) for cs in captured.values() for c in cs}
        calls[:] = [c for c in calls if id(c) not in gone]


def device_runs(prof, name: str) -> int | None:
    """Runs on the card of the kernels whose names hold ``name``, in a
    torch.profiler trace (replays of a CUDA graph included); None without
    one."""
    if prof is None:
        return None
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name)


def profiled(dev):
    """torch.profiler's CPU and CUDA activity on the card; nothing (None)
    on the CPU."""
    if dev.type != "cuda":
        return contextlib.nullcontext(None)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


# ---------------------------------------------------------------------------
# inputs: a corridor, ray-cast from a seeded camera path
# ---------------------------------------------------------------------------


def _rot(yaw, pitch, roll):
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz


def _quat_xyzw(R):
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    return np.array([(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w), w])


def make_scene(rng, frames: int, h: int, w: int, fx, fy, cx, cy):
    """Depth (F, H, W) float32 of a 4 m x 3 m corridor ending 50 m ahead,
    with seeded spheres in it, from a camera walking down it (y down).
    Returns depths, camera->world (R (F,3,3), centre (F,3)) in float64,
    and the COLMAP world->camera rows (q_xyzw (F,4), t (F,3))."""
    spheres = np.stack([rng.uniform(-1.6, 1.6, 24), rng.uniform(-1.2, 1.2, 24),
                        rng.uniform(3.0, 46.0, 24)], -1)
    radii = rng.uniform(0.2, 0.7, 24)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    dc = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1).reshape(-1, 3)
    depths = np.zeros((frames, h, w), np.float32)
    Rs, cs, qs, ts = [], [], [], []
    for f in range(frames):
        R = _rot(0.05 * np.sin(0.7 * f), 0.03 * np.cos(0.5 * f), 0.02 * np.sin(f))
        c = np.array([0.4 * np.sin(0.3 * f), 0.2 * np.cos(0.4 * f), 0.3 * f])
        d = dc @ R.T  # world ray per pixel; its parameter t is the camera depth
        t = np.full(d.shape[0], np.inf)
        for axis, lo, hi in ((0, -2.0, 2.0), (1, -1.5, 1.5), (2, -10.0, 50.0)):
            with np.errstate(divide="ignore", invalid="ignore"):
                ta = np.where(d[:, axis] > 0, (hi - c[axis]) / d[:, axis],
                              np.where(d[:, axis] < 0, (lo - c[axis]) / d[:, axis], np.inf))
            t = np.minimum(t, ta)
        for s, r in zip(spheres, radii):
            oc = c - s
            a = np.einsum("ni,ni->n", d, d)
            b = 2 * d @ oc
            disc = b * b - 4 * a * (oc @ oc - r * r)
            with np.errstate(invalid="ignore"):
                ts_ = (-b - np.sqrt(disc)) / (2 * a)
            t = np.where((disc > 0) & (ts_ > 0) & (ts_ < t), ts_, t)
        z = t.reshape(h, w)
        z[(z < 0.5) | (z > 50.0)] = 0.0  # no return
        z[rng.random((h, w)) < 0.02] = 0.0  # dropouts
        depths[f] = z
        Rs.append(R)
        cs.append(c)
        # COLMAP world->camera: R_w2c = R^T, t_w2c = -R^T c
        qs.append(_quat_xyzw(R.T))
        ts.append(-R.T @ c)
    return depths, np.stack(Rs), np.stack(cs), np.stack(qs), np.stack(ts)


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def host_io_backends(depths, q, t, cfg, pts, dev, tmp: str):
    """Phase 4's map export by both backends: `run_arrays` again with the
    writers on ``backend="python"`` (its `.bt` and PLY byte-equal to the
    native run's), and an ASCII PLY of ``pts`` by each backend, byte-equal.
    Returns (the Python run's run_arrays seconds, the ASCII numbers)."""
    import dataclasses
    import functools

    from tpu3drec_torch.mapping import btio
    from tpu3drec_torch.pipelines import rgbd
    from tpu3drec_torch.utils import plyio

    pcfg = dataclasses.replace(cfg, out_ply=os.path.join(tmp, "map_py.ply"),
                               out_bt=os.path.join(tmp, "map_py.bt"))
    # the writers `run_arrays` reaches (through parallel/multihost.py)
    saved = btio.write_bt, plyio.write_ply
    btio.write_bt = functools.partial(btio.write_bt, backend="python")
    plyio.write_ply = functools.partial(plyio.write_ply, backend="python")
    try:
        py = rgbd.run_arrays(depths, q, t, pcfg, device=dev)
    finally:
        btio.write_bt, plyio.write_ply = saved
    check(_same_bytes(cfg.out_bt, pcfg.out_bt), "native and Python .bt differ")
    check(_same_bytes(cfg.out_ply, pcfg.out_ply), "the two runs' PLY differ")
    paths = {b: os.path.join(tmp, f"ascii_{b}.ply") for b in ("auto", "python")}
    secs = {}
    for backend, path in paths.items():
        t0 = time.perf_counter()
        plyio.write_ply(path, pts, backend=backend)
        secs[backend] = time.perf_counter() - t0
    check(_same_bytes(paths["auto"], paths["python"]), "native and Python ASCII PLY differ")
    return py.seconds, {"ascii_ply_points": int(pts.shape[0]),
                        "ascii_ply_s_native": round(secs["auto"], 3),
                        "ascii_ply_s_python": round(secs["python"], 3)}


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def compare_nn(q, r, idx_k, d2_k, idx_p, d2_p):
    """d2 within 1e-6 relative; idx equal except where the two candidates'
    float64 distances differ by <= 1e-6 relative (a near tie). Returns
    (max abs d2 error, near-tie swaps)."""
    d2_k64, d2_p64 = d2_k.double(), d2_p.double()
    err = (d2_k64 - d2_p64).abs()
    check(bool((err <= 1e-6 * d2_p64.abs() + 1e-30).all()),
          f"d2 differs: max abs err {float(err.max())}")
    diff = (idx_k != idx_p).nonzero().flatten()
    if diff.numel():
        qd = q[diff].double()
        da = ((r[idx_k[diff].long()].double() - qd) ** 2).sum(-1)
        db = ((r[idx_p[diff].long()].double() - qd) ** 2).sum(-1)
        check(bool(((da - db).abs() <= 1e-6 * torch.maximum(da, db) + 1e-30).all()),
              f"{diff.numel()} indices differ beyond a near tie")
    return float(err.max()), int(diff.numel())


def _split_info(name: str, plan, dev):
    """A kernel's split plan at the timed shape, beside the blocks an SM
    holds that it was planned from."""
    from tpu3drec_torch.ops import build

    return {"splits": plan[0], "refs_per_split": plan[1],
            "blocks_per_sm": build.blocks_per_sm(name, dev)}


def phase_kernel(dev, rng, full_q, full_r, gpu: bool):
    from tpu3drec_torch.ops import icp_nn
    from tpu3drec_torch.ops.icp_nn import nearest_neighbors_cuda, nearest_neighbors_plain

    def kernel(q, r):
        if gpu:
            return nearest_neighbors_cuda(q, r)
        return nearest_neighbors_plain(q, r, block=7)  # rehearsal: another blocking

    lattice = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    dup = rng.normal(size=(700, 3))
    cases = {
        "1x1": (rng.normal(size=(1, 3)), rng.normal(size=(1, 3))),
        "1000x3001": (rng.normal(size=(1000, 3)), rng.normal(size=(3001, 3))),
        "777x500": (rng.normal(size=(777, 3)), rng.normal(size=(500, 3))),
        # exact duplicates in the reference set and queries on lattice
        # points and midpoints: many exact ties, all to the lowest index
        "ties": (np.concatenate([lattice + 0.5, lattice, dup[:300]]),
                 np.concatenate([dup, lattice, dup, lattice[::-1]])),
    }
    results = {}
    max_err, swaps = 0.0, 0
    for name, (qn, rn) in list(cases.items()) + [("full", (full_q, full_r))]:
        q = torch.as_tensor(qn, dtype=torch.float32, device=dev).contiguous()
        r = torch.as_tensor(rn, dtype=torch.float32, device=dev).contiguous()
        idx_k, d2_k = kernel(q, r)
        idx_p, d2_p = nearest_neighbors_plain(q, r)
        sync(dev)
        e, s = compare_nn(q, r, idx_k, d2_k, idx_p, d2_p)
        max_err, swaps = max(max_err, e), swaps + s
        results[name] = (q, r)
        log(f"  icp_nn {name}: {q.shape[0]}x{r.shape[0]} max_abs_err={e} near_tie_swaps={s}")
    q, r = results["full"]
    nq, nr = q.shape[0], r.shape[0]
    reps = 20 if gpu else 1
    kernel_ms, call_ms = kernel_times(lambda: kernel(q, r), ("icp_nn_kernel", "icp_nn_unpack"),
                                      dev, reps=reps, warmup=2 if gpu else 0)
    plain_ms = time_ms(lambda: nearest_neighbors_plain(q, r), dev, reps=3 if gpu else 1,
                       warmup=1 if gpu else 0)
    library_ms = None
    if gpu:
        # yardstick only: materialises the Nq x Nr matrix; the port never calls it
        library_ms = time_ms(lambda: torch.cdist(q, r).min(dim=1), dev, reps=3)
        torch.cuda.empty_cache()
    bound_ms, bound_by = bound(NN_FLOP_PER_PAIR * nq * nr, (nq + nr) * 12 + nq * 8)
    return {
        "name": "icp_nn",
        "splits": _split_info("icp_nn", icp_nn.launch_plan(nq, nr, dev), dev) if gpu else None,
        "route": "cuda",
        "source": "tpu3drec_torch/ops/csrc/icp_nn.cu",
        "replaces": "tpu3drec/ops/icp_nn.py:42",
        "shape": [nq, nr],
        "max_abs_err": max_err,
        "near_tie_swaps": swaps,
        "ms": kernel_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# phase 6: the matcher kernel against its plain version
# ---------------------------------------------------------------------------


def _unit_rows(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# the matcher's __global__s: the scores, and the merge of reference splits
MATCHER_KERNELS = ("matcher_kernel", "matcher_merge")


def _matcher_bound(P, Ka, Kb, D):
    """(ms, what bounds it): the fp32 operations of the products over the
    card's peak, or the bytes (descriptors and mask in, index and two
    scores out) over HBM, whichever is larger."""
    return bound(2 * P * Ka * Kb * D, ((P * Ka + P * Kb) * D + P * Kb) * 4 + P * Ka * 12)


def _matcher_library_ms(a, b, dev) -> float:
    """Yardstick only: full-fp32 bmm then topk(2), which stores the
    (P, Ka, Kb) scores."""
    from tpu3drec_torch.core import fp

    def library():
        with fp.ieee_fp32():
            return torch.bmm(a, b.transpose(1, 2)).topk(2, dim=-1)

    ms = time_ms(library, dev, reps=5)
    torch.cuda.empty_cache()
    return ms


def phase_matcher(dev, rng, gpu: bool):
    from tpu3drec_torch.ops import matcher

    def kernel(a, b, v):
        if gpu:
            return matcher.topk2_scores_batched_cuda(a, b, v)
        return matcher.topk2_scores_batched_plain(a, b, v, tile_b=7)  # another tiling

    D = 128
    P, K = (8, 4096) if gpu else (2, 300)
    base = _unit_rows(rng, 50, D)
    ties_b = np.concatenate([base, base[::-1], base])          # every score tied 3x
    valid_2049 = rng.random(2049) >= 0.1
    a_big = _unit_rows(rng, P, K, D)
    b_big = _unit_rows(rng, P, K, D)
    # phase 8's shape: 30 sequential pairs of 512 keypoints, the detector's
    # padding rows invalid at the end of each frame
    Pm, Km = (30, 512) if gpu else (30, 256)
    valid_m = np.arange(Km)[None] < rng.integers(Km // 2, Km + 1, (Pm, 1))
    cases = {
        "1x1": (_unit_rows(rng, 1, 1, D), _unit_rows(rng, 1, 1, D), np.ones((1, 1), bool)),
        "300x2049": (_unit_rows(rng, 1, 300, D), _unit_rows(rng, 1, 2049, D), valid_2049[None]),
        "ties": (np.concatenate([base, base[:7]])[None], ties_b[None],
                 np.ones((1, ties_b.shape[0]), bool)),
        "all_invalid": (_unit_rows(rng, 1, 77, D), _unit_rows(rng, 1, 130, D),
                        np.zeros((1, 130), bool)),
        "main_path_shape": (_unit_rows(rng, Pm, Km, D), _unit_rows(rng, Pm, Km, D), valid_m),
        "batched_ab": (a_big, b_big, np.ones((P, K), bool)),
        "batched_ba": (b_big, a_big, np.ones((P, K), bool)),
    }
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    max_err = 0.0
    for name, (a, b, v) in cases.items():
        a, b, v = t(a), t(b), t(v)
        bk, tk = kernel(a, b, v)
        bp, tp = matcher.topk2_scores_batched_plain(a, b, v)
        sync(dev)
        err = float((tk - tp).abs().max())
        check(torch.equal(bk, bp) and torch.equal(tk, tp),
              f"matcher {name}: {int((bk != bp).sum())} indices differ, max score err {err}")
        max_err = max(max_err, err)
        log(f"  matcher {name}: {tuple(a.shape)} x {tuple(b.shape)} max_abs_err={err} "
            f"near_tie_swaps=0")
    # one case through the single-pair entry point
    a, b, v = t(cases["300x2049"][0][0]), t(cases["300x2049"][1][0]), t(valid_2049)
    bk, tk = matcher.topk2_scores(a, b, v)
    bp, tp = matcher.topk2_scores_plain(a, b, v)
    sync(dev)
    check(torch.equal(bk, bp) and torch.equal(tk, tp), "topk2_scores differs from its plain version")
    log("  matcher topk2_scores 300x2049: equal")

    a, b, v = t(a_big), t(b_big), t(cases["batched_ab"][2])
    reps = 20 if gpu else 1
    kernel_ms, call_ms = kernel_times(lambda: kernel(a, b, v), MATCHER_KERNELS, dev, reps=reps,
                                      warmup=2 if gpu else 0)
    plain_ms = time_ms(lambda: matcher.topk2_scores_batched_plain(a, b, v), dev,
                       reps=3 if gpu else 1, warmup=1 if gpu else 0)
    library_ms = _matcher_library_ms(a, b, dev) if gpu else None
    bound_ms, bound_by = _matcher_bound(P, K, K, D)
    return {
        "name": "matcher",
        "splits": _split_info("matcher", matcher.launch_plan(P, K, K, dev), dev) if gpu else None,
        "route": "cuda",
        "source": "tpu3drec_torch/ops/csrc/matcher.cu",
        # the batched kernel is the one on the main path; the same
        # __global__ (P = 1) also replaces the single-pair kernel
        "replaces": "tpu3drec/ops/matcher.py:151",
        "also_replaces": "tpu3drec/ops/matcher.py:68",
        "shape": [P, K, K, D],
        "max_abs_err": max_err,
        "near_tie_swaps": 0,
        "ms": kernel_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# phase 7: the BA-blocks kernel against its plain version, then ba_solve
# ---------------------------------------------------------------------------

BA_FLOATS_IN, BA_FLOATS_OUT = 15, 92


def _ba_inputs(rng, O, dev):
    from tpu3drec_torch.core.se3 import axis_angle_to_matrix

    R = axis_angle_to_matrix(torch.as_tensor(rng.normal(size=(O, 3)) * 0.3, dtype=torch.float32))
    Xc = rng.uniform([-2, -2, 3], [2, 2, 12], size=(O, 3)).astype(np.float32)
    if O > 2:
        Xc[0] = [1e-12, -1e-12, 0.0]  # the z clamp, with finite blocks
    uv = rng.uniform([0, 0], [640, 480], size=(O, 2)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=O).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev).contiguous()  # noqa: E731
    return t(Xc), t(R), t(uv), t(w)


def _ba_problem(rng, dev, F, L, O):
    """The BA benchmark problem of the JAX package (bench.py): consistent
    geometry, observations = projections + 1 px noise, cameras perturbed."""
    from tpu3drec_torch.sfm import ba

    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    cam_params = rng.normal(0, 0.05, (F, 6)).astype(np.float32)
    cam_params[:, 5] += np.linspace(0, 5, F).astype(np.float32)
    points = rng.uniform([-5, -5, 8], [5, 5, 30], (L, 3)).astype(np.float32)
    cam_idx = rng.integers(0, F, O)
    pt_idx = rng.integers(0, L, O)
    clean = ba.BAProblem.from_numpy(cam_params, points, cam_idx, pt_idx, np.zeros((O, 2)),
                                    np.ones(O), K, device=dev)
    uv = ba.residuals(clean).cpu().numpy() + rng.normal(0, 1.0, (O, 2)).astype(np.float32)
    start = cam_params + rng.normal(0, 0.01, (F, 6)).astype(np.float32)
    return ba.BAProblem.from_numpy(start, points, cam_idx, pt_idx, uv, np.ones(O), K,
                                   device=dev)


def _ba_times(ba_blocks, ins, intr, dev, gpu: bool):
    """The kernel's device and call times, the plain version's time and the
    byte bound (each input read once, each output written once) at the
    size of ``ins``."""
    O = ins[0].shape[0]
    kern = ba_blocks.ba_blocks_cuda if gpu else ba_blocks.ba_blocks_plain
    ms, call_ms = kernel_times(lambda: kern(*ins, intr), ("ba_blocks_kernel",), dev,
                               reps=50 if gpu else 1, warmup=3 if gpu else 0)
    plain_ms = time_ms(lambda: ba_blocks.ba_blocks_plain(*ins, intr), dev, reps=5 if gpu else 1,
                       warmup=1 if gpu else 0)
    return {"shape": [O], "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound(0, (BA_FLOATS_IN + BA_FLOATS_OUT) * 4 * O)[0]}


def phase_ba_blocks(dev, rng, gpu: bool, seed: int):
    from tpu3drec_torch.ops import ba_blocks

    intr = (500.0, 510.0, 320.0, 240.0)
    sizes = (1, 511, 513, 65_536) if gpu else (1, 511, 513, 2_048)
    # the sizes off a warp's 32 and the one past the 50 MB L2 (112 MB moved)
    # draw from a generator of their own, so that the solve's problem and the
    # SfM scene after this phase are the ones the seed gave before
    extra = (31, 33, 262_144) if gpu else (31, 33, 8_192)
    other = np.random.default_rng([seed, 7])
    max_err, timed = 0.0, {}
    for O, g in [(O, rng) for O in sizes] + [(O, other) for O in extra]:
        ins = _ba_inputs(g, O, dev)
        out_k = (ba_blocks.ba_blocks_cuda if gpu else ba_blocks.ba_blocks_plain)(*ins, intr)
        out_p = ba_blocks.ba_blocks_plain(*ins, intr)
        sync(dev)
        for key in out_p:
            err = float((out_k[key] - out_p[key]).abs().max())
            check(torch.equal(out_k[key], out_p[key]), f"ba_blocks O={O} {key}: max err {err}")
            max_err = max(max_err, err)
        log(f"  ba_blocks O={O}: 8 outputs bit-equal")
        del out_k, out_p
        if O in (sizes[-1], extra[-1]):
            timed[O] = _ba_times(ba_blocks, ins, intr, dev, gpu)
            log(f"  ba_blocks O={O}: " + " ".join(f"{k}={v}" for k, v in timed[O].items()))
    past_l2 = timed[extra[-1]]
    return {
        "name": "ba_blocks",
        "route": "cuda",
        "source": "tpu3drec_torch/ops/csrc/ba_blocks.cu",
        "replaces": "tpu3drec/ops/ba_blocks.py:32",
        "shape": past_l2["shape"],
        "max_abs_err": max_err,
        "ms": past_l2["ms"],
        "call_ms": past_l2["call_ms"],
        "plain_ms": past_l2["plain_ms"],
        "bound_ms": past_l2["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes these blocks
        # the solve's size: its 28 MB fit in L2, so its share of the bound is not read
        "in_l2": timed[sizes[-1]],
    }


def ba_solve_paths(dev, rng, gpu: bool, ph):
    """The block path (the kernel's main path) against the jacfwd path. On
    the card both solves run their first LM step eagerly and replay a CUDA
    graph of it for the rest (`sfm/ba.py`): the kernel's runs are read from
    the profiler's trace of the solve, and each of them, replays included,
    is held bit for bit against the plain version on the inputs it was
    given. The times per iteration are a second solve's, unrecorded, whose
    steps all replay the cached graph."""
    from tpu3drec_torch.ops import ba_blocks
    from tpu3drec_torch.sfm import ba

    F, L, O = (64, 8192, 65_536) if gpu else (8, 256, 2_048)
    prob = _ba_problem(rng, dev, F, L, O)
    for blocks in (False, True):  # warm-up: cuSOLVER, the kernel's library
        ba.ba_solve(prob, max_lm_iters=1, cg_iters=10, use_pallas_blocks=blocks)
    sync(dev)
    out = {}
    for blocks in (False, True):
        ba_blocks.reset_launches()
        with recording(ba, "ba_blocks") as calls, replays_recorded(calls), \
                profiled(dev) as prof:
            res = ba.ba_solve(prob, max_lm_iters=12, cg_iters=10, use_pallas_blocks=blocks)
            sync(dev)
        launches, runs = ba_blocks.launches, device_runs(prof, "ba_blocks_kernel")
        if blocks:  # every run of the kernel in the solve, on the inputs it was given
            main_err = hold_against_plain(calls, ba_blocks.ba_blocks_plain, "ba_blocks (solve)")
        check(len(calls) == (res.n_iters if blocks else 0),
              f"{len(calls)} ba_blocks calls recorded in {res.n_iters} LM iterations")
        if gpu:  # the trace counts the kernel's runs; the module's count agrees
            check(runs == len(calls) and launches == runs,
                  f"ba_blocks ran {runs} times in the trace, counted {launches}, "
                  f"recorded {len(calls)}, in {res.n_iters} LM iterations")
        t0 = time.perf_counter()
        timed = ba.ba_solve(prob, max_lm_iters=12, cg_iters=10, use_pallas_blocks=blocks)
        sync(dev)
        secs = time.perf_counter() - t0
        r = ba.residuals(prob._replace(cam_params=res.cam_params, points=res.points))
        out[blocks] = dict(init=float(res.initial_cost), final=float(res.final_cost),
                           iters=res.n_iters, s_per_iter=secs / timed.n_iters,
                           mean_px=float(r.abs().mean()), runs=runs, launches=launches)
    ref, blk = out[False], out[True]
    for name, o in (("jacfwd", ref), ("blocks", blk)):
        check(o["final"] < o["init"], f"{name}: final cost {o['final']} >= initial {o['init']}")
    check(blk["mean_px"] < max(10 * ref["mean_px"], 1e-3),
          f"block path mean residual {blk['mean_px']} vs jacfwd {ref['mean_px']}")
    ph.info.update(problem=f"F={F},L={L},O={O}",
                   jacfwd_s_per_iter=round(ref["s_per_iter"], 4), jacfwd_iters=ref["iters"],
                   blocks_s_per_iter=round(blk["s_per_iter"], 4), blocks_iters=blk["iters"],
                   jacfwd_mean_px=round(ref["mean_px"], 4),
                   blocks_mean_px=round(blk["mean_px"], 4),
                   costs=f"{ref['init']:.1f}->{ref['final']:.1f}|{blk['final']:.1f}",
                   kernel_runs_in_trace=blk["runs"],
                   solve_runs_vs_plain=f"{len(calls)} bit-equal")
    return blk["launches"], main_err


# ---------------------------------------------------------------------------
# phase 8: SfM through sfm_pipeline.run
# ---------------------------------------------------------------------------


def make_sfm_scene(rng, frames: int, h: int, w: int, f: float):
    """Images (F, H, W) in [0, 1] of textured blob constellations (a centre
    dot and three satellites at fixed 3D offsets, amplitudes of their own)
    seen by a camera moving sideways and forward with a slow yaw, and the
    ground-truth world->camera poses. Each dot is splatted only inside its
    own 4-sigma patch."""
    gx, gy = np.meshgrid(np.linspace(-7.0, 9.5, 22), np.linspace(-3.6, 3.6, 20))
    n = gx.size
    X = np.stack([gx.ravel(), gy.ravel(), rng.uniform(9.0, 17.0, n)], -1)
    X[:, :2] += rng.uniform(-0.25, 0.25, (n, 2))
    sats = rng.uniform(-0.14, 0.14, (n, 3, 3))
    amps = rng.uniform(0.4, 1.0, (n, 4))
    P = np.concatenate([X] + [X + sats[:, s] for s in range(3)])
    A = np.concatenate([amps[:, s] for s in range(4)])
    sigma = 2.2 * f / FX
    rad = int(np.ceil(4 * sigma))
    offs = np.arange(-rad, rad + 1)
    poses, images = [], np.zeros((frames, h, w), np.float32)
    for k in range(frames):
        yaw = 0.02 * k
        c, s_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
        C = np.array([0.4 * k, 0.03 * k, 0.25 * k], np.float32)
        t = (-R @ C).astype(np.float32)
        poses.append((R, t))
        Xc = P @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * f + [w / 2, h / 2]
        for (u, v), a, z in zip(uv, A, Xc[:, 2]):
            if z < 0.5 or not (-rad < u < w + rad and -rad < v < h + rad):
                continue
            xs = np.round(u).astype(int) + offs
            ys = np.round(v).astype(int) + offs
            xs, ys = xs[(xs >= 0) & (xs < w)], ys[(ys >= 0) & (ys < h)]
            if xs.size == 0 or ys.size == 0:
                continue
            g = a * np.exp(-((xs[None] - u) ** 2 + (ys[:, None] - v) ** 2) / (2 * sigma ** 2))
            images[k, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] += g
    return np.clip(images, 0, 1), poses, n


def _ate(est, gt):
    """RMS error of camera centres after a similarity (Umeyama) alignment."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, S, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e) / len(est))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    s = np.trace(np.diag(S) @ D) / ((est - mu_e) ** 2).sum(1).mean()
    aligned = s * (est - mu_e) @ (U @ D @ Vt).T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


def phase_sfm(dev, rng, gpu: bool, tmp: str, ph):
    from tpu3drec_torch.core.quaternion import quat_xyzw_to_matrix
    from tpu3drec_torch.ops import matcher
    from tpu3drec_torch.pipelines import sfm_pipeline
    from tpu3drec_torch.utils.plyio import read_ply
    from tpu3drec_torch.utils.poseio import read_pose_txt

    frames, h, w = (12, H, W) if gpu else (12, H // 2, W // 2)
    f = FX if gpu else FX / 2
    t0 = time.perf_counter()
    images, gt, n_landmarks = make_sfm_scene(rng, frames, h, w, f)
    render_s = time.perf_counter() - t0
    K = np.array([[f, 0, w / 2], [0, f * FY / FX, h / 2], [0, 0, 1]], np.float32)
    cfg = sfm_pipeline.SfmPipelineConfig(
        max_keypoints=512 if gpu else 256, overlap=3,
        out_poses=os.path.join(tmp, "sfm_poses.txt"),
        out_sparse_ply=os.path.join(tmp, "sfm_sparse.ply"))
    matcher.reset_launches()
    with recording(matcher, "topk2_scores_batched") as calls:
        t0 = time.perf_counter()
        rec = sfm_pipeline.run(images, K, cfg, device=dev)
        run_s = time.perf_counter() - t0
    launches = matcher.launches
    if gpu:
        check(launches >= 2, f"the matcher kernel was launched {launches} times")
    # what the path's own launches returned, against the plain version on
    # the descriptors and padded valid masks the path gave them; then the
    # kernel's times at that shape
    main = {"max_abs_err": hold_against_plain(calls, matcher.topk2_scores_batched_plain,
                                              "matcher (sfm)")}
    a, b, v = calls[0][0]
    Pm, Km, D = a.shape
    kern = matcher.topk2_scores_batched_cuda if gpu else matcher.topk2_scores_batched_plain
    main["shape"] = [Pm, Km, b.shape[1], D]
    main["splits"] = (_split_info("matcher", matcher.launch_plan(Pm, Km, b.shape[1], dev), dev)
                      if gpu else None)
    main["ms"], main["call_ms"] = kernel_times(lambda: kern(a, b, v), MATCHER_KERNELS, dev,
                                               reps=20 if gpu else 1, warmup=2 if gpu else 0)
    main["plain_ms"] = time_ms(lambda: matcher.topk2_scores_batched_plain(a, b, v), dev,
                               reps=3 if gpu else 1, warmup=1 if gpu else 0)
    main["bound_ms"], main["bound_by"] = _matcher_bound(Pm, Km, b.shape[1], D)
    main["library_ms"] = _matcher_library_ms(a, b, dev) if gpu else None
    records = read_pose_txt(cfg.out_poses)
    sparse, _ = read_ply(cfg.out_sparse_ply)
    reg = rec.registered_frames()
    check([r.frame_id for r in records] == reg, "pose txt rows differ from the registered frames")
    check(sparse.shape == (len(rec.points), 3) and np.isfinite(sparse).all(),
          f"sparse PLY holds {sparse.shape}")
    need = frames - 2
    check(len(reg) >= need, f"registered {len(reg)} of {frames} frames, need {need}")
    est = []
    for r in records:  # camera centres from the file as written
        Rw = quat_xyzw_to_matrix(torch.as_tensor(r.q_xyzw)).numpy()
        est.append(-Rw.T @ r.t)
    est = np.stack(est)
    gtc = np.stack([-gt[k][0].T @ gt[k][1] for k in reg]).astype(np.float64)
    ate = _ate(est, gtc)
    traj = float(np.linalg.norm(np.diff(gtc, axis=0), axis=1).sum())
    check(ate < 0.05 * traj, f"ATE {ate} against a {traj} trajectory")
    ph.info.update(frames=f"{len(reg)}/{frames}", size=f"{h}x{w}", landmarks=n_landmarks,
                   sparse_points=sparse.shape[0], ate=round(ate, 4), traj=round(traj, 3),
                   render_s=round(render_s, 2), run_s=round(run_s, 2),
                   matcher_launches=launches,
                   matcher_calls_vs_plain=f"{len(calls)} bit-equal at {main['shape']}",
                   **{f"{k}_s": round(v, 3) for k, v in rec.seconds.items()})
    return launches, main


# ---------------------------------------------------------------------------
# phase 9: the long-sequence path through tools/ate_torch.py
# ---------------------------------------------------------------------------

# The JAX package's CPU row for m00/150, the port's target
# (docs/ate_runs/m00_150_cpu.json, docs/ate_table.md), and the table's bound.
M00_JAX_CPU = {"ate_pct_traj": 0.60, "coverage": 1.0}
ATE_BOUND_PCT, COVERAGE_BOUND = 2.0, 0.95


def _ate_tool():
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import ate_torch

    return ate_torch


def _rehearsal_sequence(dev):
    """The CPU rehearsal of phase 9: tests/test_kitti_pipeline.py's
    long_capture (16 frames of 256x192), rendered by the port's capture
    simulator with its depth, window 8, stride 4, 256 keypoints."""
    from tpu3drec_torch.data.capture_sim import CaptureSim, SimScene, render_frame
    from tpu3drec_torch.pipelines.kitti import KittiRunConfig, evaluate_sequence, run_windowed_sfm
    from tpu3drec_torch.utils.config import CameraConfig

    t0 = time.perf_counter()
    scene = SimScene.clustered(np.random.default_rng(11), n_landmarks=420, sats=4,
                               extent=((-25, -6, 8), (40, 6, 60)))
    cam = CameraConfig(fx=220.0, fy=220.0, cx=128.0, cy=96.0, width=256, height=192)
    poses = CaptureSim(scene, cam=cam).fly(16, step=np.array([0.55, 0.0, 0.35]), yaw_rate=0.01)
    frames = [render_frame(scene, R, t, cam) for R, t in poses]
    images = np.stack([f[0].mean(-1).astype(np.float32) / 255.0 for f in frames])
    depths = np.stack([f[1] for f in frames])
    gt_T = np.tile(np.eye(4), (len(poses), 1, 1))
    for k, (R, t) in enumerate(poses):
        gt_T[k, :3, :3] = R.T
        gt_T[k, :3, 3] = -R.T @ t
    render_s = time.perf_counter() - t0
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    cfg = KittiRunConfig(window=8, stride=4, max_keypoints=256, loop_closure=True, lc_min_gap=10)
    state = {}
    t0 = time.perf_counter()
    Ts, _ = run_windowed_sfm(images, K, cfg, depth_maps=depths, debug_state=state, device=dev)
    wall = time.perf_counter() - t0
    m = {k: float(v) for k, v in evaluate_sequence(Ts, gt_T).items()}
    m.update(seq="long_capture", frames=len(images), wall_s=wall, render_s=render_s,
             ate_pct_traj=100.0 * m["ate_rms"] / m["traj_len"], stage_s=state["seconds"],
             windows=len(state["window_seconds"]),
             window_s=[None if w is None else sum(w.values()) for w in state["window_seconds"]],
             window_stage_s=_ate_tool()._stage_sums(state["window_seconds"]),
             closures=len(state["closures"]))
    return m


def phase_long_sequence(dev, gpu: bool, ph, frames_path: str):
    """The m00 loop on the card (the rehearsal's small sequence on the
    CPU), every matcher launch recorded; the card's frames are saved to
    ``frames_path``. Returns (launches, the matcher's long-sequence entry
    for the kernels line)."""
    from tpu3drec_torch.ops import matcher

    if gpu:  # the frames are kept for phase 18's 2-process run of them
        t0 = time.perf_counter()
        frames = _ate_tool().render_sequence("m00", 150)
        render_s = time.perf_counter() - t0
        np.savez(frames_path, images=frames[0], depths=frames[1], gt_T=frames[2])
    matcher.reset_launches()
    with recording(matcher, "topk2_scores_batched") as calls:
        if gpu:
            m = _ate_tool().run_sequence("m00", 150, max_keypoints=512, window=12, stride=7,
                                         depth_priors=True, device=dev, frames=frames)
            m["render_s"] = render_s
        else:
            m = _rehearsal_sequence(dev)
    launches = matcher.launches
    st = m["stage_s"]
    win = [w for w in m["window_s"] if w is not None]
    log(f"  {m['seq']}/{m['frames']}: render {m['render_s']:.2f} s, detect {st['detect']:.2f} s, "
        f"windows {st['windows']:.2f} s ({len(win)} of {m['windows']} windows, "
        f"{min(win):.2f}-{max(win):.2f} s each, mean {np.mean(win):.2f} s)")
    log(f"  {m['seq']}/{m['frames']}: windows by stage (summed): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in m["window_stage_s"].items()))
    log(f"  {m['seq']}/{m['frames']}: stitch {st['stitch']:.3f} s, loop closure "
        f"{st['loop_closure']:.3f} s ({m['closures']} closures), pose graph "
        f"{st['pose_graph']:.3f} s, global BA {st['global_ba']:.3f} s, wall {m['wall_s']:.2f} s")
    target = (f"; the JAX package on the CPU: ATE {M00_JAX_CPU['ate_pct_traj']}%, coverage "
              f"{M00_JAX_CPU['coverage']} (docs/ate_runs/m00_150_cpu.json)" if gpu else "")
    log(f"  {m['seq']}/{m['frames']}: ATE {m['ate_rms']} m = {m['ate_pct_traj']}% of "
        f"{m['traj_len']} m, RPE {m['rpe_trans']} m / {m['rpe_rot']} rad, coverage "
        f"{m['coverage']}{target}")
    if gpu:
        check(m["ate_pct_traj"] <= ATE_BOUND_PCT and m["coverage"] >= COVERAGE_BOUND,
              f"m00/150: ATE {m['ate_pct_traj']}% (bound {ATE_BOUND_PCT}%), coverage "
              f"{m['coverage']} (bound {COVERAGE_BOUND})")
        check(launches >= 2, f"the matcher kernel was launched {launches} times")
    else:  # tests/test_kitti_pipeline.py's bars
        check(m["ate_pct_traj"] < 5.0 and m["coverage"] > 0.9, f"long_capture: {m}")
    # every launch of the run against the plain version on its own inputs,
    # then the kernel timed at the largest shape the run gave it
    shapes = {}
    for args, _ in calls:
        key = "x".join(str(d) for d in (args[0].shape[0], args[0].shape[1], args[1].shape[1]))
        shapes[key] = shapes.get(key, 0) + 1
    long_seq = {"launches": launches, "calls_by_shape": shapes,
                "max_abs_err": hold_against_plain(calls, matcher.topk2_scores_batched_plain,
                                                  "matcher (long sequence)")}
    a, b, v = max((c[0] for c in calls), key=lambda x: x[0].shape[0])
    P, Ka, D = a.shape
    kern = matcher.topk2_scores_batched_cuda if gpu else matcher.topk2_scores_batched_plain
    long_seq["shape"] = [P, Ka, b.shape[1], D]
    long_seq["splits"] = (_split_info("matcher", matcher.launch_plan(P, Ka, b.shape[1], dev), dev)
                          if gpu else None)
    long_seq["ms"], long_seq["call_ms"] = kernel_times(
        lambda: kern(a, b, v), MATCHER_KERNELS, dev, reps=20 if gpu else 1, warmup=2 if gpu else 0)
    long_seq["plain_ms"] = time_ms(lambda: matcher.topk2_scores_batched_plain(a, b, v), dev,
                                   reps=3 if gpu else 1, warmup=1 if gpu else 0)
    long_seq["bound_ms"], long_seq["bound_by"] = _matcher_bound(P, Ka, b.shape[1], D)
    long_seq["library_ms"] = _matcher_library_ms(a, b, dev) if gpu else None
    del calls[:]
    ph.info.update(seq=m["seq"], frames=m["frames"], ate=m["ate_rms"],
                   ate_pct=m["ate_pct_traj"], coverage=m["coverage"], wall_s=round(m["wall_s"], 2),
                   render_s=round(m["render_s"], 2), matcher_launches=launches,
                   matcher_calls_vs_plain=f"{sum(shapes.values())} bit-equal at {shapes}")
    long_seq["run"] = m
    return launches, long_seq


# ---------------------------------------------------------------------------
# phase 10: the monocular depth path (no kernel of the port on it)
# ---------------------------------------------------------------------------


def _convergence_tool():
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import train_convergence_torch

    return train_convergence_torch


def _tree_max_diff(a: dict, b: dict, keys) -> float:
    return max(float((a[k].double().cpu() - b[k].double().cpu()).abs().max()) for k in keys)


def phase_monocular(dev, gpu: bool, tmp: str, ph, seed: int):
    """Config 4 on the card: 12 rendered frames, 10 GT-pose steps and one
    pose-net step of the full MonodepthModel at batch 1, the first step
    held against the same step on the CPU, warm step times in float32 and
    bfloat16, depth inference at two sizes (one frame held against the
    CPU), and the inferred depth fused into a map. Returns the line's
    numbers."""
    import copy

    import torch.nn.functional as F
    from scipy.spatial.transform import Rotation

    from tpu3drec_torch.models.training import (
        TrainConfig, init_state, make_eval_depth, make_optimizer, make_train_step)
    from tpu3drec_torch.pipelines import rgbd
    from tpu3drec_torch.pipelines.monocular import infer_depth_maps
    from tpu3drec_torch.utils.config import CameraConfig, MapConfig, RGBDPipelineConfig
    from tpu3drec_torch.utils.plyio import read_ply

    _reset_kernel_counts()
    h, w, frames, steps, timed = (480, 640, 12, 10, 7) if gpu else (64, 96, 4, 3, 1)
    tool = _convergence_tool()
    t0 = time.perf_counter()
    rgbs, gt_depth, poses = tool.make_dataset(h, w, n_frames=frames, workers=8 if gpu else 2)
    render_s = time.perf_counter() - t0
    rows = [tool.relative_pose_rows(poses, f, f - 1) + tool.relative_pose_rows(poses, f, f + 1)
            for f in range(1, frames - 1)]
    out = {"size": f"{h}x{w}", "frames": frames, "render_s": round(render_s, 2)}

    def batch_at(i):  # target frame i + 1, batch 1 (the reference's default)
        aa_p, t_p, aa_n, t_n = rows[i]
        return {"target": rgbs[i + 1: i + 2], "prev": rgbs[i: i + 1], "next": rgbs[i + 2: i + 3],
                "gt_axisangle": np.stack([aa_p, aa_n])[None],
                "gt_translation": np.stack([t_p, t_n])[None]}

    cfg = TrainConfig(height=h, width=w, use_gt_pose=True)
    model, state = init_state(seed, cfg, 1000, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    step_fn = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    # the first step on the card and on the CPU: same weights, batch, noise
    cpu_model, cpu_state = init_state(seed, cfg, 1000, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    noise = np.random.default_rng(seed).standard_normal((2, 1, h, w)).astype(np.float32)
    b0 = batch_at(0)
    before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
    t0 = time.perf_counter()
    cpu_state, cpu_loss, _ = step_fn(cpu_state, b0, noise=noise)
    cpu_step_s = time.perf_counter() - t0
    state, loss, _ = step_fn(state, b0, noise=noise)
    sync(dev)
    lr = cfg.learning_rate
    sd, cpu_sd = model.state_dict(), cpu_model.state_dict()
    stats = [k for k in sd if "running_" in k]
    card_p, cpu_p = dict(model.named_parameters()), dict(cpu_model.named_parameters())
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    # the backward: which tensors got a gradient, and how far the card's and
    # the CPU's float32 gradients are from the same step's in float64 (on
    # the card), as a share of the gradient's norm. At this step float32's
    # rounding reaches the gradients magnified: measured on an H100 0.208
    # through cuDNN's convolutions, 0.021 through PyTorch's own CUDA ones,
    # 0.022 on the CPU (tools/grad_accuracy_torch.py); a wrong backward is
    # off by the gradient's own size
    with_grad = [k for k, p in card_p.items() if p.grad is not None]
    ref_model, ref_state = init_state(seed, cfg, 1000, device=dev)
    ref_model.load_state_dict(before, strict=False)
    ref_model.double()
    step_fn(ref_state, b0, noise=noise)
    g64 = {k: p.grad.cpu() for k, p in ref_model.named_parameters() if p.grad is not None}
    del ref_model, ref_state

    def grad_err(grads):
        return math.sqrt(sum(float((grads[k].grad.cpu().double() - g64[k]).square().sum())
                             for k in with_grad) / sum(float(g.square().sum())
                                                       for g in g64.values()))

    grad_err_card, grad_err_cpu = grad_err(card_p), grad_err(cpu_p)
    # Adam: the card's update against torch's single-tensor Adam on the CPU
    # fed the card's own gradients, within 1e-3 of lr plus 4 float32 ulps
    replay = {k: before[k].clone().requires_grad_(True) for k in with_grad}
    for k, r in replay.items():
        r.grad = card_p[k].grad.detach().cpu()
    make_optimizer(cfg, list(replay.values())).step()
    ulp = torch.finfo(torch.float32).eps
    adam_excess = max(float(((sd[k].cpu() - r.detach()).abs()
                             - (1e-3 * lr + 4 * ulp * r.detach().abs())).max())
                      for k, r in replay.items())
    # the updates against the CPU's: the same tensors moved; the elements more
    # than 1% of lr apart are reported (Adam's first step is lr times the sign
    # of the gradient, which flips wherever the gradient is within float32's
    # rounding of 0: measured 4.8% of the model here on an H100)
    moved_apart = [k for k in card_p
                   if (float((sd[k].cpu() - before[k]).abs().max()) > 0.5 * lr)
                   != (float((cpu_sd[k] - before[k]).abs().max()) > 0.5 * lr)]
    off = {k: int(((sd[k].cpu() - cpu_sd[k]).abs() > 1e-2 * lr).sum()) for k in card_p}
    worst = max(off, key=lambda k: off[k] / sd[k].numel())
    out.update(loss=float(loss), cpu_loss=float(cpu_loss), loss_rel_diff=loss_rel,
               grad_err_card=grad_err_card, grad_err_cpu=grad_err_cpu, adam_excess=adam_excess,
               param_max_diff=_tree_max_diff(sd, cpu_sd, list(card_p)),
               params_off=sum(off.values()),
               worst_tensor_off=f"{worst} {off[worst]}/{sd[worst].numel()}",
               batch_stats_max_diff=_tree_max_diff(sd, cpu_sd, stats),
               lr=lr, cpu_step_s=round(cpu_step_s, 2), parameters=n_params)
    log("  first step, card against CPU: " + json.dumps(
        {k: out[k] for k in ("loss_rel_diff", "grad_err_card", "grad_err_cpu", "adam_excess",
                             "param_max_diff", "params_off", "worst_tensor_off",
                             "batch_stats_max_diff")}))
    check(np.isfinite(float(loss)), f"loss {float(loss)}")
    check(loss_rel <= 1e-4, f"card and CPU losses differ by {loss_rel} relative")
    check(out["batch_stats_max_diff"] <= 1e-4,
          f"batch stats differ by {out['batch_stats_max_diff']}")
    check(with_grad == [k for k, p in cpu_p.items() if p.grad is not None] == list(g64),
          "the card, the CPU and the float64 step gave gradients to different tensors")
    check(grad_err_card <= 0.5, f"the card's gradients are {grad_err_card} of their norm from "
          f"float64's (the CPU's {grad_err_cpu})")
    check(adam_excess <= 0, f"the card's Adam update is {adam_excess} past the CPU's on the "
          "card's gradients")
    check(not moved_apart, f"moved on one device only: {moved_apart}")
    del before, replay, cpu_model, cpu_state

    # the remaining GT-pose steps, the last `timed` of them timed
    def timed_steps(st, fn, first, n_warm, n_timed, rng):
        for i in range(first, first + n_warm):
            st, _, _ = fn(st, batch_at(i % len(rows)), rng)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        losses = []

        def run():
            nonlocal st
            for i in range(first + n_warm, first + n_warm + n_timed):
                st, l_, _ = fn(st, batch_at(i % len(rows)), rng)
                losses.append(l_)

        ms = time_ms(run, dev, reps=1, warmup=0) / n_timed
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None
        return st, ms, peak, [float(x) for x in losses]

    state, ms32, peak32, losses = timed_steps(state, step_fn, 1, steps - 1 - timed, timed, gen)
    check(state.step == steps and all(np.isfinite(losses)), f"losses {losses}")
    out.update(steps=state.step, last_loss=losses[-1], train_ms_f32=ms32, peak_gib_f32=peak32)

    # one pose-net step on the same model (the pose net's first gradients)
    pcfg = TrainConfig(height=h, width=w)
    state, ploss, _ = make_train_step(pcfg)(state, batch_at(steps % len(rows)), gen)
    check(np.isfinite(float(ploss)), f"pose-net loss {float(ploss)}")
    out.update(pose_net_loss=float(ploss))

    # bfloat16: a model of its own, warm steps timed
    bcfg = TrainConfig(height=h, width=w, use_gt_pose=True, compute_dtype="bfloat16")
    _, bstate = init_state(seed, bcfg, 1000, device=dev)
    bstate, ms16, peak16, blosses = timed_steps(bstate, make_train_step(bcfg), 0, 2, timed, gen)
    check(all(np.isfinite(blosses)), f"bf16 losses {blosses}")
    out.update(train_ms_bf16=ms16, peak_gib_bf16=peak16, bf16_last_loss=blosses[-1])
    del bstate

    # serving: depth of the 12 frames at 480x640, and at 192x640 (batch 8)
    u8 = (rgbs * 255).round().astype(np.uint8)
    small = F.interpolate(torch.as_tensor(rgbs).permute(0, 3, 1, 2), size=(h * 2 // 5, w),
                          mode="bilinear", align_corners=False, antialias=True)
    small = small.permute(0, 2, 3, 1).contiguous().numpy()
    for name, imgs in ((f"{h}x{w}", u8), (f"{h * 2 // 5}x{w}", small)):
        icfg = TrainConfig(height=imgs.shape[1], width=imgs.shape[2])
        infer_depth_maps(model, imgs, icfg, batch=8)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        depth = infer_depth_maps(model, imgs, icfg, batch=8)
        secs = time.perf_counter() - t0
        check(depth.shape == (frames,) + imgs.shape[1:3] and np.isfinite(depth).all()
              and (depth > 0).all(), f"depth {depth.shape} at {name}")
        out[f"infer_fps_{name}"] = frames / secs
        if imgs is u8:
            served = depth
    cpu_model = copy.deepcopy(model).cpu()
    one = make_eval_depth(cpu_model, cfg)(torch.as_tensor(u8[:1].astype(np.float32) / 255.0))
    depth_rel = float(np.abs(served[0] - one[0].numpy()).max() / np.abs(one[0].numpy()).max())
    out["depth_rel_diff"] = depth_rel
    check(depth_rel <= 1e-4, f"card and CPU depth differ by {depth_rel} relative")

    # fusion: the inferred depth and the ground-truth poses -> PLY + .bt
    q = np.stack([Rotation.from_matrix(R.astype(np.float64)).as_quat() for R, _ in poses])
    t = np.stack([tv for _, tv in poses])
    fcfg = RGBDPipelineConfig(
        camera=CameraConfig(fx=cfg.loss.fx, fy=cfg.loss.fy, cx=cfg.loss.cx, cy=cfg.loss.cy,
                            width=w, height=h),
        map=MapConfig(voxel_res=0.1, ply_binary=True),
        out_ply=os.path.join(tmp, "mono.ply"), out_bt=os.path.join(tmp, "mono.bt"))
    res = rgbd.run_arrays(served, q.astype(np.float32), t.astype(np.float32), fcfg, device=dev)
    pts, _ = read_ply(fcfg.out_ply)
    check(res.n_points > 0 and pts.shape == (res.n_points, 3) and np.isfinite(pts).all(),
          f"fused map holds {pts.shape}")
    check(res.n_voxels > 0 and os.path.getsize(fcfg.out_bt) > 0, "empty .bt")
    out.update(fused_points=res.n_points, fused_voxels=res.n_voxels,
               run_arrays_s=round(res.seconds, 3))
    out["kernel_launches"] = _kernel_counts()
    check(not any(out["kernel_launches"].values()),
          f"the monocular path launched kernels: {out['kernel_launches']}")
    ph.info.update({k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in out.items()
                    if not isinstance(v, dict)})
    return out


# ---------------------------------------------------------------------------
# phase 11: stereo, configuration 3 (no kernel of the port on it)
# ---------------------------------------------------------------------------


def _stereo_tool():
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import stereo_convergence_torch

    return stereo_convergence_torch


def device_launches(fn, dev) -> int | None:
    """Kernels the card ran in one call of ``fn`` (torch.profiler's CUDA
    activity); None on the CPU."""
    if dev.type != "cuda":
        return None
    sync(dev)
    with profiled(dev) as prof:
        fn()
        sync(dev)
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def _look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    """world->cam (R, t) of a camera at ``eye`` looking at ``target`` (x
    right, y down, z forward)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return R.astype(np.float32), (-R @ eye).astype(np.float32)


def phase_stereo(dev, gpu: bool, tmp: str, ph, seed: int, pool):
    """Config 3 on the card: PSMNet trained through the CLI (`train-stereo
    --sim`) at StereoTrainConfig's published size, the first step held
    against the CPU and a float64 run, warm step times in float32 and
    bfloat16, then `pipelines/stereo.run` of the trained model on 12 pairs
    at 480x640 with the reference camera into PLY + .bt. Frames are
    rendered in ``pool`` (None: here). Returns the line's numbers."""
    from scipy.spatial.transform import Rotation

    from tpu3drec_torch.data.capture_sim import PlanarScene
    from tpu3drec_torch.models.psmnet import stereo_infer
    from tpu3drec_torch.models.psmnet_training import (
        StereoTrainConfig, init_stereo_state, make_stereo_train_step, to_model)
    from tpu3drec_torch.models.training import make_optimizer
    from tpu3drec_torch.pipelines import cli, stereo
    from tpu3drec_torch.utils.config import CameraConfig, MapConfig, RGBDPipelineConfig
    from tpu3drec_torch.utils.plyio import read_ply

    _reset_kernel_counts()
    tool = _stereo_tool()
    # the published training size, and the reference camera's for inference
    (th, tw, md, n_sim), (ih, iw, n_pairs) = (((256, 512, 64, 4), (H, W, 12)) if gpu
                                              else ((32, 64, 16, 2), (48, 64, 3)))
    out = {"train_size": f"{th}x{tw}", "batch": 4 if gpu else 2, "max_disp": md, "feat_ch": 32}
    log_dir = os.path.join(tmp, "stereo")
    device_flag = [] if gpu else ["--device", "cpu"]
    t0 = time.perf_counter()
    cli.main(device_flag + ["train-stereo", "--sim", str(n_sim), "--height", str(th), "--width",
                            str(tw), "--max-disp", str(md), "--batch-size", str(out["batch"]),
                            "--epochs", "3", "--log-dir", log_dir])
    out["cli_train_s"] = round(time.perf_counter() - t0, 2)
    cfg = StereoTrainConfig(height=th, width=tw, batch_size=out["batch"], max_disp=md)
    out["cli_steps"] = 3 * (n_sim // out["batch"])
    check(os.path.exists(os.path.join(log_dir, "ckpt", f"{out['cli_steps']}.pt")),
          f"train-stereo left no checkpoint of step {out['cli_steps']}")
    trained = stereo.load_trained(log_dir, cfg, device=dev)

    # the first step on the card, on the CPU and in float64 on the card
    t0 = time.perf_counter()
    lefts, rights, disps, masks = tool.make_dataset(th, tw, n_frames=8, pool=pool)
    out["render_train_s"] = round(time.perf_counter() - t0, 2)
    masks = masks * (disps < md - 1)
    batch = {"left": lefts[:out["batch"]], "right": rights[:out["batch"]],
             "disp": disps[:out["batch"]], "mask": masks[:out["batch"]]}
    step_fn = make_stereo_train_step(cfg)
    model, state = init_stereo_state(seed, cfg, device=dev)
    cpu_model, cpu_state = init_stereo_state(seed, cfg, device="cpu")
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    cpu_state, cpu_loss = step_fn(cpu_state, batch)
    out["cpu_step_s"] = round(time.perf_counter() - t0, 2)
    state, loss = step_fn(state, batch)
    sync(dev)
    sd, cpu_sd = model.state_dict(), cpu_model.state_dict()
    stats = [k for k in sd if "running_" in k]
    card_p, cpu_p = dict(model.named_parameters()), dict(cpu_model.named_parameters())
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    ref_model, ref_state = init_stereo_state(seed, cfg, device=dev)
    ref_model.double()
    step_fn(ref_state, batch)
    g64 = {k: p.grad.cpu() for k, p in ref_model.named_parameters()}
    del ref_model, ref_state
    norm64 = math.sqrt(sum(float(g.square().sum()) for g in g64.values()))

    def grad_err(params):
        return math.sqrt(sum(float((p.grad.cpu().double() - g64[k]).square().sum())
                             for k, p in params.items())) / norm64

    grad_err_card, grad_err_cpu = grad_err(card_p), grad_err(cpu_p)
    replay = {k: before[k].clone().requires_grad_(True) for k in card_p}
    for k, r in replay.items():
        r.grad = card_p[k].grad.detach().cpu()
    make_optimizer(cfg, list(replay.values())).step()
    ulp = torch.finfo(torch.float32).eps
    lr = cfg.learning_rate
    adam_excess = max(float(((sd[k].cpu() - r.detach()).abs()
                             - (1e-3 * lr + 4 * ulp * r.detach().abs())).max())
                      for k, r in replay.items())
    out.update(loss=float(loss), loss_rel_diff=loss_rel, grad_err_card=grad_err_card,
               grad_err_cpu=grad_err_cpu, adam_excess=adam_excess,
               batch_stats_max_diff=_tree_max_diff(sd, cpu_sd, stats),
               parameters=sum(p.numel() for p in model.parameters()))
    log("  stereo first step, card against CPU: " + json.dumps(
        {k: out[k] for k in ("loss_rel_diff", "grad_err_card", "grad_err_cpu", "adam_excess",
                             "batch_stats_max_diff")}))
    check(np.isfinite(float(loss)), f"loss {float(loss)}")
    check(loss_rel <= 1e-4, f"card and CPU stereo losses differ by {loss_rel} relative")
    check(out["batch_stats_max_diff"] <= 1e-4,
          f"stereo batch stats differ by {out['batch_stats_max_diff']}")
    check(grad_err_card <= STEREO_GRAD_BOUND,
          f"the card's stereo gradients are {grad_err_card} of their norm from float64's "
          f"(the CPU's {grad_err_cpu})")
    check(adam_excess <= 0, f"the card's Adam update is {adam_excess} past the CPU's on the "
          "card's gradients")
    del cpu_model, cpu_state, replay, before

    # warm steps, float32 (IEEE) and bfloat16 each in a model of its own
    n_warm, n_timed = (2, 5) if gpu else (0, 1)
    batches = [{k: v[i * out["batch"]:(i + 1) * out["batch"]] for k, v in
                (("left", lefts), ("right", rights), ("disp", disps), ("mask", masks))}
               for i in range(len(lefts) // out["batch"])]
    for dtype in ("float32", "bfloat16"):
        dcfg = StereoTrainConfig(height=th, width=tw, batch_size=out["batch"], max_disp=md,
                                 compute_dtype=dtype)
        dfn = make_stereo_train_step(dcfg)
        _, dstate = init_stereo_state(seed, dcfg, device=dev)
        for i in range(n_warm):
            dstate, _ = dfn(dstate, batches[i % len(batches)])
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        losses = []

        def run():
            nonlocal dstate
            for i in range(n_timed):
                dstate, l_ = dfn(dstate, batches[i % len(batches)])
                losses.append(l_)

        tag = "f32" if dtype == "float32" else "bf16"
        out[f"train_ms_{tag}"] = time_ms(run, dev, reps=1, warmup=0) / n_timed
        out[f"peak_gib_{tag}"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                  if dev.type == "cuda" else None)

        def one():
            nonlocal dstate
            dstate, _ = dfn(dstate, batches[0])

        out[f"launches_per_step_{tag}"] = device_launches(one, dev)
        check(all(np.isfinite(float(x)) for x in losses), f"{dtype} stereo losses {losses}")
        del dstate

    # inference: the trained model on 12 pairs at 480x640, reference camera
    rng = np.random.default_rng(seed + 11)
    scene = PlanarScene.urban(rng, n_boxes=12, extent=35.0)
    fx, fy, cx, cy = (FX, FY, CX, CY) if gpu else (FX / 10, FY / 10, iw / 2, ih / 2)
    cam = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, width=iw, height=ih)
    poses = []
    for f in range(n_pairs):
        R = Rotation.from_rotvec([0, 0.02 * f, 0]).as_matrix().astype(np.float32)
        C = np.array([0.4 * f, -1.2, 0.8 * f], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    t0 = time.perf_counter()
    il, ir, _, _ = tool.render_pairs(scene, poses, cam, 0.1, pool)
    out["render_infer_s"] = round(time.perf_counter() - t0, 2)
    stereo.infer_disparity(trained, il[:4], ir[:4], batch=4)  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    disp = stereo.infer_disparity(trained, il, ir, batch=4)
    out["infer_fps"] = n_pairs / (time.perf_counter() - t0)
    check(disp.shape == (n_pairs, ih, iw) and np.isfinite(disp).all(), f"disparity {disp.shape}")
    cpu_trained = stereo.load_trained(log_dir, cfg, device="cpu")
    one_cpu = stereo_infer(cpu_trained, to_model(cpu_trained, il[:1], image=True),
                           to_model(cpu_trained, ir[:1], image=True)).numpy()[0]
    disp_rel = float(np.abs(disp[0] - one_cpu).max() / max(np.abs(one_cpu).max(), 1e-6))
    out["disp_rel_diff"] = disp_rel
    check(disp_rel <= 1e-4, f"card and CPU disparity differ by {disp_rel} relative")
    q = np.stack([Rotation.from_matrix(R.astype(np.float64)).as_quat() for R, _ in poses])
    t = np.stack([tv for _, tv in poses])
    scfg = stereo.StereoPipelineConfig(
        rgbd=RGBDPipelineConfig(camera=cam, map=MapConfig(voxel_res=0.1, ply_binary=True),
                                out_ply=os.path.join(tmp, "stereo.ply"),
                                out_bt=os.path.join(tmp, "stereo.bt")))
    t0 = time.perf_counter()
    res = stereo.run(scfg, il, ir, q.astype(np.float32), t.astype(np.float32), model=trained,
                     device=dev)
    out["run_s"] = round(time.perf_counter() - t0, 3)
    pts, _ = read_ply(scfg.rgbd.out_ply)
    check(res.n_points > 0 and pts.shape == (res.n_points, 3) and np.isfinite(pts).all(),
          f"stereo map holds {pts.shape}")
    check(res.n_voxels > 0 and os.path.getsize(scfg.rgbd.out_bt) > 0, "empty stereo .bt")
    out.update(pairs=n_pairs, infer_size=f"{ih}x{iw}", fused_points=res.n_points,
               fused_voxels=res.n_voxels)
    out["kernel_launches"] = _kernel_counts()
    check(not any(out["kernel_launches"].values()),
          f"the stereo path launched kernels: {out['kernel_launches']}")
    ph.info.update({k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in out.items()
                    if not isinstance(v, dict)})
    return out


# ---------------------------------------------------------------------------
# phase 12: dense MVS (no kernel of the port on it)
# ---------------------------------------------------------------------------


def phase_mvs(dev, gpu: bool, tmp: str, ph, seed: int, pool, keep: dict):
    """The dense MVS path on the card: `run_mvs` on 12 rendered views of the
    urban scene at 480x640 with the reference camera and MvsConfig's
    defaults (96 planes, 4 sources, window 5; the depth range set to the
    scene's), the seconds of each stage, the grid and mesh sizes, the share
    of mesh vertices within 3 voxels of the rendered surface (>= 0.9), and
    one view's plane sweep held against the CPU. Returns the line's
    numbers; ``keep`` receives the TSDF's inputs (masked depths, K, poses,
    the grid's origin, dims, voxel size and band) for phase 17."""
    from scipy.spatial import cKDTree

    from tpu3drec_torch.data.capture_sim import PlanarScene
    from tpu3drec_torch.mvs.plane_sweep import plane_sweep_depth
    from tpu3drec_torch.pipelines.mvs import MvsConfig, run_mvs, select_source_views
    from tpu3drec_torch.utils.config import CameraConfig
    from tpu3drec_torch.utils.plyio import read_ply_mesh, write_ply_mesh

    _reset_kernel_counts()
    tool = _stereo_tool()
    # the test scene of tests/test_mvs.py, seen by the reference camera
    h, w, n_views = (H, W, 12) if gpu else (96, 128, 6)
    fx, fy, cx, cy = (FX, FY, CX, CY) if gpu else (110.0, 110.0, 64.0, 48.0)
    cam = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)
    scene = PlanarScene.urban(np.random.default_rng(7), n_boxes=6, extent=18.0)
    poses = [_look_at(np.array([-2.5 + i * 6.0 / max(n_views - 1, 1), -1.2, -16.0 + 0.3 * i]),
                      target=(0.0, 0.0, 12.0)) for i in range(n_views)]
    t0 = time.perf_counter()
    views = tool.render_jobs([(scene, R, t, cam, None) for R, t in poses], pool)
    out = {"size": f"{h}x{w}", "views": n_views, "render_s": round(time.perf_counter() - t0, 2)}
    imgs = np.stack([rgb.mean(-1).astype(np.float32) / 255.0 for rgb, _ in views])
    gt = np.stack([d for _, d in views])
    Rs = np.stack([R for R, _ in poses])
    ts = np.stack([t for _, t in poses])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    # the scene's depth range; at the rehearsal's 96x128 the voxels and the
    # ZNCC bar of tests/test_mvs.py's end-to-end run (auto voxels of median
    # depth / 100 are finer than 128 pixels across resolve)
    cfg = (MvsConfig(d_min=4.0, d_max=60.0) if gpu
           else MvsConfig(d_min=4.0, d_max=60.0, voxel_res=0.35, min_zncc=0.6))
    out.update(n_planes=cfg.n_planes, n_src=cfg.n_src, window=cfg.window)
    run_mvs(imgs[:3], K, Rs[:3], ts[:3], MvsConfig(d_min=4.0, d_max=60.0, n_planes=8),
            device=dev)  # warm-up: the first call's allocations
    sync(dev)
    t0 = time.perf_counter()
    res = run_mvs(imgs, K, Rs, ts, cfg, device=dev)
    out["run_mvs_s"] = round(time.perf_counter() - t0, 3)
    out.update({k: round(v, 3) for k, v in res["timings"].items()})
    out["sweep_ms_per_view"] = 1e3 * res["timings"]["sweep_s"] / n_views
    grid = res["grid"]
    keep.update(tsdf_depths=np.where(res["masks"], res["depths"], 0.0).astype(np.float32),
                tsdf_K=K, tsdf_R=Rs.astype(np.float32), tsdf_t=ts.astype(np.float32),
                tsdf_origin=grid.origin, tsdf_dims=np.array(grid.tsdf.shape),
                tsdf_res=np.array(grid.res), tsdf_trunc=np.array(grid.trunc))
    out.update(grid=list(grid.tsdf.shape), grid_res=round(grid.res, 4),
               grid_bytes=2 * grid.tsdf.numel() * grid.tsdf.element_size(),
               points=int(res["points"].shape[0]), verts=int(res["verts"].shape[0]),
               faces=int(res["faces"].shape[0]))
    check(out["faces"] > 200, f"the mesh has {out['faces']} faces")
    mesh = os.path.join(tmp, "mvs_mesh.ply")
    write_ply_mesh(mesh, res["verts"], res["faces"], binary=True)
    v2, f2 = read_ply_mesh(mesh)
    check(v2.shape == res["verts"].shape and f2.shape == res["faces"].shape, "mesh PLY")
    # accuracy: mesh vertices against the rendered surface, as
    # tests/test_mvs.py::test_mvs_pipeline_e2e measures it
    gt_pts = []
    for f in range(n_views):
        v, u = np.nonzero(gt[f] > 0)
        z = gt[f][v, u]
        p = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], 1) - ts[f]
        gt_pts.append(p @ Rs[f])
    dist, _ = cKDTree(np.concatenate(gt_pts)).query(res["verts"], k=1)
    out["within_3_voxels"] = float((dist < 3 * grid.res).mean())
    check(out["within_3_voxels"] >= 0.9,
          f"only {out['within_3_voxels']:.3f} of mesh vertices within 3 voxels of the surface")
    # one view's sweep, card against CPU
    ref = n_views // 2
    src = select_source_views(Rs, ts, ref, cfg.n_src)
    args = (imgs[ref], imgs[src], K, Rs[ref], ts[ref], Rs[src], ts[src], cfg.d_min, cfg.d_max)
    t0 = time.perf_counter()
    cd, cz, cn = (x.numpy() for x in plane_sweep_depth(*args, n_planes=cfg.n_planes,
                                                        window=cfg.window, device="cpu"))
    out["cpu_sweep_s"] = round(time.perf_counter() - t0, 2)
    gd, gz, gn = (x.cpu().numpy() for x in plane_sweep_depth(*args, n_planes=cfg.n_planes,
                                                              window=cfg.window, device=dev))
    step = (1.0 / cfg.d_min - 1.0 / cfg.d_max) / (cfg.n_planes - 1)

    def plane(d):
        d = d.astype(np.float64)
        return np.where(d > 0, (1.0 / np.maximum(d, 1e-12) - 1.0 / cfg.d_max) / step, -1.0)

    agree = np.abs(plane(cd) - plane(gd)) < 0.5
    rel = (np.abs(gd.astype(np.float64) - cd) / np.maximum(cd, 1e-6))[agree]
    dz = np.abs(gz - cz)[agree]
    out.update(sweep_winners_agree=float(agree.mean()), sweep_nvalid_equal=float((cn == gn).mean()),
               sweep_zncc_p99=float(np.quantile(dz, 0.99)), sweep_zncc_max=float(dz.max()),
               sweep_bit_equal=float(((gd == cd) & (gz == cz) & (gn == cn)).mean()),
               sweep_depth_within_1e5=float((rel <= 1e-5).mean()),
               sweep_depth_rel_p99=float(np.quantile(rel, 0.99)),
               sweep_depth_rel_max=float(rel.max()))
    keys = ("sweep_bit_equal", "sweep_winners_agree", "sweep_nvalid_equal", "sweep_zncc_p99",
            "sweep_zncc_max", "sweep_depth_within_1e5", "sweep_depth_rel_p99",
            "sweep_depth_rel_max")
    log("  mvs sweep, card against CPU: " + json.dumps({k: out[k] for k in keys}))
    # tests/test_torch_mvs.py's bounds for the port against the JAX package
    check(out["sweep_winners_agree"] >= 0.995 and out["sweep_nvalid_equal"] >= 0.995
          and out["sweep_zncc_p99"] <= 1e-4 and out["sweep_depth_within_1e5"] >= 0.95
          and out["sweep_depth_rel_p99"] <= 1e-4, "card and CPU plane sweeps differ")
    out["kernel_launches"] = _kernel_counts()
    check(not any(out["kernel_launches"].values()),
          f"the MVS path launched kernels: {out['kernel_launches']}")
    ph.info.update({k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in out.items()
                    if not isinstance(v, (dict, list))})
    return out


# ---------------------------------------------------------------------------
# phases 13-16: occupancy, point-to-plane ICP, serve, mission-sim
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def timed(owner, names, dev):
    """Wraps ``owner.<name>`` for each name with a timer that synchronizes
    the device before and after; yields {name: [seconds of each call]}.
    Fails if a name was never called, so that a renamed or bypassed stage
    cannot leave its timing silently empty."""
    secs = {n: [] for n in names}

    def wrap(n, fn):
        def wrapped(*args, **kw):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(dev)
            secs[n].append(time.perf_counter() - t0)
            return out
        return wrapped

    with patched(owner, names, wrap):
        yield secs
    missing = [n for n in names if not secs[n]]
    check(not missing, f"{getattr(owner, '__name__', owner)}: {missing} never called")


def _kernel_counts():
    from tpu3drec_torch.ops import ba_blocks, icp_nn, matcher

    return {k.__name__.rsplit(".", 1)[-1]: k.launches for k in (icp_nn, matcher, ba_blocks)}


def _reset_kernel_counts():
    from tpu3drec_torch.ops import ba_blocks, icp_nn, matcher

    for k in (icp_nn, matcher, ba_blocks):
        k.reset_launches()


def phase_occupancy(dev, gpu: bool, tmp: str, ph, depths, q32, t32, cfg):
    """`occupancy` through the CLI on phase 4's frames stored as .npy depth
    (the reference camera, 0.1 m, 128 samples, 50 m range): seconds per
    scan split into the device scan and the merge, occupied and free voxel
    counts, peak memory; then the first 2 frames through the same CLI on
    the card and on the CPU, whose `.bt` files must be byte-equal."""
    from tpu3drec_torch.mapping import occupancy
    from tpu3drec_torch.mapping.btio import read_bt
    from tpu3drec_torch.pipelines import cli
    from tpu3drec_torch.utils.config import save_json
    from tpu3drec_torch.utils.poseio import PoseRecord, write_pose_txt

    ddir = os.path.join(tmp, "depth_npy")
    os.makedirs(ddir)
    for f in range(len(depths)):
        np.save(os.path.join(ddir, f"{f}.npy"), depths[f])
    poses = {}
    for n in (len(depths), 2):
        poses[n] = os.path.join(tmp, f"occ_poses_{n}.txt")
        write_pose_txt(poses[n], [PoseRecord(f, t32[f], q32[f], f"{f}.npy") for f in range(n)])
    ocfg = dataclasses.replace(cfg, out_ply="", out_bt="",
                               depth=dataclasses.replace(cfg.depth, mode="npy"))
    cfg_path = os.path.join(tmp, "occ_cfg.json")
    save_json(ocfg, cfg_path)

    def run(n, device_flag, out):
        cli.main(device_flag + ["occupancy", "--config", cfg_path, "--poses", poses[n],
                                "--depth-dir", ddir, "--res", "0.1", "--max-samples", "128",
                                "--max-range", "50", "--out", out])

    _reset_kernel_counts()
    card = [] if gpu else ["--device", "cpu"]
    full = os.path.join(tmp, "occ_full.bt")
    if gpu:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with timed(occupancy.OccupancyMap, ("_scan", "_merge"), dev) as secs:
        run(len(depths), card, full)
    wall = time.perf_counter() - t0
    occ, free, res = read_bt(full, with_free=True)
    check(res == 0.1 and len(occ) > 0 and len(free) > len(occ),
          f"occupancy .bt holds {len(occ)} occupied and {len(free)} free voxels at {res}")
    out = {"frames": len(depths), "size": f"{depths.shape[1]}x{depths.shape[2]}",
           "rows_per_scan": int(depths[0].size * 129), "cli_s": wall,
           "scan_s": secs["_scan"], "merge_s": secs["_merge"],
           "scan_s_mean": float(np.mean(secs["_scan"])),
           "merge_s_mean": float(np.mean(secs["_merge"])),
           "s_per_frame": wall / len(depths), "occupied": len(occ), "free": len(free),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if gpu else None}
    two = {}
    for name, flag in (("card", card), ("cpu", ["--device", "cpu"])):
        two[name] = os.path.join(tmp, f"occ_2_{name}.bt")
        t0 = time.perf_counter()
        run(2, flag, two[name])
        out[f"two_frames_s_{name}"] = time.perf_counter() - t0
    out["bt_card_equals_cpu"] = _same_bytes(two["card"], two["cpu"])
    check(out["bt_card_equals_cpu"], "the card's and the CPU's occupancy .bt differ")
    out["kernel_launches"] = _kernel_counts()
    check(not any(out["kernel_launches"].values()),
          f"the occupancy path launched kernels: {out['kernel_launches']}")
    ph.info.update({k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in out.items()
                    if not isinstance(v, (dict, list))})
    return out


def phase_point_to_plane(dev, gpu: bool, rng, a, ph):
    """Point-to-plane ICP of phase 5's cloud against a copy under a known
    rigid motion (a few degrees, ~0.45 m), normals estimated (k=16), 15
    iterations: the transform within 1e-3 of the truth, 15 ICP-NN launches
    per call, each equal to the plain version; a 4,800-point subsample on
    the card and on the CPU: transforms within 1e-4, normals equal up to
    sign. Returns (the path's launches, the largest kernel error, the
    line's numbers)."""
    from tpu3drec_torch.ops import icp_nn
    from tpu3drec_torch.sfm import icp as icp_mod

    R = _rot(0.05, -0.04, 0.03)
    t = np.array([0.3, -0.2, 0.25])
    dst = a.astype(np.float32)
    src = ((a.astype(np.float64) - t) @ R).astype(np.float32)  # R src + t = dst
    T_true = np.eye(4)
    T_true[:3, :3], T_true[:3, 3] = R, t
    out = {"points": int(a.shape[0]), "k": 16, "iters": 15}
    kernel_err = 0.0
    sub = rng.permutation(a.shape[0])[:4_800]

    ctx = recording(icp_mod, "nearest_neighbors_cuda") if gpu else contextlib.nullcontext([])
    with ctx as calls:
        # the subsample first, on the card (also the warm-up); its launches
        # are checked here and kept out of the main path's count
        before = icp_nn.launches
        res_s = icp_mod.icp_point_to_plane(src[sub], dst[sub], device=dev)
        sub_launches = icp_nn.launches - before
        # the main path: counted from 0 just before the call, read just after
        with timed(icp_mod, ("estimate_normals", "_icp_plane_core"), dev) as secs:
            icp_nn.reset_launches()
            res = icp_mod.icp_point_to_plane(src, dst, device=dev)
            launches = icp_nn.launches
    if gpu:
        for n, got in (("4,800", sub_launches), ("76,800", launches)):
            check(got == 15, f"point-to-plane ICP at {n} points launched icp_nn {got} times in "
                  "15 iterations")
        # every recorded call, the subsample's too, against the plain version
        kernel_err = hold_against_plain(calls, icp_nn.nearest_neighbors_plain,
                                        "icp_nn (point-to-plane)")
    out.update(normals_s=secs["estimate_normals"][0], core_s=secs["_icp_plane_core"][0],
               launches=launches, sub_launches=sub_launches)
    T = res.T.cpu().numpy().astype(np.float64)
    out["T_err"] = float(np.abs(T - T_true).max())
    out["rmse"] = float(res.rmse)
    out["n_inliers"] = int(res.n_inliers)
    check(out["T_err"] <= 1e-3, f"point-to-plane T differs from the truth by {out['T_err']}")
    res_c = icp_mod.icp_point_to_plane(src[sub], dst[sub], device="cpu")
    out["sub_T_card_vs_cpu"] = float((res_s.T.cpu() - res_c.T).abs().max())
    check(out["sub_T_card_vs_cpu"] <= 1e-4,
          f"the card's and the CPU's transforms differ by {out['sub_T_card_vs_cpu']}")
    d_sub = torch.as_tensor(dst[sub])
    nc = icp_mod.estimate_normals(d_sub.to(dev)).cpu().numpy()
    nh = icp_mod.estimate_normals(d_sub).numpy()
    dots = np.abs((nc * nh).sum(1))
    out["normals_within_1e4"] = float((dots >= 1 - 1e-4).mean())
    out["normals_min_abs_dot"] = float(dots.min())
    check(out["normals_within_1e4"] >= 0.99,
          f"only {out['normals_within_1e4']:.4f} of the normals agree up to sign")
    ph.info.update({k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in out.items()})
    return launches, kernel_err, out


def phase_serve(dev, gpu: bool, tmp: str, ph, depths, q32, t32, cfg, rng):
    """`serve` on the card: the port's C++ sender streams a capture blob of
    phase 4's frames with RGB to the CLI's `serve` at batch 4 (its own
    process), and to `stream_fuse` in this process; the `.bt`, the PLY and
    the sorted points must equal `run_arrays` on the same frames."""
    from tpu3drec_torch.data import stream
    from tpu3drec_torch.pipelines import rgbd
    from tpu3drec_torch.utils.config import save_json
    from tpu3drec_torch.utils.plyio import read_ply

    F = len(depths)
    rgb = rng.integers(0, 256, size=depths.shape + (3,), dtype=np.uint8)
    blob = os.path.join(tmp, "capture.t3dc")
    stream.write_capture_blob(blob, depths, rgb=rgb, t=t32, q_xyzw=q32)
    t0 = time.perf_counter()
    sender = stream.sender_path()
    out = {"frames": F, "size": f"{depths.shape[1]}x{depths.shape[2]}", "batch": 4,
           "blob_mb": os.path.getsize(blob) / 1e6, "sender_build_s": time.perf_counter() - t0}
    scfg = dataclasses.replace(cfg, out_ply="", out_bt="")
    cfg_path = os.path.join(tmp, "serve_cfg.json")
    save_json(scfg, cfg_path)
    ref = dataclasses.replace(cfg, out_ply=os.path.join(tmp, "serve_ref.ply"),
                              out_bt=os.path.join(tmp, "serve_ref.bt"))
    off = rgbd.run_arrays(depths, q32, t32, ref, keep_points=True, colors=rgb, device=dev)

    # through the CLI, in its own process
    ply, bt = os.path.join(tmp, "serve.ply"), os.path.join(tmp, "serve.bt")
    device_flag = [] if gpu else ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=HERE)
    srv = subprocess.Popen(
        [sys.executable, "-m", "tpu3drec_torch.pipelines.cli", *device_flag, "serve",
         "--config", cfg_path, "--batch", "4", "--out-ply", ply, "--out-bt", bt],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = srv.stdout.readline()
        check(first.startswith("listening on port"), f"serve did not start: {first!r}")
        t0 = time.perf_counter()
        sent = subprocess.run([sender, blob, "127.0.0.1", first.split()[-1]],
                              capture_output=True, text=True, timeout=300)
        check(sent.returncode == 0, f"the sender failed: {sent.stderr}")
        srv_out, srv_err = srv.communicate(timeout=300)
        out["cli_s"] = time.perf_counter() - t0
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.communicate()
    check(srv.returncode == 0, f"serve exited {srv.returncode}: {srv_err[-2000:]}")
    check(f"stream done: {F} frames" in srv_out, f"serve said {srv_out[-500:]!r}")
    out["cli_frames_per_s"] = F / out["cli_s"]

    # in this process: the card is warm, so this is the ingestion rate
    _reset_kernel_counts()
    icfg = dataclasses.replace(cfg, out_ply=os.path.join(tmp, "serve_in.ply"),
                               out_bt=os.path.join(tmp, "serve_in.bt"))
    server = stream.FrameStreamServer()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sender, blob, "127.0.0.1", str(server.port)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        res = stream.stream_fuse(server, icfg, batch=4, keep_points=True, device=dev)
        sync(dev)
        out["stream_fuse_s"] = time.perf_counter() - t0
        proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0, f"the sender exited {proc.returncode}")
    out["frames_per_s"] = F / out["stream_fuse_s"]
    out["kernel_launches"] = _kernel_counts()
    check(not any(out["kernel_launches"].values()),
          f"the stream path launched kernels: {out['kernel_launches']}")
    check(res.n_frames == F and res.n_points == off.n_points and res.n_voxels == off.n_voxels,
          f"stream fused {res.n_frames} frames, {res.n_points} points, {res.n_voxels} voxels; "
          f"run_arrays {off.n_points} points, {off.n_voxels} voxels")
    for a, b in ((bt, ref.out_bt), (ply, ref.out_ply), (icfg.out_bt, ref.out_bt),
                 (icfg.out_ply, ref.out_ply)):
        check(_same_bytes(a, b), f"{os.path.basename(a)} differs from run_arrays' file")
    pts, _ = read_ply(ply)
    key = lambda p: p[np.lexsort(p.T[::-1])]  # noqa: E731
    check(np.array_equal(key(pts), key(off.points)), "serve's sorted points differ")
    out.update(points=res.n_points, voxels=res.n_voxels)
    ph.info.update({k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in out.items()
                    if not isinstance(v, dict)})
    return out


def _perception_frames(rng, h: int, w: int):
    """Frames rendered with numpy: a ring gate in sensor noise and the noise
    alone; a bright landing pad on a dark ground; an ArUco marker in a white
    frame (and turned a quarter); a number board from a bank of templates.
    The pad and the marker are two-level images, so no pixel lies near a
    threshold."""
    from tpu3drec_torch.autonomy import aruco

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    noise = (0.05 * rng.uniform(size=(h, w))).astype(np.float32)
    ring = noise.copy()
    ring[np.abs(np.sqrt((ys - 0.45 * h) ** 2 + (xs - 0.6 * w) ** 2) - h / 12) < 2.0] = 1.0
    pad = np.where((ys - 0.55 * h) ** 2 + (xs - 0.4 * w) ** 2 < (h / 8) ** 2, 1.0, 0.1)
    cell = max(h // 12, 4)
    marker = np.ones((h, w), np.float32)
    m = aruco.render_marker(451, cell_px=cell)
    y0, x0 = (h - m.shape[0]) // 2, (w - m.shape[1]) // 3
    marker[y0:y0 + m.shape[0], x0:x0 + m.shape[1]] = m
    th = max(h // 10, 8)
    temps = rng.uniform(size=(9, th, th)).astype(np.float32)
    board = np.full((h, w), 0.5, np.float32)
    board[h // 3:h // 3 + th, w // 2:w // 2 + th] = temps[5]
    return (np.stack([ring, noise]), pad[None].astype(np.float32),
            np.stack([marker, np.rot90(marker, 2).copy()]), board[None], temps)


def phase_autonomy(dev, gpu: bool, ph, rng):
    """`mission-sim` through the CLI (1200 ticks, exit 0 only when LANDED;
    ticks per second), its phases and trajectory held against a CPU run;
    then `label_components`, `largest_blob`, `detect_rings`,
    `match_templates` and `decode_marker` on 480x640 frames rendered with
    numpy, on the card and on the CPU: integer outputs equal, floats within
    1e-5 relative (centroids, circularity) and 1e-4 (ring and template
    scores)."""
    from tpu3drec_torch.autonomy import aruco, detect
    from tpu3drec_torch.pipelines import cli

    _reset_kernel_counts()
    out = {}
    device_flag = [] if gpu else ["--device", "cpu"]
    t0 = time.perf_counter()
    rc = cli.main(device_flag + ["mission-sim"])
    out["mission_cli_s"] = time.perf_counter() - t0
    check(rc == 0, f"mission-sim exited {rc}: the mission did not end LANDED")
    t0 = time.perf_counter()
    state, traj, phases = cli.mission_sim(device=dev)
    sync(dev)
    out["mission_s"] = time.perf_counter() - t0
    out["ticks_per_s"] = 1200 / out["mission_s"]
    t0 = time.perf_counter()
    _, ctraj, cphases = cli.mission_sim(device="cpu")
    out["mission_cpu_s"] = time.perf_counter() - t0
    out["cpu_ticks_per_s"] = 1200 / out["mission_cpu_s"]
    check(torch.equal(phases.cpu(), cphases), "the card's mission phases differ from the CPU's")
    out["traj_card_vs_cpu"] = float((traj.cpu() - ctraj).abs().max())
    check(out["traj_card_vs_cpu"] <= 1e-4, f"trajectories differ by {out['traj_card_vs_cpu']}")
    out["final_phase"] = int(state.phase)

    h, w = (H, W) if gpu else (96, 128)
    rings, pad, markers, board, temps = _perception_frames(rng, h, w)
    radii = (12, 16, 20, 26, 32, 40, 50, 60)
    calls = {
        "label_components": lambda d: (detect.label_components(markers < 0.5, device=d),),
        "largest_blob": lambda d: detect.largest_blob(pad, device=d),
        "detect_rings": lambda d: detect.detect_rings(rings, radii=radii, device=d),
        "match_templates": lambda d: detect.match_templates(board, temps, device=d),
        "decode_marker": lambda d: aruco.decode_marker(markers, device=d),
    }
    floats = {"largest_blob": {"cx": 1e-5, "cy": 1e-5, "circularity": 1e-5},
              "detect_rings": {"score": 1e-4}, "match_templates": {"score": 1e-4},
              "decode_marker": {"corners": 0.0}}
    results = {}
    for name, fn in calls.items():
        got = fn(dev)
        want = fn("cpu")
        fields = getattr(got, "_fields", [str(i) for i in range(len(got))])
        for field, g, c in zip(fields, got, want):
            g = g.cpu()
            tol = floats.get(name, {}).get(field)
            if tol is None:
                check(torch.equal(g, c), f"{name}.{field}: card {g.tolist()} != CPU {c.tolist()}")
            else:
                err = float((g.double() - c.double()).abs().max() / max(1.0, float(c.abs().max())))
                check(err <= tol, f"{name}.{field}: card and CPU differ by {err} (bound {tol})")
        results[name] = {f: (v.cpu().tolist() if v.numel() <= 8 else list(v.shape))
                         for f, v in zip(fields, got)}
        out[f"{name}_ms"] = time_ms(lambda: fn(dev), dev, reps=3 if gpu else 1)
    check(results["decode_marker"]["marker_id"] == [451, 451], f"markers read as "
          f"{results['decode_marker']['marker_id']}")
    check(results["largest_blob"]["found"] == [True], "the pad was not found")
    out["perception"] = results
    out["kernel_launches"] = _kernel_counts()
    check(not any(out["kernel_launches"].values()),
          f"the autonomy path launched kernels: {out['kernel_launches']}")
    ph.info.update({k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in out.items()
                    if not isinstance(v, dict)})
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phases 17-18: the multi-process runtime, as 2 ranks on the one card
# ---------------------------------------------------------------------------

WORLD = 2  # ranks; on one card they share cuda:0 and join over gloo
# Phase 18: the 2-process m00/150 run against phase 9's single-process run
# of the same frames, |ATE difference| in points of the trajectory. The
# card's runs of one process spread over 0.096-0.359% (PERF.md section 5:
# its `index_add_` atomics), so 2 processes may land anywhere in it.
M00_ATE_DELTA_PCT = 0.5


def spawn_ranks(work: str, timeout: float):
    """Run the WORLD ranks of phase 17 (this script with ``--rank``),
    joined through a file store in ``work``, within ``timeout`` seconds
    (`parallel/multihost.py::spawn_local`); a rank that fails, or a world
    that outlasts the timeout, fails the phase. Returns each rank's report
    (``sharded.rank<r>.json``)."""
    from tpu3drec_torch.parallel.multihost import spawn_local

    cmd = [sys.executable, os.path.abspath(__file__), "--world", str(WORLD), "--work", work]
    outs = spawn_local(lambda r: cmd + ["--rank", str(r)], WORLD, timeout, cwd=HERE)
    reports = []
    for r, out in enumerate(outs):
        for line in out.strip().splitlines():
            log(f"  [rank {r}] {line}")
        with open(os.path.join(work, f"sharded.rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def rank_main(args) -> int:
    """One rank of phase 17, started by `spawn_ranks`."""
    import torch.distributed as dist

    import_port()
    from tpu3drec_torch.parallel import mesh as pm
    from tpu3drec_torch.parallel.multihost import init_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // args.world))
    check(init_distributed("file://" + os.path.join(args.work, "sharded.store"), args.world,
                           args.rank), "the process group did not start")
    pm.reset_staged()
    report = rank_sharded(args.rank, args.world, torch.device("cuda", 0), args.work)
    report["staged_bytes"] = dict(pm.staged_bytes)
    report["backend"] = dist.get_backend()
    with open(os.path.join(args.work, f"sharded.rank{args.rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def _grad_dict(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}


def _rel_norm(a: dict, b: dict) -> float:
    """|a - b| / |b| over every tensor of ``b``."""
    num = sum(float((a[k].double().cpu() - b[k].double().cpu()).square().sum()) for k in b)
    return math.sqrt(num / sum(float(v.double().square().sum()) for v in b.values()))


def rank_sharded(rank, world, dev, work) -> dict:
    """This rank's part of phase 17 (see `phase_sharded`)."""
    from tpu3drec_torch.models.training import TrainConfig, init_state, make_optimizer, make_train_step
    from tpu3drec_torch.mvs.marching import marching_tetrahedra, marching_tetrahedra_sharded_soup
    from tpu3drec_torch.mvs.tsdf import TsdfGrid, integrate_depth_maps, shard_grid
    from tpu3drec_torch.ops import ba_blocks, icp_nn
    from tpu3drec_torch.parallel import mesh as pm
    from tpu3drec_torch.parallel.ba_sharded import ba_solve_landmark_sharded
    from tpu3drec_torch.parallel.ring import ring_nearest_neighbors, sharded_voxel_count
    from tpu3drec_torch.parallel.tp import shard_params_tp
    from tpu3drec_torch.sfm import ba
    from tpu3drec_torch.sfm import icp as icp_mod

    z = dict(np.load(os.path.join(work, "sharded_inputs.npz")))
    mesh = pm.make_mesh(data=1, space=world, device=dev)
    rep, secs = {"rank": rank}, {}

    def stage(name):
        sync(dev)
        secs[name] = time.perf_counter()

    def done(name):
        sync(dev)
        secs[name] = time.perf_counter() - secs[name]

    # ---- the ring search: 2 ICP-NN launches a call on each rank
    q = pm.shard_batch(mesh, z["ring_q"], "space").contiguous()
    r = pm.shard_batch(mesh, z["ring_r"], "space").contiguous()
    ring_nearest_neighbors(q[:512], r[:512], mesh)  # warm-up: the library, the groups
    with recording(icp_mod, "nearest_neighbors_cuda") as calls:
        _reset_kernel_counts()
        stage("ring")
        idx, d2 = ring_nearest_neighbors(q, r, mesh)
        done("ring")
        rep["ring_launches"] = icp_nn.launches
    rep["ring_max_abs_err"] = hold_against_plain(calls, icp_nn.nearest_neighbors_plain,
                                                 "icp_nn (ring)")
    rep["ring_calls_vs_plain"] = len(calls)
    del calls[:]
    check(rep["ring_launches"] == world,
          f"the ring launched icp_nn {rep['ring_launches']} times on {world} shards")
    # against the single-process kernel on the whole reference cloud
    r_all = torch.as_tensor(z["ring_r"], device=dev).contiguous()
    idx1, d21 = icp_mod.nearest_neighbors(q, r_all)
    check(torch.equal(d2, d21), "ring d2 differs from the single-process kernel's")
    diff = (idx.long() != idx1.long()).nonzero()[:, 0]
    nr = r.shape[0]
    if diff.numel():  # only exact ties across shards: the same distance, another shard
        qa, ra, rb = q[diff].cpu(), r_all[idx[diff].long()].cpu(), r_all[idx1[diff].long()].cpu()

        def sq(a, b):
            d = a - b
            return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]

        check(torch.equal(sq(qa, ra), sq(qa, rb))
              and bool(((idx[diff] // nr) != (idx1[diff] // nr)).all()),
              f"{diff.numel()} ring indices differ from the single-process kernel's off a tie")
    rep["ring_tie_swaps"] = int(diff.numel())
    rep["ring_queries"] = int(q.shape[0])

    # ---- the sharded voxel count of phase 4's map
    keys = pm.shard_batch(mesh, z["vox_keys"], "space")
    valid = pm.shard_batch(mesh, z["vox_valid"], "space")
    stage("voxel_count")
    count = int(sharded_voxel_count(keys, valid, mesh))
    done("voxel_count")
    check(count == int(z["vox_count"]), f"sharded voxel count {count}, unique_voxels' "
          f"{int(z['vox_count'])}")
    rep["voxel_count"] = count

    # ---- observation-sharded BA on the block path, and landmark-sharded BA
    F, L, O = (int(x) for x in z["ba_shape"])
    prob = ba.BAProblem.from_numpy(*(z[f"ba_{k}"] for k in ("cam_params", "points", "cam_idx",
                                                           "pt_idx", "uv", "weight", "K")),
                                   device=dev)
    obs = prob._replace(**{k: pm.shard_batch(mesh, getattr(prob, k), "space")
                           for k in ("cam_idx", "pt_idx", "uv", "weight")})
    ba.ba_solve(obs, max_lm_iters=1, cg_iters=2, use_pallas_blocks=True, mesh=mesh)  # warm-up
    with recording(ba, "ba_blocks") as calls:
        _reset_kernel_counts()
        stage("ba_obs")
        res = ba.ba_solve(obs, max_lm_iters=12, cg_iters=10, use_pallas_blocks=True, mesh=mesh)
        done("ba_obs")
        rep["ba_launches"] = ba_blocks.launches
    rep["ba_max_abs_err"] = hold_against_plain(calls, ba_blocks.ba_blocks_plain,
                                               "ba_blocks (observation-sharded)")
    rep["ba_calls_vs_plain"] = len(calls)
    del calls[:]
    check(rep["ba_launches"] == res.n_iters,
          f"ba_blocks launched {rep['ba_launches']} times in {res.n_iters} LM iterations")
    rep.update(ba_obs_iters=res.n_iters, ba_obs_init=float(res.initial_cost),
               ba_obs_final=float(res.final_cost))
    ba_solve_landmark_sharded(prob, mesh, max_lm_iters=1, cg_iters=2)  # warm-up: jacfwd
    stage("ba_landmark")
    res_l = ba_solve_landmark_sharded(prob, mesh, max_lm_iters=12, cg_iters=10)
    done("ba_landmark")
    rep.update(ba_landmark_iters=res_l.n_iters, ba_landmark_final=float(res_l.final_cost))
    if rank == 0:
        # the single-process solves; the JAX tests' cost tolerance
        # (tests/test_parallel.py:91-94): 1e-3 relative
        for tag, blocks, got in (("obs", True, res), ("landmark", False, res_l)):
            one = ba.ba_solve(prob, max_lm_iters=12, cg_iters=10, use_pallas_blocks=blocks)
            rel = abs(float(got.final_cost) - float(one.final_cost)) / abs(float(one.final_cost))
            rep[f"ba_{tag}_single_final"] = float(one.final_cost)
            rep[f"ba_{tag}_cost_rel"] = rel
            rep[f"ba_{tag}_cams_max_diff"] = float((got.cam_params - one.cam_params).abs().max())
            check(rel <= 1e-3 or abs(float(got.final_cost) - float(one.final_cost)) <= 1e-6,
                  f"{tag}-sharded BA cost {float(got.final_cost)} vs {float(one.final_cost)}")
        _reset_kernel_counts()

    # ---- the x-sharded TSDF and the sharded marching tetrahedra
    gdims = tuple(int(x) for x in z["tsdf_dims"])
    grid = TsdfGrid.allocate(z["tsdf_origin"], gdims, float(z["tsdf_res"]),
                             trunc=float(z["tsdf_trunc"]), device=dev)
    targs = (z["tsdf_depths"], z["tsdf_K"], z["tsdf_R"], z["tsdf_t"])
    stage("tsdf_slab")
    slab = integrate_depth_maps(shard_grid(grid, mesh, "space"), *targs)
    done("tsdf_slab")
    whole = integrate_depth_maps(grid, *targs)
    n = slab.tsdf.shape[0]
    check(torch.equal(slab.tsdf, whole.tsdf[slab.x0:slab.x0 + n])
          and torch.equal(slab.weight, whole.weight[slab.x0:slab.x0 + n]),
          "a TSDF slab differs from the whole grid's slice")
    rep["tsdf_slab"] = [slab.x0, n]
    host = (whole.tsdf.cpu().numpy(), whole.weight.cpu().numpy())
    stage("marching")
    soup = marching_tetrahedra_sharded_soup(*host, grid.origin, grid.res, mesh, axis="space",
                                            cells_per_shard=int(z["mt_cap"]))
    done("marching")
    single = marching_tetrahedra(whole.tsdf, whole.weight, grid.origin, grid.res, device=dev)
    check(soup.shape == single.shape and np.array_equal(soup, single),
          f"sharded marching: {soup.shape} triangles against {single.shape}")
    rep["triangles"] = int(soup.shape[0])
    del whole, slab, host

    # ---- one data-parallel monocular step, one frame a rank
    h, w = (int(x) for x in z["mono_hw"])
    cfg = TrainConfig(height=h, width=w)
    seed = int(z["mono_seed"])
    batch = {k: z[f"mono_{k}"] for k in ("target", "prev", "next")}
    noise = torch.as_tensor(z["mono_noise"], device=dev)
    model, state = init_state(seed, cfg, 1000, device=dev)
    before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
    mine = {k: v[rank:rank + 1] for k, v in batch.items()}
    step = make_train_step(cfg, mesh=mesh, axis="space")
    stage("dp_step")
    _, loss, _ = step(state, mine, noise=noise)
    done("dp_step")
    rep["dp_loss"] = float(loss)
    grads = _grad_dict(model)
    sd = {k: p.detach() for k, p in model.named_parameters()}
    # every rank took the same update: a sum of every parameter, all-reduced
    total = torch.stack([v.double().sum() for v in sd.values()]).sum().reshape(1)
    spread = pm.all_reduce(mesh, total, "space", "max") - pm.all_reduce(mesh, total, "space", "min")
    check(float(spread[0]) == 0.0, f"the ranks' parameters differ after the step ({spread})")
    # Adam: the update against torch's Adam on the CPU fed the step's
    # gradients, within 1e-3 of lr plus 4 float32 ulps (phase 10's bound)
    replay = {k: before[k].clone().requires_grad_(True) for k in grads}
    for k, p in replay.items():
        p.grad = grads[k].cpu()
    make_optimizer(cfg, list(replay.values())).step()
    ulp = torch.finfo(torch.float32).eps
    lr = cfg.learning_rate
    rep["dp_adam_excess"] = max(float(((sd[k].cpu() - p.detach()).abs()
                                       - (1e-3 * lr + 4 * ulp * p.detach().abs())).max())
                                for k, p in replay.items())
    check(rep["dp_adam_excess"] <= 0, f"the DP step's Adam update is off by "
          f"{rep['dp_adam_excess']} beyond its bound")
    stage("dp_step_warm")  # a second step: the first's cuDNN autotuning is behind it
    step(state, mine, noise=noise)
    done("dp_step_warm")
    del model, state, sd
    if rank == 0:
        # the single-process batch-2 step from the same seed, batch and noise
        m1, s1 = init_state(seed, cfg, 1000, device=dev)
        _, loss1, _ = make_train_step(cfg)(s1, batch, noise=noise)
        rep["single_loss"] = float(loss1)
        rep["dp_loss_rel"] = abs(float(loss) - float(loss1)) / abs(float(loss1))
        rep["dp_grad_rel"] = _rel_norm(grads, _grad_dict(m1))
        check(rep["dp_loss_rel"] <= 1e-4, f"DP loss {float(loss)} vs batch-2 {float(loss1)}")
        check(rep["dp_grad_rel"] <= 0.5, f"DP gradients {rep['dp_grad_rel']} of their norm off "
              "the batch-2 step's")
        del m1, s1
    del grads

    # ---- one tensor-parallel step (model=2) against the replicated step
    tp_mesh = pm.make_mesh(data=1, space=1, model=world, device=dev)
    one = {k: v[:1] for k, v in batch.items()}
    out = {}
    for tag in ("replicated", "tp"):
        model, state = init_state(seed, cfg, 1000, device=dev)
        if tag == "tp":
            shard_params_tp(model, tp_mesh)
            state.optimizer = make_optimizer(cfg, model.parameters())
            rep["tp_sharded_layers"] = sum(getattr(m, "tp_dim", None) is not None
                                           for m in model.modules())
        stage(f"{tag}_step")
        _, loss, _ = make_train_step(cfg)(state, one, noise=noise[:, :1])
        done(f"{tag}_step")
        g = {}
        for mname, m in model.named_modules():
            for pname, p in m.named_parameters(recurse=False):
                dim = getattr(m, "tp_dim", None)
                t = p.grad.clone()
                if dim is not None and pname in ("weight", "bias"):
                    t = torch.cat(list(pm.all_gather(tp_mesh, t.contiguous(), "model").unbind(0)),
                                  dim=dim if pname == "weight" else 0)
                g[f"{mname}.{pname}"] = t
        out[tag] = (float(loss), g)
        rep[f"{tag}_loss"] = float(loss)
        stage(f"{tag}_step_warm")
        make_train_step(cfg)(state, one, noise=noise[:, :1])
        done(f"{tag}_step_warm")
        del model, state
    rep["tp_loss_rel"] = abs(out["tp"][0] - out["replicated"][0]) / abs(out["replicated"][0])
    rep["tp_grad_rel"] = _rel_norm(out["tp"][1], out["replicated"][1])
    check(rep["tp_loss_rel"] <= 1e-4, f"TP loss {out['tp'][0]} vs {out['replicated'][0]}")
    check(rep["tp_grad_rel"] <= 0.5, f"TP gradients {rep['tp_grad_rel']} of their norm off")
    rep["seconds"] = secs
    rep["kernel_launches_after"] = _kernel_counts()
    return rep


def phase_sharded(dev, tmp: str, ph, fused, a, b, mvs_in, seed: int):
    """Phase 17, on 2 ranks sharing the card over gloo: the ring search at
    phase 5's cloud, the sharded voxel count of phase 4's map,
    observation-sharded BA on the block path and landmark-sharded BA at
    phase 7's size, the x-sharded TSDF and sharded marching at phase 12's
    grid, one data-parallel monocular step at 480x640 (one frame a rank)
    against the single-process batch-2 step, and one tensor-parallel step
    (model=2) against the replicated one. Returns (the ranks' reports, the
    inputs' description)."""
    from tpu3drec_torch.mapping.voxel import unique_voxels, voxelize

    n = a.shape[0]
    keys_t = voxelize(torch.as_tensor(fused, device=dev), 0.1)
    valid_t = torch.ones(keys_t.shape[0], dtype=torch.bool, device=dev)
    m = keys_t.shape[0] - keys_t.shape[0] % WORLD
    vox_count = int(unique_voxels(keys_t[:m], valid_t[:m])[2])
    F, L, O = 64, 8192, 65_536
    prob = _ba_problem(np.random.default_rng([seed, 17]), "cpu", F, L, O)
    h, w = H, W
    g = np.random.default_rng([seed, 18])
    inputs = dict(ring_q=a[: n - n % WORLD], ring_r=b[: n - n % WORLD],
                  vox_keys=keys_t[:m].cpu().numpy(), vox_valid=valid_t[:m].cpu().numpy(),
                  vox_count=np.array(vox_count), ba_shape=np.array([F, L, O]),
                  mono_hw=np.array([h, w]), mono_seed=np.array(seed),
                  mono_noise=g.standard_normal((2, WORLD, h, w)).astype(np.float32),
                  mt_cap=np.array(65_536), **mvs_in)
    for k in ("cam_params", "points", "cam_idx", "pt_idx", "uv", "weight", "K"):
        inputs[f"ba_{k}"] = getattr(prob, k).cpu().numpy()
    for k in ("target", "prev", "next"):
        inputs[f"mono_{k}"] = g.uniform(size=(WORLD, h, w, 3)).astype(np.float32)
    np.savez(os.path.join(tmp, "sharded_inputs.npz"), **inputs)
    del keys_t, valid_t
    reports = spawn_ranks(tmp, timeout=600)
    r0 = reports[0]
    ph.info.update(
        ring=f"{r0['ring_queries']}x{r0['ring_queries'] * WORLD} per rank, "
             f"launches {[r['ring_launches'] for r in reports]}, tie swaps "
             f"{[r['ring_tie_swaps'] for r in reports]}",
        voxel_count=r0["voxel_count"],
        ba_obs=f"{r0['ba_obs_final']:.2f} vs {r0['ba_obs_single_final']:.2f} "
               f"(rel {r0['ba_obs_cost_rel']:.2e})",
        ba_landmark=f"{r0['ba_landmark_final']:.2f} vs {r0['ba_landmark_single_final']:.2f} "
                    f"(rel {r0['ba_landmark_cost_rel']:.2e})",
        triangles=r0["triangles"], dp_loss_rel=f"{r0['dp_loss_rel']:.2e}",
        dp_grad_rel=f"{r0['dp_grad_rel']:.3f}", tp_loss_rel=f"{r0['tp_loss_rel']:.2e}",
        tp_grad_rel=f"{r0['tp_grad_rel']:.3f}")
    return reports


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_entry_points(dev, tmp: str, ph, frames_path: str, single: dict):
    """Phase 18: the CLI's `rgbd` as 2 processes (``--coordinator
    localhost:<port> --num-processes 2``) on phase 4's 16 frames (phase 13's
    .npy depth and pose file), its `.bt` byte-equal and its PLY the same
    point set as the single-process run's; then the window split of phase
    9's frames through `tools/ate_torch.py --nproc 2 --hold`: each window's
    poses exchanged exactly (the float32 rounding of its own, in its own
    slot, the same on both processes), ATE and coverage beside phase 9's
    single-process run of the same frames (coverage equal, |ATE
    difference| <= M00_ATE_DELTA_PCT points), every matcher launch of each
    process bit-equal to the plain version. Returns the line's numbers and
    the processes' matcher launches."""
    from tpu3drec_torch.parallel.multihost import spawn_local
    from tpu3drec_torch.utils.plyio import read_ply

    out = {}
    cfg_path = os.path.join(tmp, "occ_cfg.json")
    ddir = os.path.join(tmp, "depth_npy")
    common = ["--config", cfg_path, "--poses",
              os.path.join(tmp, f"occ_poses_{len(os.listdir(ddir))}.txt"), "--depth-dir", ddir]
    cli = [sys.executable, "-m", "tpu3drec_torch.pipelines.cli"]
    paths = {n: (os.path.join(tmp, f"rgbd_{n}.ply"), os.path.join(tmp, f"rgbd_{n}.bt"))
             for n in ("one", "two")}
    t0 = time.perf_counter()
    p = subprocess.run(cli + ["rgbd"] + common + ["--out-ply", paths["one"][0],
                                                  "--out-bt", paths["one"][1]],
                       cwd=HERE, timeout=300, capture_output=True, text=True)
    log(f"  [rgbd, 1 process] {(p.stdout + p.stderr).strip()}")
    check(p.returncode == 0, f"the single-process rgbd exited {p.returncode}")
    out["rgbd_one_s"] = time.perf_counter() - t0
    port = _free_port()
    t0 = time.perf_counter()
    logs = spawn_local(lambda r: cli + ["--coordinator", f"localhost:{port}", "--num-processes",
                                        str(WORLD), "--process-id", str(r), "rgbd"] + common
                       + ["--out-ply", paths["two"][0], "--out-bt", paths["two"][1]],
                       WORLD, 300, cwd=HERE)
    out["rgbd_two_s"] = time.perf_counter() - t0
    for r, text in enumerate(logs):
        log(f"  [rgbd rank {r}] {text.strip()}")
    out["bt_byte_equal"] = _same_bytes(paths["one"][1], paths["two"][1])
    check(out["bt_byte_equal"], "the 2-process .bt differs from the single-process one")
    p1, _ = read_ply(paths["one"][0])
    p2, _ = read_ply(paths["two"][0])
    out["ply_points"] = [int(p1.shape[0]), int(p2.shape[0])]
    check(p1.shape == p2.shape and np.array_equal(np.unique(p1, axis=0), np.unique(p2, axis=0)),
          f"the 2-process PLY's point set differs ({p2.shape} against {p1.shape})")

    # the window split of the m00 loop through tools/ate_torch.py
    row = os.path.join(tmp, "ate_nproc2.json")
    cmd = [sys.executable, os.path.join(HERE, "tools", "ate_torch.py"), "--frames-from",
           frames_path, "--nproc", str(WORLD), "--hold", "--out", row]
    t0 = time.perf_counter()
    # the tool's own limit on its processes (NPROC_TIMEOUT_S) ends first
    p = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=_ate_tool().NPROC_TIMEOUT_S + 120)
    out["ate_two_s"] = time.perf_counter() - t0
    for line in (p.stdout + p.stderr).strip().splitlines()[-20:]:
        log(f"  [ate --nproc {WORLD}] {line}")
    check(p.returncode == 0, f"tools/ate_torch.py --nproc {WORLD} exited {p.returncode}")
    with open(row) as f:
        m = json.load(f)
    by_proc = m["matcher_by_process"]
    for i, k in enumerate(by_proc):
        check(k["calls"] == k["bit_equal"] and k["launches"] == k["calls"],
              f"process {i}: {k['bit_equal']} of {k['calls']} matcher calls bit-equal, "
              f"{k['launches']} launches")
    # the exchange: every window back in its slot, its poses the float32
    # rounding of its own, and the same exchanged poses on every process
    for i, e in enumerate(m["exchange_by_process"]):
        check(e["own_windows"] > 0 and e["exact"] == e["own_windows"],
              f"process {i}: {e['exact']} of its {e['own_windows']} windows exchanged exactly")
    check(m["exchange_same_on_all"], "the processes hold different exchanged poses")
    out.update(frames=m["frames"], windows=m["windows"], ate_pct=m["ate_pct_traj"],
               coverage=m["coverage"], wall_s=m["wall_s"], stage_s=m["stage_s"],
               single_ate_pct=single["ate_pct_traj"], single_coverage=single["coverage"],
               single_wall_s=single["wall_s"], matcher_by_process=by_proc,
               exchange_by_process=m["exchange_by_process"])
    out["ate_delta_pct"] = abs(m["ate_pct_traj"] - single["ate_pct_traj"])
    check(m["coverage"] == single["coverage"],
          f"coverage {m['coverage']} with {WORLD} processes, {single['coverage']} with one")
    check(out["ate_delta_pct"] <= M00_ATE_DELTA_PCT,
          f"ATE {m['ate_pct_traj']}% with {WORLD} processes, {single['ate_pct_traj']}% with "
          f"one (bound {M00_ATE_DELTA_PCT} points)")
    ph.info.update({k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in out.items()
                    if not isinstance(v, (dict, list))})
    return out, [k["launches"] for k in by_proc]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run phases 3-16 at a tiny size on the CPU with the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 17, started by the script itself
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=WORLD, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    gpu = not args.rehearse_cpu
    rng = np.random.default_rng(args.seed)

    if gpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 2
    smi = None
    with Phase("device") as ph:
        import_port()
        import scipy  # the long-sequence path needs it (rotations): missing is an error

        ph.info["scipy"] = scipy.__version__
        if gpu:
            dev = torch.device("cuda", 0)
            ph.info["kind"] = repr(torch.cuda.get_device_name(0))
            ph.info["count"] = torch.cuda.device_count()
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True).stdout.strip()
            smi = smi.splitlines()[0]
            ph.info["nvidia_smi"] = repr(smi)
            ph.info["torch"] = torch.__version__
            ph.info["cuda"] = torch.version.cuda
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(min(4, torch.get_num_threads()))
            ph.info["rehearsal"] = "cpu"

    from tpu3drec_torch.mapping.btio import read_bt
    from tpu3drec_torch.mapping.voxel import unique_voxels, voxelize
    from tpu3drec_torch.ops import icp_nn
    from tpu3drec_torch.pipelines import cli, rgbd
    from tpu3drec_torch.utils.config import CameraConfig, MapConfig, RGBDPipelineConfig
    from tpu3drec_torch.utils.plyio import read_ply, write_ply
    from tpu3drec_torch.utils.poseio import (
        PoseRecord, poses_to_arrays, read_pose_txt, read_T_txt, write_pose_txt)

    if gpu:
        with Phase("build") as ph:
            from tpu3drec_torch.ops import build
            from tpu3drec_torch.utils import native

            libs = build.build()
            ph.info["kernels"] = ",".join(sorted(libs))
            # the host map-export library too, so that phase 4 times the
            # export and not its first call's compile
            t0 = time.perf_counter()
            native.load()
            ph.info["host_library_s"] = round(time.perf_counter() - t0, 2)
        for name, text in sorted(build.build_logs.items()):
            for line in text.splitlines():
                if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
                    log(f"  ptxas {name}: {line.strip()}")

    frames, h, w = (16, H, W) if gpu else (2, 48, 64)
    fx, fy, cx, cy = (FX, FY, CX, CY) if gpu else (FX / 10, FY / 10, w / 2, h / 2)
    depths, Rc2w, centres, q_xyzw, t_w2c = make_scene(rng, frames, h, w, fx, fy, cx, cy)
    cfg = RGBDPipelineConfig(
        camera=CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h),
        map=MapConfig(voxel_res=0.1, ply_binary=True))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- phase 3: kernel vs plain at the slice's shape ---------------
        with Phase("kernel_vs_plain") as ph:
            pts, _ = rgbd.fuse_arrays(depths[:2], q_xyzw[:2].astype(np.float32),
                                      t_w2c[:2].astype(np.float32), cfg, device=dev)
            grid = pts.reshape(2, h, w, 3)[:, ::2, ::2].reshape(2, -1, 3)
            row = phase_kernel(dev, rng, grid[0].cpu().numpy(), grid[1].cpu().numpy(), gpu)
            ph.info.update({k: row[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
                                               "library_ms", "max_abs_err")})

        # ---- the main path: counts zeroed here, read after phase 5 --------
        icp_nn.reset_launches()

        # ---- phase 4: fusion at full width ---------------------------------
        with Phase("fusion") as ph:
            pose_path = os.path.join(tmp, "poses.txt")
            write_pose_txt(pose_path, [PoseRecord(f, t_w2c[f], q_xyzw[f], f"{f}.png")
                                       for f in range(frames)])
            q32, t32 = poses_to_arrays(read_pose_txt(pose_path))
            cfg.out_ply = os.path.join(tmp, "map.ply")
            cfg.out_bt = os.path.join(tmp, "map.bt")
            res = rgbd.run_arrays(depths, q32, t32, cfg, keep_points=True, device=dev)
            n_valid = int(((depths > cfg.map.min_depth) & (depths < cfg.map.max_depth)).sum())
            check(res.n_points == n_valid, f"{res.n_points} points, expected {n_valid}")
            check(res.n_voxels > 0, "no voxels")
            ply_pts, _ = read_ply(cfg.out_ply)
            check(ply_pts.shape == (n_valid, 3) and np.isfinite(ply_pts).all(),
                  f"PLY holds {ply_pts.shape}")
            keys, bt_res = read_bt(cfg.out_bt)
            check(keys.shape[0] == res.n_voxels and bt_res == 0.1,
                  f".bt holds {keys.shape[0]} voxels at {bt_res}")
            # one frame against a float64 evaluation of the same formula
            k = frames - 1
            allpts, _ = rgbd.fuse_arrays(depths, q32, t32, cfg, device=dev)
            got = allpts.reshape(frames, h * w, 3)[k].cpu().numpy().astype(np.float64)
            uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
            z = depths[k].astype(np.float64)
            pc = np.stack([(uu - cx) / fx * z, (vv - cy) / fy * z, z], -1).reshape(-1, 3)
            want = pc @ Rc2w[k].T + centres[k]
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            check(err <= 1e-5 * scale, f"frame {k}: max err {err} at scene scale {scale}")

            def device_fusion():
                p, valid = rgbd.fuse_arrays(depths, q32, t32, cfg, device=dev)
                return unique_voxels(voxelize(p, cfg.map.voxel_res), valid)[2]

            fuse_ms = time_ms(device_fusion, dev, reps=5 if gpu else 1)
            py_s, ascii_s = host_io_backends(depths, q32, t32, cfg, res.points[: h * w], dev, tmp)
            ph.info.update(n_frames=res.n_frames, n_points=res.n_points,
                           n_voxels=res.n_voxels, run_arrays_s=round(res.seconds, 3),
                           run_arrays_s_python=round(py_s, 3), frame_err=err,
                           device_fusion_ms=round(fuse_ms, 3),
                           frames_per_s=round(frames / fuse_ms * 1e3, 1), **ascii_s)
            fused = res.points

        # ---- phase 5: ICP scale correction through the CLI -----------------
        with Phase("icp") as ph:
            n = 76_800 if gpu else 1_500
            a = fused[rng.choice(fused.shape[0], size=n, replace=False)].astype(np.float32)
            s_true = 1.25
            R_true = _rot(0.04, -0.03, 0.05)  # a few degrees
            t_true = np.array([0.7, -0.4, 1.1])
            b = (s_true * a.astype(np.float64) @ R_true.T + t_true
                 + rng.normal(scale=1e-3, size=a.shape)).astype(np.float32)
            # T maps B onto A: the inverse similarity
            T_true = np.eye(4)
            T_true[:3, :3] = R_true.T / s_true
            T_true[:3, 3] = -R_true.T @ t_true / s_true
            pa, pb = os.path.join(tmp, "a.ply"), os.path.join(tmp, "b.ply")
            write_ply(pa, a, binary=True)
            write_ply(pb, b, binary=True)
            t_path = os.path.join(tmp, "T_data.txt")
            device_flag = [] if gpu else ["--device", "cpu"]
            before = icp_nn.launches
            t0 = time.perf_counter()
            cli.main(device_flag + ["icp", pa, pb, "--iters", "50", "--out", t_path])
            icp_s = time.perf_counter() - t0
            if gpu:
                check(icp_nn.launches - before == 50,
                      f"icp_nn launched {icp_nn.launches - before} times in 50 iterations")
            T = read_T_txt(t_path)
            scale = float(np.cbrt(np.linalg.det(T[:3, :3])))
            T_err = float(np.abs(T - T_true).max())
            check(abs(scale - 1 / s_true) <= 1e-3, f"scale {scale}, expected {1 / s_true}")
            check(T_err <= 1e-2, f"T differs from the truth by {T_err}")
            merged = os.path.join(tmp, "merged.ply")
            cli.main(device_flag + ["icp-fuse", pa, pb, "--T", t_path, "--out", merged])
            m_pts, _ = read_ply(merged)
            check(m_pts.shape == (2 * n, 3), f"merged PLY holds {m_pts.shape}")
            merged_bt = os.path.join(tmp, "merged.bt")
            cli.main(device_flag + ["ply2bt", merged, "--res", "0.1", "--out", merged_bt])
            keys, _ = read_bt(merged_bt)
            check(keys.shape[0] > 0, "merged .bt is empty")
            ph.info.update(points=n, icp_s=round(icp_s, 3), scale=scale, T_err=T_err,
                           merged_points=m_pts.shape[0], merged_voxels=keys.shape[0])

        n_icp = icp_nn.launches  # read just after phases 4-5

        # ---- phase 6: the matcher kernel against its plain version ---------
        with Phase("matcher_vs_plain") as ph:
            m_row = phase_matcher(dev, rng, gpu)
            ph.info.update({k: m_row[k] for k in ("shape", "ms", "call_ms", "plain_ms",
                                                 "bound_ms", "library_ms", "max_abs_err")})

        # ---- phase 7: BA blocks against plain, then the block-path solve ---
        with Phase("ba_blocks_vs_plain") as ph:
            b_row = phase_ba_blocks(dev, rng, gpu, args.seed)
            ph.info.update({k: b_row[k] for k in ("shape", "ms", "call_ms", "plain_ms",
                                                 "bound_ms", "max_abs_err")})
        with Phase("ba_solve") as ph:
            b_row["launches"], err = ba_solve_paths(dev, rng, gpu, ph)
            b_row["max_abs_err"] = max(b_row["max_abs_err"], err)

        # ---- phase 8: SfM through the pipeline -----------------------------
        with Phase("sfm") as ph:
            n_sfm, main = phase_sfm(dev, rng, gpu, tmp, ph)
            m_row["max_abs_err"] = max(m_row["max_abs_err"], main.pop("max_abs_err"))
            m_row["main_path"] = main

        # ---- phase 9: the long-sequence path --------------------------------
        with Phase("long_sequence") as ph:
            frames_path = os.path.join(tmp, "m00_frames.npz")
            n_long, long_seq = phase_long_sequence(dev, gpu, ph, frames_path)
            m_row["max_abs_err"] = max(m_row["max_abs_err"], long_seq["max_abs_err"])
            m_row["long_sequence"] = long_seq
        # each path's count was zeroed just before it and read just after
        m_row["launches"] = n_sfm + n_long
        m_row["launches_by_path"] = {"sfm": n_sfm, "long_sequence": n_long}

        # ---- phase 10: the monocular depth path ----------------------------
        with Phase("monocular") as ph:
            mono = phase_monocular(dev, gpu, tmp, ph, args.seed)

        # one pool of renderers for phases 11 and 12 (spawned once: each
        # worker takes seconds to start); the rehearsal's frames are too
        # small to pay for processes
        with (_stereo_tool().render_pool(8) if gpu else contextlib.nullcontext()) as pool:
            # ---- phase 11: stereo --------------------------------------------
            with Phase("stereo") as ph:
                stereo_row = phase_stereo(dev, gpu, tmp, ph, args.seed, pool)

            # ---- phase 12: dense MVS -----------------------------------------
            with Phase("mvs") as ph:
                mvs_in = {}
                mvs_row = phase_mvs(dev, gpu, tmp, ph, args.seed, pool, mvs_in)

        # ---- phase 13: occupancy through the CLI ----------------------------
        with Phase("occupancy") as ph:
            occ_row = phase_occupancy(dev, gpu, tmp, ph, depths, q32, t32, cfg)

        # ---- phase 14: point-to-plane ICP (counts zeroed inside, read after) -
        with Phase("point_to_plane") as ph:
            n_p2p, err, p2p_row = phase_point_to_plane(dev, gpu, rng, a, ph)
            row["max_abs_err"] = max(row["max_abs_err"], err)
        row["launches"] = n_icp + n_p2p
        row["launches_by_path"] = {"icp": n_icp, "point_to_plane": n_p2p}

        # ---- phase 15: serve ---------------------------------------------------
        with Phase("serve") as ph:
            serve_row = phase_serve(dev, gpu, tmp, ph, depths, q32, t32, cfg, rng)

        # ---- phase 16: mission-sim and perception ------------------------------
        with Phase("autonomy") as ph:
            auto_row = phase_autonomy(dev, gpu, ph, rng)

        mp_row = None
        if gpu:
            mp_row = {"world": WORLD, "device_shared": "cuda:0"}
            # ---- phase 17: the sharded primitives, 2 ranks -------------------
            with Phase("sharded") as ph:
                t0 = time.perf_counter()
                reports = phase_sharded(dev, tmp, ph, fused, a, b, mvs_in, args.seed)
                mp_row["sharded_s"] = time.perf_counter() - t0
            ring = [r["ring_launches"] for r in reports]
            row["launches"] += sum(ring)
            row["launches_by_path"]["ring"] = sum(ring)
            row["max_abs_err"] = max([row["max_abs_err"]] + [r["ring_max_abs_err"] for r in reports])
            obs = [r["ba_launches"] for r in reports]
            b_row["launches"] += sum(obs)
            b_row["launches_by_path"] = {"ba_solve": b_row["launches"] - sum(obs),
                                         "observation_sharded_ba": sum(obs)}
            b_row["max_abs_err"] = max([b_row["max_abs_err"]] + [r["ba_max_abs_err"]
                                                                 for r in reports])
            mp_row["sharded"] = {k: v for k, v in reports[0].items()
                                 if k not in ("staged_bytes", "backend")}
            mp_row["launches_by_rank"] = {"icp_nn_ring": ring, "ba_blocks_sharded": obs}
            mp_row["staged_bytes_by_rank"] = {"sharded": [r["staged_bytes"] for r in reports]}
            mp_row["backend"] = reports[0]["backend"]

            # ---- phase 18: the entry points, 2 processes ----------------------
            with Phase("entry_points") as ph:
                t0 = time.perf_counter()
                entry, split = phase_entry_points(dev, tmp, ph, frames_path, long_seq["run"])
                mp_row["entry_points_s"] = time.perf_counter() - t0
            m_row["launches"] += sum(split)
            m_row["launches_by_path"]["window_split"] = sum(split)
            mp_row["launches_by_rank"]["matcher_window_split"] = split
            mp_row["entry_points"] = entry

    rows = [row, m_row, b_row]
    for r, src in zip(rows, ("icp_nn", "matcher", "ba_blocks")):
        # registers and spill bytes of each __global__, from ptxas's report
        r["ptxas"] = build.ptxas_usage(src) if gpu else None
        r["kernel_ms"] = r["ms"]
        r["ok"] = True
        if gpu:
            check(r["launches"] > 0, f"the main path never launched {r['name']}")
    lines = {"monocular": mono, "stereo": stereo_row, "mvs": mvs_row, "occupancy": occ_row,
             "point_to_plane": p2p_row, "serve": serve_row, "autonomy": auto_row}
    if mp_row is not None:
        lines["multiprocess"] = mp_row
    for name, line in lines.items():
        line.update(device=torch.cuda.get_device_name(0) if gpu else "cpu", nvidia_smi=smi)
        log(f"{name} " + json.dumps(line))
    log(json.dumps({"kernels": rows}))
    if not gpu:
        log(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
