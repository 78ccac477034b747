#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpu3drec_torch/`) on one card.

    python3 chip_smoke.py                 # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse-cpu  # phases 3-5 at a tiny size on the CPU

Phases, one flushed line each with its wall seconds:
  1. device: the card's name and count, and nvidia-smi's name and power limit
  2. build: every kernel of the path, from the sources in this checkout
     (`tpu3drec_torch/ops/csrc/*.cu`), one nvcc process per source
  3. kernel vs plain: the ICP nearest-neighbour kernel against its plain
     PyTorch version at ragged shapes, with exact ties, and at the slice's
     shape (one 480x640 frame at stride 2 against another); times of the
     kernel, the plain version and one library call, and the kernel's bound
  4. fusion: 16 frames of 480x640 depth of a seeded corridor scene with the
     reference camera -> world points -> binary PLY + .bt at 0.1 m
  5. ICP scale correction: a 76,800-point cloud from the fused map against
     a copy under a known similarity, through the CLI: `icp` (50
     iterations), `icp-fuse`, `ply2bt`
Launch counts are zeroed just before phase 4 and read just after phase 5.
The last lines are the kernels as one JSON object, nvidia-smi's line and
`{"ok": true, "device": {...}}`. Any failed check exits non-zero before
that. Inputs come from numpy's default_rng(--seed); files go to a
temporary directory, kernels to build/.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA's data sheet): fp32 on the CUDA
# cores and HBM3 bandwidth. The kernel's bound is the larger of its
# operations and its bytes over these.
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
NN_FLOP_PER_PAIR = 9  # the count the JAX package's cost model uses

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


def phase_kernel(dev, rng, full_q, full_r, gpu: bool):
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
    kernel_ms = time_ms(lambda: kernel(q, r), dev, reps=reps, warmup=2 if gpu else 0)
    plain_ms = time_ms(lambda: nearest_neighbors_plain(q, r), dev, reps=3 if gpu else 1,
                       warmup=1 if gpu else 0)
    library_ms = None
    if gpu:
        # yardstick only: materialises the Nq x Nr matrix; the port never calls it
        library_ms = time_ms(lambda: torch.cdist(q, r).min(dim=1), dev, reps=3)
        torch.cuda.empty_cache()
    t_ops = NN_FLOP_PER_PAIR * nq * nr / FP32_FLOPS
    t_bytes = ((nq + nr) * 12 + nq * 8) / HBM_BYTES_S
    return {
        "name": "icp_nn",
        "route": "cuda",
        "source": "tpu3drec_torch/ops/csrc/icp_nn.cu",
        "replaces": "tpu3drec/ops/icp_nn.py:42",
        "shape": [nq, nr],
        "max_abs_err": max_err,
        "near_tie_swaps": swaps,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run phases 3-5 at a tiny size on the CPU with the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    gpu = not args.rehearse_cpu
    rng = np.random.default_rng(args.seed)

    if gpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 2
    smi = None
    with Phase("device") as ph:
        import_port()
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

            libs = build.build()
            ph.info["kernels"] = ",".join(sorted(libs))
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
            ph.info.update({k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
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
            ph.info.update(n_frames=res.n_frames, n_points=res.n_points,
                           n_voxels=res.n_voxels, run_arrays_s=round(res.seconds, 3),
                           frame_err=err, device_fusion_ms=round(fuse_ms, 3),
                           frames_per_s=round(frames / fuse_ms * 1e3, 1))
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

    row["launches"] = icp_nn.launches
    row["kernel_ms"] = row["ms"]
    row["ok"] = True
    if gpu:
        check(row["launches"] > 0, "the main path never launched icp_nn")
    log(json.dumps({"kernels": [row]}))
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
