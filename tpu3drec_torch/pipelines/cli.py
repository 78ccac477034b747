"""Command-line interface of the port (port of `tpu3drec/pipelines/cli.py`,
the map-building subcommands), with the same flags and defaults:

  rgbd       depth PNGs + pose txt -> world PLY/.bt
  icp        estimate the scale-correcting 4x4 T between two clouds
  icp-fuse   two clouds + T_data.txt -> merged PLY
  ply2bt     PLY -> octomap .bt
  sfm        image directory -> pose txt + sparse PLY (incremental SfM)
  kitti-eval KITTI-layout sequence -> windowed SfM + ATE/RPE against its poses
  train-mono monodepth training from an InteriorNet (or, with --use-stereo,
             KITTI raw) tree and split files
  train-stereo PSMNet training on a left/ right/ disp/ directory, or on
             stereo pairs ray-cast from the urban scene (--sim N)
  mvs        posed images -> plane-sweep depth -> TSDF -> cleaned mesh PLY
  occupancy  depth + poses -> log-odds occupancy .bt with carved free space
  serve      listen for a live RGB-D frame stream and fuse it
  mission-sim closed-loop autonomous mission in a simulated world

Run: ``python -m tpu3drec_torch.pipelines.cli <subcommand> ...``. Work runs
on the card; ``--device cpu`` asks for the CPU. Multi-process: every
process runs the same command with ``--coordinator host:port
--num-processes N --process-id I`` (or ``--distributed`` alone under
torchrun), which joins the process group (`parallel/multihost.py`) before
the subcommand runs; the sharded writers emit one artifact set.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch


def _cmd_rgbd(args):
    from tpu3drec_torch.pipelines import rgbd
    from tpu3drec_torch.utils.config import RGBDPipelineConfig, from_dict

    if args.config:
        with open(args.config) as f:
            cfg = from_dict(RGBDPipelineConfig, json.load(f))
    else:
        cfg = RGBDPipelineConfig()
    if args.poses:
        cfg.pose_file = args.poses
    if args.depth_dir:
        cfg.depth_dir = args.depth_dir
    if args.rgb_dir:
        cfg.rgb_dir = args.rgb_dir
    if args.out_ply:
        cfg.out_ply = args.out_ply
    if args.out_bt:
        cfg.out_bt = args.out_bt
    res = rgbd.run(cfg, device=args.device)
    print(f"fused {res.n_frames} frames -> {res.n_points} points, "
          f"{res.n_voxels} voxels in {res.seconds:.2f}s")


def _cmd_icp_fuse(args):
    from tpu3drec_torch.pipelines import icp_fusion
    from tpu3drec_torch.utils.plyio import read_ply

    a, _ = read_ply(args.cloud_a)
    b, _ = read_ply(args.cloud_b)
    n = icp_fusion.run(a, b, args.T, args.out, device=args.device)
    print(f"merged {n} points -> {args.out}")


def _cmd_icp(args):
    from tpu3drec_torch.sfm.icp import icp_scale_correction
    from tpu3drec_torch.utils.plyio import read_ply
    from tpu3drec_torch.utils.poseio import write_T_txt

    a, _ = read_ply(args.cloud_a)
    b, _ = read_ply(args.cloud_b)
    T = icp_scale_correction(a, b, iters=args.iters, device=args.device).cpu().numpy()
    write_T_txt(args.out, T)
    print(f"T ->\n{T}")


def ply2bt(ply: str, out: str, res: float = 0.1, max_points: int = 0, device=None):
    """PLY -> octomap .bt. Returns (n_points, n_voxels, n_nodes)."""
    from tpu3drec_torch.mapping.btio import write_bt
    from tpu3drec_torch.mapping.voxel import dedup_voxels_host
    from tpu3drec_torch.utils.plyio import read_ply

    pts, _ = read_ply(ply)
    if max_points and pts.shape[0] > max_points:
        pts = pts[:max_points]  # the reference capped at 5.4M points
    keys = dedup_voxels_host(pts, res, device=device)
    return pts.shape[0], keys.shape[0], write_bt(out, keys, res)


def _cmd_ply2bt(args):
    n_pts, n_vox, n = ply2bt(args.ply, args.out, args.res, args.max_points,
                             device=args.device)
    print(f"{n_pts} points -> {n_vox} voxels, {n} nodes -> {args.out}")


def _cmd_occupancy(args):
    """Occupancy mapping (occupied + carved free space) from the same
    depth + poses contract as `rgbd`."""
    from tpu3drec_torch.core.quaternion import quat_xyzw_to_matrix
    from tpu3drec_torch.core.se3 import SE3
    from tpu3drec_torch.core.unproject import depth_to_world_points_unfused
    from tpu3drec_torch.mapping.occupancy import OccupancyMap
    from tpu3drec_torch.utils.config import RGBDPipelineConfig, from_dict
    from tpu3drec_torch.utils.depthio import load_depth
    from tpu3drec_torch.utils.device import resolve_device
    from tpu3drec_torch.utils.poseio import read_pose_txt

    if args.config:
        with open(args.config) as f:
            cfg = from_dict(RGBDPipelineConfig, json.load(f))
    else:
        cfg = RGBDPipelineConfig()
    dev = resolve_device(args.device)
    records = read_pose_txt(args.poses)
    cam = cfg.camera.to_camera(device=dev)
    m = OccupancyMap(res=args.res, max_samples=args.max_samples, device=dev)
    for r in records:
        depth = load_depth(
            os.path.join(args.depth_dir, r.image_name),
            mode=cfg.depth.mode, scale=cfg.depth.scale,
            size=(cfg.camera.width, cfg.camera.height),
        )
        Rw2c = quat_xyzw_to_matrix(torch.as_tensor(r.q_xyzw, dtype=torch.float32)).numpy()
        Rc2w = Rw2c.T
        tc2w = -Rc2w @ np.asarray(r.t, np.float32)
        pts = depth_to_world_points_unfused(
            torch.as_tensor(depth, device=dev), cam,
            SE3(torch.as_tensor(Rc2w, device=dev), torch.as_tensor(tc2w, device=dev)),
        ).reshape(-1, 3)
        valid = (depth.reshape(-1) > cfg.map.min_depth) & (depth.reshape(-1) < args.max_range)
        m.insert_scan(tc2w, pts, valid)
        n, n_occ, n_free = m.counts()
        print(f"frame {r.frame_id}: {n} voxels ({n_occ} occ / {n_free} free)")
    n = m.write_bt(args.out)
    print(f"wrote {args.out}: {n} nodes")


def _cmd_serve(args):
    from tpu3drec_torch.data.stream import FrameStreamServer, stream_fuse
    from tpu3drec_torch.utils.config import RGBDPipelineConfig, from_dict

    if args.config:
        with open(args.config) as f:
            cfg = from_dict(RGBDPipelineConfig, json.load(f))
    else:
        cfg = RGBDPipelineConfig()
    if args.out_ply:
        cfg.out_ply = args.out_ply
    if args.out_bt:
        cfg.out_bt = args.out_bt
    server = FrameStreamServer(port=args.port)
    print(f"listening on port {server.port}", flush=True)
    res = stream_fuse(server, cfg, batch=args.batch, verbose=True, device=args.device)
    print(f"stream done: {res.n_frames} frames -> {res.n_points} points, "
          f"{res.n_voxels} voxels")


def mission_sim(steps: int = 1200, cruise_alt: float = 4.0, device=None):
    """The `mission-sim` world: two waypoints (the second a gate), a ring
    gate at (9, 0.6, 4.4) and a landing pad at (13, 0.5, 0), seen through
    pinhole projections (front camera for the gate, below camera for the
    pad), flown for ``steps`` ticks of 0.1 s from the origin. Returns
    (final state, positions (T, 3), phases (T,)) on ``device``."""
    from tpu3drec_torch.autonomy.mission import Observation, mission_config, mission_rollout

    cfg = mission_config([[2.0, 0.0, 4.0], [6.0, 0.0, 4.0]], [False, True], [3, 8],
                         [160.0, 120.0], device=device, cruise_alt=cruise_alt,
                         scan_ticks=10, pass_ticks=15, servo_gain=(0.02, 0.0, 0.005))
    dev = cfg.waypoints.device
    gate = torch.tensor([9.0, 0.6, 4.4], device=dev)
    pad = torch.tensor([13.0, 0.5, 0.0], device=dev)
    f, c0 = 200.0, cfg.image_center
    hi, lo = torch.tensor(0.9, device=dev), torch.tensor(0.01, device=dev)
    no_markers = torch.full((2,), -1, dtype=torch.int32, device=dev)

    def observe(pos):
        rel = gate - pos
        depth = torch.clamp(rel[0], min=0.3)
        relp = pad - pos
        alt = torch.clamp(pos[2] - pad[2], min=0.3)
        visible = (rel[0] > 0.5) & (torch.abs(rel[1]) < 4.0) & (torch.abs(rel[2]) < 4.0)
        return Observation(
            ring_px=torch.stack([c0[0] - f * rel[1] / depth, c0[1] - f * rel[2] / depth]),
            ring_score=torch.where(visible, hi, lo),
            blob_px=torch.stack([c0[0] - f * relp[1] / alt, c0[1] - f * relp[0] / alt]),
            blob_found=(torch.abs(relp[0]) < 2.0) & (torch.abs(relp[1]) < 2.0),
            altitude=pos[2], position=pos, marker_ids=no_markers)

    return mission_rollout(cfg, observe, n_steps=steps, start=torch.zeros(3, device=dev), dt=0.1)


def _cmd_mission_sim(args):
    """Closed-loop autonomous mission in a simulated world: takeoff,
    waypoints, ring-gate servoing, dash, ArUco-scan sweep, pad search,
    landing. Exit code 0 only when the mission ends LANDED."""
    import time

    from tpu3drec_torch.autonomy.mission import Phase

    t0 = time.perf_counter()
    state, traj, phases = mission_sim(args.steps, args.cruise_alt, device=args.device)
    phases = phases.cpu().numpy()
    traj = traj.cpu().numpy()
    secs = time.perf_counter() - t0
    prev = -1
    for i, ph in enumerate(phases):
        if ph != prev:
            print(f"t={i * 0.1:6.1f}s  {Phase(int(ph)).name:13s} pos={np.round(traj[i], 2)}")
            prev = ph
    print(f"final: {Phase(int(state.phase)).name} at {np.round(traj[-1], 2)}")
    print(f"{args.steps} ticks in {secs:.3f}s: {args.steps / secs:.1f} ticks/s")
    if args.out_traj:
        np.savetxt(args.out_traj, traj, fmt="%.4f")
        print(f"trajectory -> {args.out_traj}")
    return 0 if int(state.phase) == int(Phase.LANDED) else 1


def _cmd_sfm(args):
    from PIL import Image

    from tpu3drec_torch.pipelines.sfm_pipeline import SfmPipelineConfig, run

    paths = sorted(glob.glob(os.path.join(args.images, "*")))
    imgs = np.stack([np.asarray(Image.open(p).convert("L"), np.float32) / 255.0 for p in paths])
    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]], np.float32)
    cfg = SfmPipelineConfig(max_keypoints=args.max_keypoints, out_poses=args.out_poses,
                            out_sparse_ply=args.out_ply, verbose=True)
    rec = run(imgs, K, cfg, image_names=[os.path.basename(p) for p in paths],
              device=args.device)
    print(f"registered {len(rec.poses)}/{len(paths)} frames, {len(rec.points)} landmarks")


def _cmd_kitti_eval(args):
    from tpu3drec_torch.data.kitti_odom import KittiOdometryDataset
    from tpu3drec_torch.pipelines.kitti import (
        KittiRunConfig, evaluate_sequence, run_windowed_sfm)

    ds = KittiOdometryDataset(args.root, args.sequence)
    n = args.frames or ds.num_frames()
    print(f"loading {n} frames of sequence {args.sequence} ...")
    if args.width and not args.height:
        # default --height from the native aspect ratio so a lone --width
        # neither resizes to (width, 0) nor distorts the image
        h0, w0 = ds.load_gray(args.start).shape[:2]
        args.height = max(1, round(h0 * args.width / w0))
    images = ds.load_sequence(start=args.start, count=n,
                              size=(args.width, args.height) if args.width else None)
    K = ds.calib()
    if args.width:
        h0, w0 = ds.load_gray(args.start).shape[:2]
        K = K.copy()
        K[0] *= args.width / w0   # fx, cx scale with width
        K[1] *= args.height / h0  # fy, cy scale with height
    cfg = KittiRunConfig(window=args.window, stride=args.stride,
                         max_keypoints=args.max_keypoints, verbose=True,
                         parallel_windows=args.parallel_windows)
    Ts, _ = run_windowed_sfm(images, K, cfg, device=args.device)
    gt = ds.gt_poses()[args.start:args.start + n]
    m = evaluate_sequence(Ts, gt)
    print({k: round(float(v), 4) for k, v in m.items()})


def _cmd_train_mono(args):
    from tpu3drec_torch.data.datasets import InteriorNetDataset, KittiRawDataset, read_split_file
    from tpu3drec_torch.data.loader import TripletLoader
    from tpu3drec_torch.models.training import TrainConfig
    from tpu3drec_torch.pipelines.monocular import MonocularRunConfig, train

    tcfg = TrainConfig(
        height=args.height, width=args.width, batch_size=args.batch_size,
        learning_rate=args.lr, num_epochs=args.epochs,
        use_gt_pose=args.use_gt_pose, use_stereo=args.use_stereo,
    )
    # --use-stereo needs a side-partner frame: KITTI raw layout has one
    # (image_02/image_03); InteriorNet is monocular-only
    ds = (KittiRawDataset(args.data_path) if args.use_stereo
          else InteriorNetDataset(args.data_path))
    train_specs = read_split_file(args.split_train)
    val_specs = read_split_file(args.split_val) if args.split_val else []
    tl = TripletLoader(ds, train_specs, batch_size=args.batch_size,
                       height=args.height, width=args.width,
                       with_gt_pose=args.use_gt_pose,
                       with_stereo=args.use_stereo)
    vl = TripletLoader(ds, val_specs, batch_size=args.batch_size,
                       height=args.height, width=args.width, augment=False,
                       with_gt_depth=True) if val_specs else None
    cfg = MonocularRunConfig(train=tcfg, log_dir=args.log_dir)
    train(cfg, tl, vl, device=args.device)


def _sim_stereo_pairs(n: int, height: int, width: int, baseline: float, seed: int):
    """``n`` rectified pairs with ground-truth disparity ray-cast from the
    occluded urban scene (the JAX CLI's ``--sim``): (lefts, rights, disp,
    mask)."""
    from scipy.spatial.transform import Rotation as ScipyR

    from tpu3drec_torch.data.capture_sim import PlanarScene, render_stereo_pairs
    from tpu3drec_torch.utils.config import CameraConfig

    rng = np.random.default_rng(seed)
    scene = PlanarScene.urban(rng, n_boxes=12, extent=35.0)
    cam = CameraConfig(fx=width * 0.9, fy=width * 0.9, cx=(width - 1) / 2,
                       cy=(height - 1) / 2, width=width, height=height)
    poses = []
    for f in range(n):
        R = ScipyR.from_rotvec([0, 0.02 * f, 0]).as_matrix().astype(np.float32)
        C = np.array([0.4 * f, -1.2, 0.8 * f], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    return render_stereo_pairs(scene, poses, cam, baseline=baseline)


def _cmd_train_stereo(args):
    """PSMNet supervised training. Data: --data DIR with left/N.png,
    right/N.png and disp/N.npy, or --sim N ray-cast stereo pairs."""
    from tpu3drec_torch.models.psmnet_training import StereoTrainConfig
    from tpu3drec_torch.pipelines.stereo import train

    if args.sim:
        lefts, rights, disp, mask = _sim_stereo_pairs(args.sim, args.height, args.width,
                                                     args.baseline, args.seed)
    else:
        from PIL import Image

        ls = sorted(glob.glob(os.path.join(args.data, "left", "*")))
        lefts, rights, disp, mask = [], [], [], []
        for lp in ls:
            name = os.path.splitext(os.path.basename(lp))[0]
            rp = glob.glob(os.path.join(args.data, "right", name + ".*"))[0]
            d = np.load(os.path.join(args.data, "disp", name + ".npy")).astype(np.float32)
            lefts.append(np.asarray(Image.open(lp), np.float32)[..., :3] / 255.0)
            rights.append(np.asarray(Image.open(rp), np.float32)[..., :3] / 255.0)
            disp.append(d)
            mask.append((d > 0).astype(np.float32))
        lefts, rights = np.stack(lefts), np.stack(rights)
        disp, mask = np.stack(disp), np.stack(mask)

    cfg = StereoTrainConfig(
        learning_rate=args.lr, num_epochs=args.epochs, batch_size=args.batch_size,
        height=lefts.shape[1], width=lefts.shape[2], max_disp=args.max_disp, arch=args.arch)
    _, state, last = train(cfg, lefts, rights, disp, mask, log_dir=args.log_dir,
                           seed=args.seed, device=args.device)
    print(f"trained {state.step} steps, final loss {last:.4f} -> {args.log_dir}/ckpt")


def _cmd_mvs(args):
    """Dense MVS: posed images -> per-view depth -> TSDF -> cleaned mesh."""
    from PIL import Image
    from scipy.spatial.transform import Rotation as ScipyR

    from tpu3drec_torch.pipelines.mvs import MvsConfig, run_mvs
    from tpu3drec_torch.utils.plyio import write_ply, write_ply_mesh
    from tpu3drec_torch.utils.poseio import read_pose_txt

    paths = sorted(glob.glob(os.path.join(args.images, "*")))
    imgs = np.stack([np.asarray(Image.open(p).convert("L"), np.float32) / 255.0
                     for p in paths])
    by_name = {r.image_name: r for r in read_pose_txt(args.poses)}
    Rs, ts = [], []
    for p in paths:
        r = by_name.get(os.path.basename(p))
        if r is None:
            raise SystemExit(f"no pose for image {os.path.basename(p)}")
        Rs.append(ScipyR.from_quat(r.q_xyzw).as_matrix())
        ts.append(r.t)
    Rs = np.stack(Rs).astype(np.float32)
    ts = np.stack(ts).astype(np.float32)
    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]], np.float32)
    cfg = MvsConfig(n_src=args.n_src, n_planes=args.n_planes, d_min=args.d_min,
                    d_max=args.d_max, voxel_res=args.voxel_res, verbose=True)
    out = run_mvs(imgs, K, Rs, ts, cfg, device=args.device)
    write_ply_mesh(args.out, out["verts"], out["faces"])
    print(f"mesh: {out['verts'].shape[0]} verts, {out['faces'].shape[0]} faces -> {args.out}")
    if args.out_points:
        write_ply(args.out_points, out["points"])
        print(f"point set: {out['points'].shape[0]} -> {args.out_points}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu3drec_torch")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; pass cpu for the CPU)")
    # multi-process runtime: every process runs the same command
    p.add_argument("--distributed", action="store_true",
                   help="join the process group (torchrun's environment, or the flags below)")
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("rgbd", help="depth + poses -> fused map")
    q.add_argument("--config")
    q.add_argument("--poses")
    q.add_argument("--depth-dir", dest="depth_dir")
    q.add_argument("--rgb-dir", dest="rgb_dir", help="color the cloud from RGB frames")
    q.add_argument("--out-ply", dest="out_ply")
    q.add_argument("--out-bt", dest="out_bt")
    q.set_defaults(fn=_cmd_rgbd)

    q = sub.add_parser("icp-fuse", help="merge cloud B via T_data.txt")
    q.add_argument("cloud_a")
    q.add_argument("cloud_b")
    q.add_argument("--T", required=True)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=_cmd_icp_fuse)

    q = sub.add_parser("icp", help="estimate scale-correcting T on device")
    q.add_argument("cloud_a")
    q.add_argument("cloud_b")
    q.add_argument("--iters", type=int, default=50)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=_cmd_icp)

    q = sub.add_parser("ply2bt", help="PLY -> octomap .bt")
    q.add_argument("ply")
    q.add_argument("--res", type=float, default=0.1)
    q.add_argument("--out", required=True)
    q.add_argument("--max-points", dest="max_points", type=int, default=0)
    q.set_defaults(fn=_cmd_ply2bt)

    q = sub.add_parser("sfm", help="images -> poses + sparse cloud")
    q.add_argument("images")
    q.add_argument("--fx", type=float, default=600.391)
    q.add_argument("--fy", type=float, default=600.079)
    q.add_argument("--cx", type=float, default=320.0)
    q.add_argument("--cy", type=float, default=240.0)
    q.add_argument("--max-keypoints", dest="max_keypoints", type=int, default=512)
    q.add_argument("--out-poses", dest="out_poses", default="poses.txt")
    q.add_argument("--out-ply", dest="out_ply", default="sparse.ply")
    q.set_defaults(fn=_cmd_sfm)

    q = sub.add_parser("kitti-eval", help="windowed SfM + ATE on a KITTI sequence")
    q.add_argument("root", help="KITTI odometry root (sequences/, poses/)")
    q.add_argument("--sequence", default="00")
    q.add_argument("--start", type=int, default=0)
    q.add_argument("--frames", type=int, default=0)
    q.add_argument("--width", type=int, default=0, help="downscale width (0=native)")
    q.add_argument("--height", type=int, default=0)
    q.add_argument("--window", type=int, default=12)
    q.add_argument("--stride", type=int, default=7)
    q.add_argument("--max-keypoints", dest="max_keypoints", type=int, default=512)
    q.add_argument("--parallel-windows", dest="parallel_windows", type=int,
                   default=1, help="reconstruct N windows concurrently (threads on "
                   "the one device)")
    q.set_defaults(fn=_cmd_kitti_eval)

    q = sub.add_parser("train-mono", help="monodepth training")
    q.add_argument("--data-path", dest="data_path", required=True)
    q.add_argument("--split-train", dest="split_train", required=True)
    q.add_argument("--split-val", dest="split_val", default="")
    q.add_argument("--height", type=int, default=480)
    q.add_argument("--width", type=int, default=640)
    q.add_argument("--batch-size", dest="batch_size", type=int, default=1)
    q.add_argument("--lr", type=float, default=1e-5)
    q.add_argument("--epochs", type=int, default=20)
    q.add_argument("--use-gt-pose", dest="use_gt_pose", action="store_true")
    q.add_argument("--use-stereo", dest="use_stereo", action="store_true",
                   help="mono+stereo self-supervision (KITTI raw layout: image_02 + image_03)")
    q.add_argument("--log-dir", dest="log_dir", default="runs/monocular")
    q.set_defaults(fn=_cmd_train_mono)

    from tpu3drec_torch.models.psmnet_training import ARCHS, StereoTrainConfig

    q = sub.add_parser("train-stereo", help="PSMNet supervised training")
    q.add_argument("--arch", default=StereoTrainConfig.arch, choices=tuple(ARCHS),
                   help="the PSMNet-class sibling, or the published stacked-hourglass PSMNet "
                        "(H and W multiples of 16; published: --max-disp 192)")
    q.add_argument("--data", default="", help="dir with left/ right/ disp/")
    q.add_argument("--sim", type=int, default=0,
                   help="ray-cast N synthetic stereo pairs instead of --data")
    q.add_argument("--height", type=int, default=192)
    q.add_argument("--width", type=int, default=320)
    q.add_argument("--baseline", type=float, default=0.1)
    q.add_argument("--max-disp", dest="max_disp", type=int, default=64)
    q.add_argument("--batch-size", dest="batch_size", type=int, default=2)
    q.add_argument("--lr", type=float, default=1e-3)
    q.add_argument("--epochs", type=int, default=10)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--log-dir", dest="log_dir", default="runs/stereo")
    q.set_defaults(fn=_cmd_train_stereo)

    q = sub.add_parser("mvs", help="posed images -> dense depth + TSDF mesh")
    q.add_argument("--images", required=True)
    q.add_argument("--poses", required=True, help="pose txt (world->cam, "
                   "same contract as `rgbd`)")
    q.add_argument("--fx", type=float, default=600.391)
    q.add_argument("--fy", type=float, default=600.079)
    q.add_argument("--cx", type=float, default=320.0)
    q.add_argument("--cy", type=float, default=240.0)
    q.add_argument("--n-src", dest="n_src", type=int, default=4)
    q.add_argument("--n-planes", dest="n_planes", type=int, default=64)
    q.add_argument("--d-min", dest="d_min", type=float, default=1.0)
    q.add_argument("--d-max", dest="d_max", type=float, default=80.0)
    q.add_argument("--voxel-res", dest="voxel_res", type=float, default=0.0,
                   help="0 = auto (median depth / 100)")
    q.add_argument("--out", default="mesh.ply")
    q.add_argument("--out-points", dest="out_points", default="")
    q.set_defaults(fn=_cmd_mvs)

    q = sub.add_parser("occupancy",
                       help="depth+poses -> log-odds occupancy .bt (with free space)")
    q.add_argument("--config")
    q.add_argument("--poses", required=True)
    q.add_argument("--depth-dir", dest="depth_dir", required=True)
    q.add_argument("--res", type=float, default=0.1)
    q.add_argument("--max-range", dest="max_range", type=float, default=50.0)
    q.add_argument("--max-samples", dest="max_samples", type=int, default=128)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=_cmd_occupancy)

    q = sub.add_parser("serve", help="listen for a live RGB-D frame stream and fuse it")
    q.add_argument("--config")
    q.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = ephemeral, printed on start)")
    q.add_argument("--batch", type=int, default=4, help="frames per device batch")
    q.add_argument("--out-ply", dest="out_ply")
    q.add_argument("--out-bt", dest="out_bt")
    q.set_defaults(fn=_cmd_serve)

    q = sub.add_parser("mission-sim", help="closed-loop autonomous mission in a simulated world")
    q.add_argument("--steps", type=int, default=1200)
    q.add_argument("--cruise-alt", dest="cruise_alt", type=float, default=4.0)
    q.add_argument("--out-traj", dest="out_traj", default=None)
    q.set_defaults(fn=_cmd_mission_sim)

    args = p.parse_args(argv)
    if args.distributed or args.coordinator:
        from tpu3drec_torch.parallel.multihost import init_distributed

        init_distributed(args.coordinator, args.num_processes, args.process_id)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
