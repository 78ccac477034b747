"""RGBD mapping pipeline, reference configuration 1 (port of
`tpu3drec/pipelines/rgbd.py`).

Depth PNGs + given (COLMAP-convention) poses -> fused world-frame point
cloud -> PLY (+ optional .bt octree). The host decodes depth PNGs into one
(F, H, W) stack; the device unprojects every frame and voxel-dedups the
points for the octree; the host writes PLY/.bt. The only host<->device
transfers are the input stack (down) and the final point/key buffers (up).

Multi-process (`parallel/multihost.py`, the CLI's ``--coordinator``): each
process decodes and fuses only its contiguous slice of the frames, and the
sharded writers merge the processes' parts into the single PLY and `.bt`.
As in the reference, ``map.max_points`` cuts each process's own cloud, so
an N-process PLY can hold up to N times ``max_points`` points, and process
0's ``n_voxels`` is the node count of the merged `.bt`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu3drec_torch.core.quaternion import quat_xyzw_to_matrix
from tpu3drec_torch.core.unproject import fuse_depth_maps
from tpu3drec_torch.mapping.voxel import unique_voxels, voxelize
from tpu3drec_torch.parallel.multihost import (
    is_distributed, process_slice, write_bt_sharded, write_ply_sharded)
from tpu3drec_torch.utils.config import RGBDPipelineConfig
from tpu3drec_torch.utils.depthio import load_depth_stack, load_image_rgb
from tpu3drec_torch.utils.device import resolve_device
from tpu3drec_torch.utils.poseio import poses_to_arrays, read_pose_txt


@dataclass
class RGBDResult:
    n_frames: int
    n_points: int
    n_voxels: int
    seconds: float
    points: np.ndarray | None = None


def cam_to_world_arrays(q_xyzw: np.ndarray, t: np.ndarray):
    """COLMAP world->cam rows -> (F,3,3) cam->world R and (F,3) t, on the
    host (F is small)."""
    R_w2c = quat_xyzw_to_matrix(torch.as_tensor(np.asarray(q_xyzw), dtype=torch.float32)).numpy()
    R = np.swapaxes(R_w2c, -1, -2)
    tc2w = -np.einsum("fij,fj->fi", R, np.asarray(t, dtype=np.float32))
    return R.astype(np.float32), tc2w.astype(np.float32)


def fuse_arrays(depths: np.ndarray, q_xyzw: np.ndarray, t: np.ndarray,
                cfg: RGBDPipelineConfig, device=None):
    """Core fusion: (F,H,W) depths + COLMAP pose rows -> world points +
    validity, on ``device``."""
    Rs, ts = cam_to_world_arrays(q_xyzw, t)
    cam = cfg.camera
    return fuse_depth_maps(
        depths, Rs, ts, cam.fx, cam.fy, cam.cx, cam.cy,
        min_depth=cfg.map.min_depth, max_depth=cfg.map.max_depth,
        device=device,
    )


def run(cfg: RGBDPipelineConfig, device=None) -> RGBDResult:
    """Execute the pipeline from on-disk inputs, per the reference contract."""
    t0 = time.time()
    records = read_pose_txt(cfg.pose_file)
    records = records[process_slice(len(records))]  # all of them in one process
    size = (cfg.camera.width, cfg.camera.height)
    depth_paths = [os.path.join(cfg.depth_dir, r.image_name) for r in records]
    depths = load_depth_stack(depth_paths, mode=cfg.depth.mode,
                              scale=cfg.depth.scale, size=size)
    colors = None
    if cfg.rgb_dir:
        frames = []
        for r in records:
            stem = os.path.splitext(r.image_name)[0]
            for ext in (".jpg", ".png", os.path.splitext(r.image_name)[1]):
                path = os.path.join(cfg.rgb_dir, stem + ext)
                if os.path.exists(path):
                    frames.append(load_image_rgb(path, size=size))
                    break
            else:
                raise FileNotFoundError(
                    f"no RGB frame for {r.image_name} in {cfg.rgb_dir}")
        colors = np.stack(frames)
    q, t = poses_to_arrays(records)
    result = run_arrays(depths, q, t, cfg, colors=colors, device=device)
    result.seconds = time.time() - t0
    return result


def run_arrays(
    depths: np.ndarray, q_xyzw: np.ndarray, t: np.ndarray, cfg: RGBDPipelineConfig,
    keep_points: bool = False,
    colors: np.ndarray | None = None,  # (F, H, W, 3) uint8 per-pixel colors
    device=None,
) -> RGBDResult:
    """Pipeline on in-memory arrays (the testable core)."""
    t0 = time.time()
    dev = resolve_device(device)
    pts, valid = fuse_arrays(depths, q_xyzw, t, cfg, device=dev)

    n_voxels = 0
    if cfg.out_bt:
        skeys, mask, count = unique_voxels(voxelize(pts, cfg.map.voxel_res), valid)
        n_voxels = int(count)
        n = write_bt_sharded(cfg.out_bt, skeys[mask].cpu().numpy(), cfg.map.voxel_res)
        if is_distributed() and n >= 0:
            n_voxels = n  # process 0: the merged tree's node count

    valid_h = valid.cpu().numpy()
    cloud = pts[valid].cpu().numpy()
    cloud_rgb = None
    if colors is not None:
        cloud_rgb = colors.reshape(-1, 3)[valid_h]
    if cfg.map.max_points and cloud.shape[0] > cfg.map.max_points:
        cloud = cloud[: cfg.map.max_points]
        if cloud_rgb is not None:
            cloud_rgb = cloud_rgb[: cfg.map.max_points]
    if cfg.out_ply:
        write_ply_sharded(cfg.out_ply, cloud, colors=cloud_rgb, binary=cfg.map.ply_binary)

    return RGBDResult(
        n_frames=int(depths.shape[0]),
        n_points=int(cloud.shape[0]),
        n_voxels=n_voxels,
        seconds=time.time() - t0,
        points=cloud if keep_points else None,
    )
