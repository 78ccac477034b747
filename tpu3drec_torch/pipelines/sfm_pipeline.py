"""Full SfM pipeline, reference configuration 5 (port of
`tpu3drec/pipelines/sfm_pipeline.py`): image sequence -> incremental SfM
-> poses + sparse cloud, with optional metric scaling from depth. The pose
txt follows the reference's COLMAP-export contract.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu3drec_torch.core.quaternion import matrix_to_quat_wxyz, quat_xyzw_from_wxyz
from tpu3drec_torch.sfm.incremental import Reconstruction, run_sfm
from tpu3drec_torch.utils.device import resolve_device
from tpu3drec_torch.utils.plyio import write_ply
from tpu3drec_torch.utils.poseio import PoseRecord, write_pose_txt


@dataclass
class SfmPipelineConfig:
    max_keypoints: int = 512
    overlap: int = 3
    ba_every: int = 3
    out_poses: str = ""     # pose txt (reference contract) if set
    out_sparse_ply: str = ""
    seed: int = 0
    verbose: bool = False


def reconstruction_to_pose_records(rec: Reconstruction, image_names=None,
                                   device=None) -> list[PoseRecord]:
    """world->cam (R, t) -> the comma-separated xyzw pose rows; the
    quaternions are computed on ``device`` (``None``: the card) in one
    batch."""
    dev = resolve_device(device)
    frames = rec.registered_frames()
    if not frames:
        return []
    R = torch.as_tensor(np.stack([np.asarray(rec.poses[f][0], np.float32) for f in frames]),
                        device=dev)
    q_xyzw = quat_xyzw_from_wxyz(matrix_to_quat_wxyz(R)).cpu().numpy()
    return [PoseRecord(f, np.asarray(rec.poses[f][1], np.float64), q_xyzw[i],
                       image_names[f] if image_names else f"{f}.png")
            for i, f in enumerate(frames)]


def metric_scale_from_depth(rec: Reconstruction, depth_maps: np.ndarray, cam_cfg,
                            frame: int | None = None) -> float:
    """The metric scale SfM cannot see: the median over landmarks of
    depth(u, v) / z_sfm at their projections in the registered frames
    (``depth_maps`` is indexed by absolute frame id)."""
    cam = cam_cfg.to_camera(device="cpu") if hasattr(cam_cfg, "to_camera") else cam_cfg
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    use_frames = [frame] if frame is not None else rec.registered_frames()
    ratios = []
    for f in use_frames:
        R, t = rec.poses[f]
        dm = depth_maps[f]
        H, W = dm.shape
        for tid, X in rec.points.items():
            if f not in rec.tracks.get(tid, {}):
                continue
            Xc = R @ X + t
            if Xc[2] <= 1e-6:
                continue
            u = int(round(Xc[0] / Xc[2] * fx + cx))
            v = int(round(Xc[1] / Xc[2] * fy + cy))
            if 0 <= u < W and 0 <= v < H and dm[v, u] > 1e-3:
                ratios.append(dm[v, u] / Xc[2])
    if len(ratios) < 10:
        raise ValueError(f"only {len(ratios)} landmark-depth pairs for scaling")
    return float(np.median(ratios))


def apply_scale(rec: Reconstruction, scale: float) -> None:
    """Rescale the reconstruction in place (translations and landmarks)."""
    for f, (R, t) in rec.poses.items():
        rec.poses[f] = (R, t * scale)
    for tid in rec.points:
        rec.points[tid] = rec.points[tid] * scale


def run(images: np.ndarray, K: np.ndarray, cfg: SfmPipelineConfig = None, image_names=None,
        depth_maps: np.ndarray | None = None, cam_cfg=None, device=None) -> Reconstruction:
    """Images (F, H, W) in [0, 1] -> Reconstruction, on ``device`` (None
    means the card); writes the pose txt and sparse PLY the config names."""
    cfg = cfg or SfmPipelineConfig()
    rec = run_sfm(images, K, max_keypoints=cfg.max_keypoints, overlap=cfg.overlap,
                  ba_every=cfg.ba_every, seed=cfg.seed, verbose=cfg.verbose, device=device)
    if depth_maps is not None and cam_cfg is not None:
        apply_scale(rec, metric_scale_from_depth(rec, depth_maps, cam_cfg))
    if cfg.out_poses:
        write_pose_txt(cfg.out_poses,
                       reconstruction_to_pose_records(rec, image_names, device))
    if cfg.out_sparse_ply and rec.points:
        write_ply(cfg.out_sparse_ply, np.stack(list(rec.points.values())))
    return rec
