"""Trajectory evaluation: ATE / RPE and KITTI odometry pose IO (port of
`tpu3drec/utils/trajectory_eval.py`).

Absolute trajectory error after a similarity (Umeyama) alignment, and
relative pose error over fixed frame deltas. Host code: the alignment runs
the port's ``umeyama`` on float32 CPU tensors, as the reference runs its own
on float32 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3drec_torch.sfm.icp import umeyama


def read_kitti_poses(path: str) -> np.ndarray:
    """KITTI odometry ground-truth format: rows of 12 floats = 3x4 [R|t]
    (cam->world). Returns (F, 4, 4)."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    F = data.shape[0]
    T = np.tile(np.eye(4), (F, 1, 1))
    T[:, :3, :4] = data
    return T


def write_kitti_poses(path: str, Ts: np.ndarray) -> None:
    np.savetxt(path, np.asarray(Ts)[:, :3, :].reshape(len(Ts), 12), fmt="%.9e")


def camera_centers_w2c(Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """world->cam (R, t) stacks -> camera centers (F, 3)."""
    return -np.einsum("fji,fj->fi", Rs, ts)


def ate(est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True):
    """RMS absolute trajectory error after similarity (Umeyama) alignment.
    Returns (ate_rms, aligned_est, (s, R, t))."""
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    s, R, t = umeyama(f32(est_centers), f32(gt_centers), f32(np.ones(len(est_centers))),
                      with_scale=with_scale)
    s, R, t = float(s), R.numpy(), t.numpy()
    aligned = s * est_centers @ R.T + t
    err = np.sqrt(((aligned - gt_centers) ** 2).sum(-1).mean())
    return err, aligned, (s, R, t)


def rpe(est_T: np.ndarray, gt_T: np.ndarray, delta: int = 1):
    """Relative pose error over frame deltas of (F, 4, 4) cam->world poses:
    returns (trans_rmse, rot_rmse_rad)."""
    t_errs, r_errs = [], []
    for i in range(len(est_T) - delta):
        de = np.linalg.inv(est_T[i]) @ est_T[i + delta]
        dg = np.linalg.inv(gt_T[i]) @ gt_T[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(cos))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(
        np.sqrt(np.mean(np.square(r_errs))))


def trajectory_length(centers: np.ndarray) -> float:
    return float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())
