"""What an SfM job is judged by: the scene's true poses and a plain top-2.

`trajectory` reads a written pose txt (the reference's COLMAP export:
``id,tx,ty,tz,qx,qy,qz,qw,name`` world->camera rows after one header
line) and returns the registered frames and the ATE of their camera
centres after a similarity alignment (`portbench/core/scenes.py::ate`), as
a share of the true trajectory's length. `top2_gap` holds a top-2 match of
descriptors against the dense product in float64; `top2_control` is the
control's top-2, the product on TF32-rounded inputs. Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.core.scenes import ate
from portbench.references.monodepth2 import tf32_round
from portbench.references.rgbd_fuse import quat_xyzw_to_matrix


def read_pose_txt(path: str) -> dict:
    """frame id -> (t (3,), q_xyzw (4,)) float64; the first line is a header."""
    out = {}
    with open(path) as f:
        lines = f.read().splitlines()[1:]
    for line in lines:
        if line.strip():
            cols = line.split(",")
            out[int(cols[0])] = (np.array(cols[1:4], np.float64), np.array(cols[4:8], np.float64))
    return out


def trajectory(path: str, gt_poses) -> tuple[int, float]:
    """(frames in the file, ATE / trajectory length); ``gt_poses`` is the
    scene's list of world->camera (R, t)."""
    rows = read_pose_txt(path)
    frames = sorted(rows)
    if len(frames) < 3 or frames[-1] >= len(gt_poses):
        return len(frames), float("inf")
    t = np.stack([rows[f][0] for f in frames])
    R = quat_xyzw_to_matrix(np.stack([rows[f][1] for f in frames]))
    est = -np.einsum("fji,fj->fi", R, t)  # centres -R^T t
    gt = np.stack([-np.asarray(gt_poses[f][0], np.float64).T @ np.asarray(gt_poses[f][1], np.float64)
                   for f in frames])
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return len(frames), ate(est, gt) / length


def top2_gap(a, b, valid_b, best, top2) -> float:
    """Largest gap of a returned top-2 (``best`` (P, Ka), ``top2`` (P, Ka, 2))
    from the dense product of descriptors ``a`` (P, Ka, D) and ``b`` (P, Kb,
    D) masked by ``valid_b``: over rows with two valid candidates, the
    larger of |s1 - s1_ref|, |s2 - s2_ref| and s1_ref minus the reference's
    score at the returned index. The product is float64."""
    with torch.no_grad():
        s = torch.matmul(a.double(), b.double().transpose(1, 2))
        s = torch.where(valid_b[:, None, :].bool(), s, -torch.inf)
        ref = torch.topk(s, 2, dim=-1).values
        rows = torch.isfinite(ref[..., 1])
        at = torch.gather(s, 2, best.long().clamp(0, s.shape[2] - 1)[..., None])[..., 0]
        gap = torch.stack([(top2[..., 0].double() - ref[..., 0]).abs(),
                           (top2[..., 1].double() - ref[..., 1]).abs(),
                           ref[..., 0] - at])
        gap = torch.where(rows[None], gap, torch.zeros_like(gap))
        return float(gap.max()) if bool(rows.any()) else float("inf")


def top2_control(a, b, valid_b):
    """The control's top-2: the TF32 product in the program's place."""
    s = torch.matmul(tf32_round(a.float()), tf32_round(b.float()).transpose(1, 2))
    s = torch.where(valid_b[:, None, :].bool(), s, torch.full_like(s, -3.0))
    vals, idx = torch.topk(s, 2, dim=-1)
    return idx[..., 0].int(), vals
