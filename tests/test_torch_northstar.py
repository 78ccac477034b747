"""tests/test_northstar_e2e.py on the port: simulated capture (the port's
capture simulator, bit-equal to the reference's) -> incremental SfM ->
metric scale from depth -> pose txt and sparse PLY -> ATE, with the
reference test's bars, on the CPU. The port's camera configuration is
passed where the reference passes its own.
"""

import copy

import numpy as np
import pytest
import torch

from tpu3drec_torch.data.capture_sim import CaptureSim, SimScene, render_frame
from tpu3drec_torch.pipelines.sfm_pipeline import (
    apply_scale, metric_scale_from_depth, reconstruction_to_pose_records)
from tpu3drec_torch.sfm.incremental import run_sfm
from tpu3drec_torch.utils.config import CameraConfig
from tpu3drec_torch.utils.plyio import read_ply, write_ply
from tpu3drec_torch.utils.poseio import read_pose_txt, write_pose_txt
from tpu3drec_torch.utils.trajectory_eval import ate, trajectory_length

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def captured():
    rng = np.random.default_rng(3)
    scene = SimScene.clustered(rng, n_landmarks=200, sats=4)
    cam = CameraConfig(fx=220.0, fy=220.0, cx=128.0, cy=96.0, width=256, height=192)
    poses = CaptureSim(scene, cam=cam).fly(8, step=np.array([0.6, 0.0, 0.4]), yaw_rate=0.012)
    frames = [render_frame(scene, R, t, cam) for R, t in poses]
    images = np.stack([f[0].mean(-1).astype(np.float32) / 255.0 for f in frames])
    depths = np.stack([f[1] for f in frames])
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    return images, depths, poses, K, cam


@pytest.fixture(scope="module")
def reconstruction(captured):
    images, _, _, K, _ = captured
    return run_sfm(images, K, max_keypoints=256, overlap=3, seed=0, device="cpu")


def _centres(rec, frames):
    return np.stack([-rec.poses[f][0].T @ rec.poses[f][1] for f in frames])


def test_trajectory_within_ate_bound(captured, reconstruction):
    _, _, poses, _, _ = captured
    frames = reconstruction.registered_frames()
    assert len(frames) == len(poses), f"registered only {frames}"
    gt = np.stack([-poses[f][0].T @ poses[f][1] for f in frames])
    err, _, _ = ate(_centres(reconstruction, frames), gt)
    assert err < 0.02 * trajectory_length(gt), (err, trajectory_length(gt))


def test_metric_scale_recovery(captured, reconstruction):
    """The recovered landmark-depth scale and the trajectory-implied scale
    agree coarsely (narrow-FOV forward motion has a weak structure-vs-
    baseline mode), and applying it moves the trajectory toward metric."""
    _, depths, poses, _, cam = captured
    rec = copy.deepcopy(reconstruction)
    frames = rec.registered_frames()
    scale = metric_scale_from_depth(rec, depths, cam)
    est0 = _centres(rec, frames)
    gt = np.stack([-poses[f][0].T @ poses[f][1] for f in frames])
    gt_len = trajectory_length(gt)
    err_before = abs(trajectory_length(est0) - gt_len)
    apply_scale(rec, scale)
    err_after = abs(trajectory_length(_centres(rec, frames)) - gt_len)
    implied = gt_len / trajectory_length(est0)
    assert scale > 0
    assert abs(scale - implied) / implied < 0.4, (scale, implied)
    assert err_after < err_before


def test_pose_export_contract(tmp_path, reconstruction):
    records = reconstruction_to_pose_records(reconstruction, device="cpu")
    p = str(tmp_path / "poses.txt")
    write_pose_txt(p, records)
    assert len(read_pose_txt(p)) == len(reconstruction.poses)
    pts = np.stack(list(reconstruction.points.values()))
    write_ply(str(tmp_path / "sparse.ply"), pts)
    got, _ = read_ply(str(tmp_path / "sparse.ply"))
    assert got.shape[0] == len(reconstruction.points)


def test_depth_prior_sfm_is_metric(captured):
    """With depth priors in BA the trajectory comes out metric without any
    post-hoc scale correction."""
    images, depths, poses, K, _ = captured
    rec = run_sfm(images, K, max_keypoints=256, overlap=3, seed=0, depth_maps=depths,
                  depth_weight=2.0, device="cpu")
    frames = rec.registered_frames()
    assert len(frames) == len(poses)
    est = _centres(rec, frames)
    gt = np.stack([-poses[f][0].T @ poses[f][1] for f in frames])
    est_len, gt_len = trajectory_length(est), trajectory_length(gt)
    assert abs(est_len - gt_len) / gt_len < 0.1, (est_len, gt_len)
    err, _, _ = ate(est, gt)
    assert err < 0.03 * gt_len
