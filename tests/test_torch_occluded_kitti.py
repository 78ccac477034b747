"""The port's windowed SfM on the occlusion-heavy PlanarScene sim (the
`slow` analogue of `tests/test_occluded_kitti.py`): the same scenes,
rendered by the JAX package's simulator, through
`tpu3drec_torch.pipelines.kitti.run_windowed_sfm` on the CPU, held to the
reference test's bars (coverage and similarity-aligned ATE).
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec.data.capture_sim import PlanarScene, orbit_poses
from tpu3drec.utils.config import CameraConfig
from tpu3drec_torch.pipelines.kitti import KittiRunConfig, evaluate_sequence, run_windowed_sfm


def _gt_T(poses):
    out = []
    for R, t in poses:
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        out.append(T)
    return np.stack(out)


def _run(scene, cam, poses, loop_closure):
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    frames = [scene.render(R, t, cam) for R, t in poses]
    images = np.stack([f[0].mean(-1).astype(np.float32) / 255.0 for f in frames])
    cfg = KittiRunConfig(window=8, stride=4, max_keypoints=1024, loop_closure=loop_closure)
    Ts, _ = run_windowed_sfm(images, K, cfg, device="cpu")
    return evaluate_sequence(Ts, _gt_T(poses))


@pytest.mark.slow
def test_windowed_sfm_native_kitti_geometry():
    """A forward pass at native KITTI resolution and intrinsics: coverage
    above 0.9, ATE within 5% of the trajectory."""
    scene = PlanarScene.urban(np.random.default_rng(4), n_boxes=14, extent=40.0)
    cam = CameraConfig(fx=718.9, fy=718.9, cx=607.0, cy=185.0, width=1241, height=376)
    poses = []
    for f in range(12):
        R = ScipyR.from_rotvec([0, 0.012 * f, 0]).as_matrix().astype(np.float32)
        C = np.array([0.45 * f, -1.0, 0.9 * f], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    m = _run(scene, cam, poses, loop_closure=False)
    assert m["coverage"] > 0.9, m
    assert m["ate_rms"] < 0.05 * m["traj_len"], m


@pytest.mark.slow
def test_loop_closure_on_occluded_orbit():
    """An inward-looking loop around the occluded arena at 640x480 with
    loop closure: coverage above 0.85, ATE within 8% of the trajectory."""
    scene = PlanarScene.arena(np.random.default_rng(7), n_boxes=10)
    cam = CameraConfig(fx=440.0, fy=440.0, cx=320.0, cy=240.0, width=640, height=480)
    poses = orbit_poses(28, [0.0, 0.0, 20.0], 16.0, span_deg=360.0)
    m = _run(scene, cam, poses, loop_closure=True)
    assert m["coverage"] > 0.85, m
    assert m["ate_rms"] < 0.08 * m["traj_len"], m
