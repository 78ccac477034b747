"""Parity of the port's trajectory evaluation
(`tpu3drec_torch/utils/trajectory_eval.py`) with the JAX package's.

Tolerances: `write_kitti_poses` bytes equal and `read_kitti_poses` arrays
equal; `ate`, `rpe` and `trajectory_length` within 1e-5 relative (both
align with a float32 Umeyama; the rest is the same float64 numpy).
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec.utils import trajectory_eval as jte
from tpu3drec_torch.utils import trajectory_eval as tte

SEEDS = [0, 1, 2]


def _trajectory(rng, n=40):
    """cam->world poses along a noisy curve, and a drifted, scaled copy."""
    Ts = np.tile(np.eye(4), (n, 1, 1))
    yaw = np.cumsum(rng.normal(0.03, 0.02, n))
    Ts[:, :3, :3] = ScipyR.from_rotvec(np.stack([np.zeros(n), yaw, np.zeros(n)], 1)).as_matrix()
    Ts[:, :3, 3] = np.cumsum(rng.normal([0.5, 0.0, 0.3], 0.1, (n, 3)), axis=0)
    est = Ts.copy()
    est[:, :3, 3] = 1.7 * Ts[:, :3, 3] @ ScipyR.from_rotvec([0.1, -0.2, 0.3]).as_matrix().T
    est[:, :3, 3] += rng.normal(0, 0.05, (n, 3)) + [3.0, -1.0, 2.0]
    est[:, :3, :3] = est[:, :3, :3] @ ScipyR.from_rotvec(rng.normal(0, 0.01, (n, 3))).as_matrix()
    return Ts, est


@pytest.mark.parametrize("seed", SEEDS)
def test_kitti_pose_file_bytes_equal(seed, tmp_path):
    Ts, _ = _trajectory(np.random.default_rng(seed))
    jte.write_kitti_poses(str(tmp_path / "j.txt"), Ts)
    tte.write_kitti_poses(str(tmp_path / "t.txt"), Ts)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    np.testing.assert_array_equal(tte.read_kitti_poses(str(tmp_path / "j.txt")),
                                  jte.read_kitti_poses(str(tmp_path / "j.txt")))


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_ate_matches_jax(seed, with_scale):
    gt, est = _trajectory(np.random.default_rng(seed))
    ej, aj, (sj, Rj, tj) = jte.ate(est[:, :3, 3], gt[:, :3, 3], with_scale=with_scale)
    et, at, (st, Rt, tt) = tte.ate(est[:, :3, 3], gt[:, :3, 3], with_scale=with_scale)
    assert abs(et - ej) <= 1e-5 * ej
    assert abs(st - sj) <= 1e-5 * sj
    np.testing.assert_allclose(at, aj, rtol=1e-5, atol=1e-5 * np.abs(aj).max())


@pytest.mark.parametrize("delta", [1, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_rpe_and_length_match_jax(seed, delta):
    gt, est = _trajectory(np.random.default_rng(seed))
    tj, rj = jte.rpe(est, gt, delta=delta)
    tt, rt = tte.rpe(est, gt, delta=delta)
    assert abs(tt - tj) <= 1e-5 * tj and abs(rt - rj) <= 1e-5 * rj
    lj = jte.trajectory_length(gt[:, :3, 3])
    assert abs(tte.trajectory_length(gt[:, :3, 3]) - lj) <= 1e-5 * lj


def test_camera_centres_match_jax(rng):
    R = ScipyR.from_rotvec(rng.normal(0, 0.3, (7, 3))).as_matrix()
    t = rng.normal(0, 2, (7, 3))
    np.testing.assert_array_equal(tte.camera_centers_w2c(R, t), jte.camera_centers_w2c(R, t))
