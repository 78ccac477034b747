"""The SfM slice of the port as a whole (`tpu3drec_torch/sfm/incremental.py`,
`pipelines/sfm_pipeline.py`, the `sfm` subcommand of `pipelines/cli.py`)
against the JAX package on the CPU, on the rendered scene of
tests/test_sfm_e2e.py.

The two packages draw RANSAC samples from different generators, so their
reconstructions agree as geometry, not bit for bit: the port meets that
test's bars (>= 5 of 6 frames, >= 20 landmarks, ATE under 5% of the
trajectory after similarity alignment), registers the same frames as the
JAX run, and its camera centres, aligned to the JAX run's by a
similarity, lie within 2% of the trajectory length of them.
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec.pipelines import sfm_pipeline as jpipe
from tpu3drec.sfm import incremental as jinc
from tpu3drec.utils import plyio as jply
from tpu3drec.utils import poseio as jpose
from tpu3drec_torch.pipelines import cli, sfm_pipeline
from tpu3drec_torch.sfm import incremental
from tpu3drec_torch.utils import plyio, poseio

from test_sfm_e2e import K, _camera_center, _render


@pytest.fixture(scope="module")
def scene():
    """tests/test_sfm_e2e.py's scene: 54 blob constellations, 6 frames."""
    rng = np.random.default_rng(7)
    gx, gz = np.meshgrid(np.linspace(-4, 6, 9), np.linspace(8, 16, 6))
    X = np.stack([gx.ravel(), np.zeros(gx.size), gz.ravel()], -1)
    X += rng.uniform(-0.45, 0.45, size=X.shape)
    X[:, 1] = rng.uniform(-2.0, 2.0, size=X.shape[0])
    n = X.shape[0]
    amps = rng.uniform(0.4, 1.0, size=(n, 4))
    sats = rng.uniform(-0.35, 0.35, size=(n, 3, 3))
    poses = []
    for f in range(6):
        R = ScipyR.from_rotvec([0, 0.03 * f, 0]).as_matrix().astype(np.float32)
        C = np.array([0.5 * f, 0.05 * f, 0.3 * f], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    images = np.stack([_render(X, R, t, amps, sats) for R, t in poses])
    return images, poses


@pytest.fixture(scope="module")
def jax_rec(scene):
    return jinc.run_sfm(scene[0], K, max_keypoints=128, overlap=3, seed=0)


@pytest.fixture(scope="module")
def port_rec(scene):
    return incremental.run_sfm(scene[0], K, max_keypoints=128, overlap=3, seed=0, device="cpu")


def _align(src, dst):
    """Similarity (Umeyama) alignment of src onto dst, both (N, 3)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    U, S, Vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s) / len(src))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    s = np.trace(np.diag(S) @ D) / ((src - mu_s) ** 2).sum(1).mean()
    return s * (src - mu_s) @ (U @ D @ Vt).T + mu_d


def _centres(rec, frames):
    return np.stack([_camera_center(*rec.poses[f]) for f in frames]).astype(np.float64)


def _assert_reference_bars(rec, poses):
    frames = rec.registered_frames()
    assert len(frames) >= 5, f"only registered {frames}"
    assert len(rec.points) >= 20
    est = _centres(rec, frames)
    gt = np.stack([_camera_center(*poses[f]) for f in frames]).astype(np.float64)
    ate = np.sqrt(((_align(est, gt) - gt) ** 2).sum(-1).mean())
    traj = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert ate < 0.05 * traj, f"ATE {ate:.3f} vs traj {traj:.3f}"
    return traj


def test_run_sfm_meets_the_reference_bars(scene, port_rec):
    _assert_reference_bars(port_rec, scene[1])
    assert set(port_rec.seconds) == set(incremental.STAGES)
    assert port_rec.keypoints.shape == (6, 128, 2)


def test_run_sfm_agrees_with_jax(scene, port_rec, jax_rec):
    traj = _assert_reference_bars(jax_rec, scene[1])
    frames = jax_rec.registered_frames()
    assert port_rec.registered_frames() == frames
    ours, theirs = _centres(port_rec, frames), _centres(jax_rec, frames)
    dist = np.linalg.norm(_align(ours, theirs) - theirs, axis=1)
    assert dist.max() < 0.02 * traj, dist
    # the same features, matched and verified the same way, give tracks of
    # the same size (RANSAC differs only in its random draws)
    assert abs(len(port_rec.tracks) - len(jax_rec.tracks)) <= 0.1 * len(jax_rec.tracks)


def test_run_sfm_is_reproducible(scene, port_rec):
    again = incremental.run_sfm(scene[0][:3], K, max_keypoints=128, overlap=3, seed=0,
                                device="cpu")
    once = incremental.run_sfm(scene[0][:3], K, max_keypoints=128, overlap=3, seed=0,
                               device="cpu")
    for f in once.registered_frames():
        np.testing.assert_array_equal(once.poses[f][0], again.poses[f][0])
    with pytest.raises(ValueError):
        incremental.run_sfm(scene[0][:1], K, device="cpu")


def test_build_tracks_matches_jax(rng):
    m = {
        (0, 1): (np.array([5, 6]), np.array([7, 8])),
        (1, 2): (np.array([7, 8]), np.array([9, 9])),
        (0, 2): (np.array([5]), np.array([9])),
        (2, 3): (np.array([1, 2, 3]), np.array([4, 5, 6])),
    }
    for _ in range(3):
        i = int(rng.integers(0, 4))
        m[(i, i + 1)] = (rng.integers(0, 12, 20), rng.integers(0, 12, 20))
        assert incremental.build_tracks(m) == jinc.build_tracks(m)
    assert incremental.build_tracks({(0, 1): (np.array([5, 6]), np.array([7, 7]))}) == {}


def test_pose_records_and_metric_scale_match_jax(port_rec):
    """The pipeline's helpers against the JAX package's on the same
    reconstruction."""
    recs = sfm_pipeline.reconstruction_to_pose_records(port_rec, device="cpu")
    jrecs = jpipe.reconstruction_to_pose_records(port_rec)
    assert [r.frame_id for r in recs] == [r.frame_id for r in jrecs]
    for a, b in zip(recs, jrecs):
        np.testing.assert_allclose(a.q_xyzw, b.q_xyzw, atol=1e-6)
        np.testing.assert_array_equal(a.t, b.t)
    from tpu3drec_torch.utils.config import CameraConfig

    cam = CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                       cy=float(K[1, 2]), width=160, height=120)
    depth = np.full((6, 120, 160), 7.5, np.float32)
    s = sfm_pipeline.metric_scale_from_depth(port_rec, depth, cam)
    assert s == jpipe.metric_scale_from_depth(port_rec, depth, cam.to_camera(device="cpu"))


def test_sfm_pipeline_run(scene, tmp_path):
    cfg = sfm_pipeline.SfmPipelineConfig(max_keypoints=128, out_poses=str(tmp_path / "p.txt"),
                                         out_sparse_ply=str(tmp_path / "s.ply"))
    depth = np.full((6, 120, 160), 7.5, np.float32)
    from tpu3drec_torch.utils.config import CameraConfig

    cam = CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                       cy=float(K[1, 2]), width=160, height=120)
    rec = sfm_pipeline.run(scene[0], K, cfg, depth_maps=depth, cam_cfg=cam, device="cpu")
    _assert_reference_bars(rec, scene[1])
    rows = poseio.read_pose_txt(cfg.out_poses)
    assert [r.frame_id for r in rows] == rec.registered_frames()
    assert [r.frame_id for r in jpose.read_pose_txt(cfg.out_poses)] == rec.registered_frames()
    pts, _ = plyio.read_ply(cfg.out_sparse_ply)
    jpts, _ = jply.read_ply(cfg.out_sparse_ply)
    assert pts.shape == (len(rec.points), 3)
    np.testing.assert_array_equal(pts, jpts)
    # metric scaling put the landmarks at the depth maps' 7.5 m
    z = [(R @ X + t)[2] for f, (R, t) in rec.poses.items() for tid, X in rec.points.items()
         if f in rec.tracks[tid]]
    assert abs(np.median(z) - 7.5) < 0.5


def test_cli_sfm_on_pngs(scene, tmp_path, capsys):
    from PIL import Image

    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    for f, img in enumerate(scene[0]):
        Image.fromarray((img * 255).round().astype(np.uint8)).save(img_dir / f"{f:03d}.png")
    poses_txt, sparse = str(tmp_path / "poses.txt"), str(tmp_path / "sparse.ply")
    cli.main(["--device", "cpu", "sfm", str(img_dir), "--fx", "140", "--fy", "140",
              "--cx", "80", "--cy", "60", "--max-keypoints", "128",
              "--out-poses", poses_txt, "--out-ply", sparse])
    assert "registered" in capsys.readouterr().out
    rows = poseio.read_pose_txt(poses_txt)
    jrows = jpose.read_pose_txt(poses_txt)
    assert len(rows) >= 5 and [r.frame_id for r in rows] == [r.frame_id for r in jrows]
    assert rows[0].image_name == "000.png"
    for a, b in zip(rows, jrows):
        np.testing.assert_array_equal(a.t, b.t)
        np.testing.assert_array_equal(a.q_xyzw, b.q_xyzw)
    pts, _ = plyio.read_ply(sparse)
    np.testing.assert_array_equal(pts, jply.read_ply(sparse)[0])
    assert pts.shape[0] >= 20 and np.isfinite(pts).all()
    assert os.path.getsize(sparse) > 0
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["sfm", str(img_dir), "--out-poses", poses_txt, "--out-ply", sparse])


def test_sfm_entry_points_default_to_the_card(port_rec):
    """device=None means CUDA for every public entry point of the SfM
    slice; without a card each raises and none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sfm_pipeline.reconstruction_to_pose_records(port_rec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_rec.cameras_as_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sfm_pipeline.run(np.zeros((2, 8, 8), np.float32), np.eye(3, dtype=np.float32))
