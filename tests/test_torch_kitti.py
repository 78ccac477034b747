"""The port's long-sequence pipeline (`tpu3drec_torch/pipelines/kitti.py`),
its KITTI reader (`tpu3drec_torch/data/kitti_odom.py`) and the `kitti-eval`
subcommand, against the JAX package on the CPU.

* `run_windowed_sfm` on tests/test_kitti_pipeline.py's `long_capture` (16
  frames of 256x192, window 8, stride 4, 256 keypoints; rendered by the
  port's capture simulator): coverage > 0.9 and ATE < 5% of the trajectory
  (that test's bars), and the port's camera centres, aligned to the JAX
  run's by a similarity, within 1% of the trajectory length of them. The
  two packages draw RANSAC samples from different generators, so they
  agree as geometry, not bit for bit.
* `parallel_windows` > 1 (threads on one device) equals the sequential run.
* The unit tests of tests/test_kitti_pipeline.py (stitch refusal,
  relocalization partners, the layout reader) and the non-`slow` metric
  closure tests of tests/test_loopclosure.py, on the port.
* `kitti-eval` on a KITTI-layout tree of rendered frames with
  `--device cpu`: the same frames registered and metrics as the JAX CLI's
  within 1% of the trajectory.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from tpu3drec.pipelines import cli as jcli
from tpu3drec.pipelines import kitti as jkitti
from tpu3drec_torch.data.capture_sim import CaptureSim, SimScene, render_frame
from tpu3drec_torch.data.kitti_odom import KittiOdometryDataset
from tpu3drec_torch.pipelines import cli, kitti
from tpu3drec_torch.pipelines.kitti import KittiRunConfig, evaluate_sequence, run_windowed_sfm
from tpu3drec_torch.sfm.loopclosure import LoopClosure
from tpu3drec_torch.utils.config import CameraConfig
from tpu3drec_torch.utils.trajectory_eval import ate, write_kitti_poses

torch.set_num_threads(2)
CFG = dict(window=8, stride=4, max_keypoints=256)


def _capture(n):
    rng = np.random.default_rng(11)
    scene = SimScene.clustered(rng, n_landmarks=420, sats=4, extent=((-25, -6, 8), (40, 6, 60)))
    cam = CameraConfig(fx=220.0, fy=220.0, cx=128.0, cy=96.0, width=256, height=192)
    poses = CaptureSim(scene, cam=cam).fly(n, step=np.array([0.55, 0.0, 0.35]), yaw_rate=0.01)
    frames = [render_frame(scene, R, t, cam) for R, t in poses]
    images = np.stack([f[0].mean(-1).astype(np.float32) / 255.0 for f in frames])
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    gt_T = []
    for R, t in poses:
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        gt_T.append(T)
    return images, np.stack(gt_T), K


@pytest.fixture(scope="module")
def long_capture():
    return _capture(16)


@pytest.fixture(scope="module")
def port_run(long_capture):
    images, _, K = long_capture
    state = {}
    Ts, recs = run_windowed_sfm(images, K, KittiRunConfig(**CFG), debug_state=state, device="cpu")
    return Ts, recs, state


@pytest.fixture(scope="module")
def jax_run(long_capture):
    images, _, K = long_capture
    return jkitti.run_windowed_sfm(images, K, jkitti.KittiRunConfig(**CFG))[0]


def test_windowed_sfm_stitches_long_sequence(long_capture, port_run):
    _, gt_T, _ = long_capture
    Ts, recs, _ = port_run
    assert len(recs) >= 2  # genuinely windowed
    m = evaluate_sequence(Ts, gt_T)
    assert m["coverage"] > 0.9
    assert m["ate_rms"] < 0.05 * m["traj_len"], m


def test_windowed_sfm_agrees_with_jax(long_capture, port_run, jax_run):
    _, gt_T, _ = long_capture
    Ts = port_run[0]
    both = [f for f in range(len(Ts)) if Ts[f] is not None and jax_run[f] is not None]
    assert [T is None for T in Ts] == [T is None for T in jax_run]
    est = np.stack([Ts[f][:3, 3] for f in both])
    ref = np.stack([jax_run[f][:3, 3] for f in both])
    err, _, _ = ate(est, ref)
    length = float(np.linalg.norm(np.diff(ref, axis=0), axis=1).sum())
    assert err < 0.01 * length, (err, length)
    mj = jkitti.evaluate_sequence(jax_run, gt_T)
    mt = evaluate_sequence(Ts, gt_T)
    assert mt["coverage"] == mj["coverage"]
    assert abs(mt["ate_rms"] - mj["ate_rms"]) < 0.01 * mj["traj_len"], (mt, mj)


def test_debug_state_holds_stage_seconds(port_run):
    _, recs, state = port_run
    assert set(state["seconds"]) == set(kitti.STAGES)
    assert all(v >= 0.0 for v in state["seconds"].values())
    assert len([w for w in state["window_seconds"] if w is not None]) == len(recs)
    assert len(state["stitched_Ts"]) == 16 and state["window_edges"]


def test_parallel_windows_match_sequential(long_capture):
    """Windows in threads on one device reproduce the sequential
    trajectory exactly (same generators, same stitch order)."""
    images, _, K = long_capture
    images = images[:12]
    seq = run_windowed_sfm(images, K, KittiRunConfig(**CFG, loop_closure=False, global_ba=False),
                           device="cpu")
    par = run_windowed_sfm(images, K, KittiRunConfig(**CFG, loop_closure=False, global_ba=False,
                                                     parallel_windows=3), device="cpu")
    assert len(seq[1]) == len(par[1])
    for a, b in zip(seq[0], par[0]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_run_windowed_sfm_defaults_to_the_card(long_capture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    images, _, K = long_capture
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_windowed_sfm(images, K, KittiRunConfig(**CFG))


# ------------------------------ unit tests of tests/test_kitti_pipeline.py

class TestClosureRobustness:
    def test_two_anchor_stitch_refuses_coincident_centers(self):
        T = np.eye(4)
        src = [T.copy(), T.copy()]
        src[1][:3, 3] = [1.0, 0.0, 0.0]
        dst = [T.copy(), T.copy()]
        assert kitti._similarity_from_pose_pairs(src, dst) is None
        assert kitti._similarity_from_pose_pairs(dst, src) is None
        dst2 = [T.copy(), T.copy()]
        dst2[1][:3, 3] = [2.0, 0.0, 0.0]
        s, R, t = kitti._similarity_from_pose_pairs(src, dst2)
        assert abs(s - 2.0) < 1e-9

    @staticmethod
    def _cl(i, j):
        return LoopClosure(i=i, j=j, R_rel=np.eye(3), t_dir=np.array([0.0, 0.0, 1.0]),
                           n_inliers=30, uv_i=np.zeros((1, 2), np.float32),
                           uv_j=np.zeros((1, 2), np.float32))

    def test_relocalize_prefers_distinct_partners(self):
        def T_at(c):
            T = np.eye(4)
            T[:3, 3] = c
            return T

        Ts = [T_at([0, 0, 0]), T_at([3, 0, 0])] + [None] * 8
        out = kitti._relocalize(Ts, [self._cl(0, 8), self._cl(0, 9), self._cl(1, 9)],
                                KittiRunConfig())
        np.testing.assert_allclose(out[8][:3, 3], [0, 0, 0], atol=1e-9)
        np.testing.assert_allclose(out[9][:3, 3], [3, 0, 0], atol=1e-9)

    def test_relocalize_reuses_partner_when_no_alternative(self):
        out = kitti._relocalize([np.eye(4), None, None], [self._cl(0, 1), self._cl(0, 2)],
                                KittiRunConfig())
        assert out[1] is not None and out[2] is not None


class TestMetricClosures:
    """tests/test_loopclosure.py's metric closures on the port, and the
    same numbers as the JAX package's functions."""

    def _synthetic_closure(self, mag=5.0, n=60):
        rng = np.random.default_rng(2)
        K = np.array([[220.0, 0, 128.0], [0, 220.0, 96.0], [0, 0, 1]], np.float32)
        H, W = 192, 256
        X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-5, 5, n), rng.uniform(8, 25, n)], 1)
        th = 0.12
        R_rel = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]], np.float64)
        t_dir = np.array([0.6, 0.1, 0.79])
        t_dir = t_dir / np.linalg.norm(t_dir)
        Xj = X @ R_rel.T + mag * t_dir

        def proj(P):
            return np.stack([P[:, 0] / P[:, 2] * K[0, 0] + K[0, 2],
                             P[:, 1] / P[:, 2] * K[1, 1] + K[1, 2]], axis=1)

        uv_i, uv_j = proj(X), proj(Xj)
        inb = ((uv_i[:, 0] > 0) & (uv_i[:, 0] < W - 1) & (uv_i[:, 1] > 0) & (uv_i[:, 1] < H - 1)
               & (uv_j[:, 0] > 0) & (uv_j[:, 0] < W - 1) & (uv_j[:, 1] > 0)
               & (uv_j[:, 1] < H - 1) & (Xj[:, 2] > 0.5))
        X, uv_i, uv_j = X[inb], uv_i[inb], uv_j[inb]
        dm = np.zeros((H, W), np.float32)
        dm[np.round(uv_i[:, 1]).astype(int), np.round(uv_i[:, 0]).astype(int)] = X[:, 2]
        c = LoopClosure(i=0, j=1, R_rel=R_rel.astype(np.float32),
                        t_dir=t_dir.astype(np.float32), n_inliers=len(uv_i),
                        uv_i=uv_i.astype(np.float32), uv_j=uv_j.astype(np.float32))
        return c, K, dm[None].repeat(2, axis=0), R_rel, t_dir, mag

    def test_metric_magnitude_from_depth(self):
        c, K, dms, _, _, mag = self._synthetic_closure(mag=5.0)
        assert c.n_inliers > 25
        est = kitti.closure_metric_magnitude(c, K, dms)
        assert est is not None and abs(est - mag) / mag < 0.03, est
        assert est == jkitti.closure_metric_magnitude(c, K, dms)

    def test_relocalize_places_offset_revisit_at_true_pose(self):
        c, K, dms, R_rel, t_dir, mag = self._synthetic_closure(mag=5.0)
        T0 = np.eye(4)
        ang = 0.4
        T0[:3, :3] = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                               [0, 0, 1]])
        T0[:3, 3] = [3.0, -1.0, 7.0]
        Ts = kitti._relocalize([T0, None], [c], KittiRunConfig(), K=K, depth_maps=dms)
        T_rel = np.eye(4)
        T_rel[:3, :3] = R_rel.T
        T_rel[:3, 3] = -R_rel.T @ (mag * t_dir)
        T1_gt = T0 @ T_rel
        assert Ts[1] is not None
        assert np.linalg.norm(Ts[1][:3, 3] - T1_gt[:3, 3]) < 0.25
        assert np.linalg.norm(Ts[1][:3, 3] - T0[:3, 3]) > 0.8 * mag
        want = jkitti._relocalize([T0, None], [c], jkitti.KittiRunConfig(), K=K, depth_maps=dms)
        np.testing.assert_array_equal(Ts[1], want[1])


# ------------------------------------------------------- layout and the CLI

def _write_tree(root, images, gt_T, K):
    seq = root / "sequences" / "00"
    os.makedirs(seq / "image_0")
    os.makedirs(root / "poses")
    for i, img in enumerate(images):
        Image.fromarray((img * 255).round().astype(np.uint8), mode="L").save(
            seq / "image_0" / f"{i:06d}.png")
    P = np.concatenate([K.astype(np.float64), np.zeros((3, 1))], 1).reshape(-1)
    with open(seq / "calib.txt", "w") as f:
        for c in range(4):
            f.write(f"P{c}: " + " ".join(f"{v:.6e}" for v in P) + "\n")
    write_kitti_poses(str(root / "poses" / "00.txt"), gt_T)


def test_reader(tmp_path, rng):
    seq = tmp_path / "sequences" / "00"
    os.makedirs(seq / "image_0")
    os.makedirs(tmp_path / "poses")
    for i in range(3):
        img = (rng.uniform(size=(40, 60)) * 255).astype(np.uint8)
        Image.fromarray(img, mode="L").save(seq / "image_0" / f"{i:06d}.png")
    with open(seq / "calib.txt", "w") as f:
        P = "7.0e+02 0 6.0e+02 0 0 7.0e+02 1.8e+02 0 0 0 1 0"
        for c in range(4):
            f.write(f"P{c}: {P}\n")
    Ts = np.tile(np.eye(4), (3, 1, 1))
    Ts[:, 0, 3] = np.arange(3)
    write_kitti_poses(str(tmp_path / "poses" / "00.txt"), Ts)

    ds = KittiOdometryDataset(str(tmp_path), "00")
    K = ds.calib()
    assert K[0, 0] == 700.0 and K[0, 2] == 600.0
    assert ds.num_frames() == 3
    imgs = ds.load_sequence()
    assert imgs.shape == (3, 40, 60)
    assert imgs.max() <= 1.0
    np.testing.assert_allclose(ds.gt_poses(), Ts, atol=1e-8)
    from tpu3drec.data.kitti_odom import KittiOdometryDataset as JDataset

    jds = JDataset(str(tmp_path), "00")
    np.testing.assert_array_equal(ds.load_sequence(size=(30, 20)), jds.load_sequence(size=(30, 20)))
    np.testing.assert_array_equal(K, jds.calib())


def test_kitti_eval_cli(tmp_path, long_capture, capsys):
    """`kitti-eval` on a 3-frame KITTI-layout tree of rendered frames, on
    the CPU, against the JAX CLI on the same tree."""
    images, gt_T, K = long_capture
    _write_tree(tmp_path, images[:3], gt_T[:3], K)
    args = ["kitti-eval", str(tmp_path), "--window", "3", "--stride", "2",
            "--max-keypoints", "256"]
    cli.main(["--device", "cpu"] + args)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    got = eval(out, {"__builtins__": {}}, {"inf": float("inf")})
    jcli.main(args)
    want = eval(capsys.readouterr().out.strip().splitlines()[-1], {"__builtins__": {}},
                {"inf": float("inf")})
    assert set(got) == set(want)
    assert got["coverage"] == want["coverage"] == 1.0
    assert abs(got["traj_len"] - want["traj_len"]) < 1e-3
    assert got["ate_rms"] < 0.05 * got["traj_len"], got
    assert abs(got["ate_rms"] - want["ate_rms"]) < 0.01 * want["traj_len"], (got, want)


def test_kitti_eval_needs_a_card_by_default(tmp_path, long_capture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    images, gt_T, K = long_capture
    _write_tree(tmp_path, images[:3], gt_T[:3], K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["kitti-eval", str(tmp_path), "--window", "3"])
