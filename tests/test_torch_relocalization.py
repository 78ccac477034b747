"""tests/test_loopclosure.py::test_relocalization_unlocks_disconnected_window
on the port, held to the JAX package's outputs on the same frames.

Frames 12-19 replay frames 0-7: an 8-frame revisit arc with no sequential
connection to the first pass, which loop closures must anchor. The
reference test asks for >= 6 placed replay frames, each within 1.0 m of
its first-pass twin; the JAX package itself misses that bound (it places
frame 12 1.62 m from its twin, VERDICT.md), so the port is held to what
the JAX package gives here: the same replay frames placed, none farther
from its twin than the JAX run puts it (+ 0.05 m). The port also meets
the reference test's own bound, and is held to it.
"""

import numpy as np
import pytest
import torch

from tpu3drec.pipelines import kitti as jkitti
from tpu3drec_torch.data.capture_sim import CaptureSim, SimScene, render_frame
from tpu3drec_torch.pipelines import kitti
from tpu3drec_torch.utils.config import CameraConfig

torch.set_num_threads(2)
CFG = dict(window=8, stride=4, max_keypoints=256, loop_closure=True, lc_min_gap=10, lc_sim=0.8)


@pytest.fixture(scope="module")
def replay():
    rng = np.random.default_rng(11)
    scene = SimScene.clustered(rng, n_landmarks=420, sats=4, extent=((-25, -6, 8), (40, 6, 60)))
    cam = CameraConfig(fx=220.0, fy=220.0, cx=128.0, cy=96.0, width=256, height=192)
    fwd = CaptureSim(scene, cam=cam).fly(12, step=np.array([0.55, 0.0, 0.35]), yaw_rate=0.01)
    frames = [render_frame(scene, R, t, cam) for R, t in fwd]
    images = np.stack([f[0].mean(-1).astype(np.float32) / 255.0 for f in frames])
    images = np.concatenate([images, images[:8]], axis=0)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    return images, K


def _twin_distances(Ts):
    return {f: float(np.linalg.norm(Ts[f][:3, 3] - Ts[f - 12][:3, 3]))
            for f in range(12, 20) if Ts[f] is not None and Ts[f - 12] is not None}


def test_relocalization_unlocks_disconnected_window(replay):
    images, K = replay
    Ts, _ = kitti.run_windowed_sfm(images, K, kitti.KittiRunConfig(**CFG), device="cpu")
    Tj, _ = jkitti.run_windowed_sfm(images, K, jkitti.KittiRunConfig(**CFG))
    placed = [f for f in range(12, 20) if Ts[f] is not None]
    assert placed == [f for f in range(12, 20) if Tj[f] is not None]
    assert len(placed) >= 6, placed
    got, want = _twin_distances(Ts), _twin_distances(Tj)
    assert sorted(got) == sorted(want)
    for f in got:
        assert got[f] <= want[f] + 0.05, (f, got[f], want[f])
        assert got[f] < 1.0, (f, got[f])
