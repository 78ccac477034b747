"""Parity of the port's capture degradations (`tpu3drec_torch/data/degrade.py`)
with the JAX package's (`tpu3drec/data/degrade.py`), on
tests/test_degradation.py's cases.

Both are numpy and `scipy.ndimage` on the host, so every array is held
exactly equal (`np.array_equal`) on the same inputs and the same generator
state; the reference's own assertions are kept beside them. The `slow`
case runs tests/test_degradation.py's end-to-end robustness claim through
the port's windowed SfM.
"""

import os
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec.data import degrade as jdeg
from tpu3drec.utils.config import CameraConfig as JCam
from tpu3drec_torch.data import degrade as tdeg
from tpu3drec_torch.utils.config import CameraConfig as TCam

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import ate_benchmark  # noqa: E402
import ate_torch  # noqa: E402


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_motion_blur_is_directional():
    img = np.zeros((64, 64), np.float32)
    img[:, 32] = 1.0
    img_h = np.zeros((64, 64), np.float32)
    img_h[32, :] = 1.0
    bx = tdeg.motion_blur(img, np.array([1.0, 0.0]), 6.0)
    bh = tdeg.motion_blur(img_h, np.array([1.0, 0.0]), 6.0)
    _equal(bx, jdeg.motion_blur(img, np.array([1.0, 0.0]), 6.0))
    _equal(bh, jdeg.motion_blur(img_h, np.array([1.0, 0.0]), 6.0))
    assert bx[32, 32] < 0.5
    np.testing.assert_allclose(bh[32], img_h[32], atol=1e-5)
    _equal(tdeg.motion_blur(img, np.array([1.0, 0.0]), 0.1), img)  # too short: unchanged


def test_motion_blur_preserves_mean(rng):
    img = rng.uniform(size=(48, 48)).astype(np.float32)
    b = tdeg.motion_blur(img, np.array([0.6, 0.8]), 4.0)
    _equal(b, jdeg.motion_blur(img, np.array([0.6, 0.8]), 4.0))
    assert abs(b[8:-8, 8:-8].mean() - img[8:-8, 8:-8].mean()) < 0.01
    assert b.std() < img.std()


def test_defocus_and_vignette(rng):
    img = rng.uniform(size=(40, 40)).astype(np.float32)
    d = tdeg.defocus(img, 1.5)
    _equal(d, jdeg.defocus(img, 1.5))
    assert d.std() < img.std()
    ones = np.ones((40, 40), np.float32)
    v = tdeg.vignette(ones, strength=0.3)
    _equal(v, jdeg.vignette(ones, strength=0.3))
    rgb = rng.uniform(size=(20, 30, 3)).astype(np.float32)
    _equal(tdeg.vignette(rgb), jdeg.vignette(rgb))
    assert v[20, 20] > v[0, 0] > 0.6


def test_motion_direction_tracks_turn():
    kw = dict(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
    poses = [(ScipyR.from_rotvec([0, 0.1 * f, 0]).as_matrix().astype(np.float32),
              np.zeros(3, np.float32)) for f in range(3)]
    for idx in (0, 1, 2):  # the last frame takes the pair before it
        d = tdeg.motion_direction_px(poses, TCam(**kw), idx)
        _equal(d, jdeg.motion_direction_px(poses, JCam(**kw), idx))
    d = tdeg.motion_direction_px(poses, TCam(**kw), 0)
    assert abs(d[0]) > 10 * abs(d[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degrade_sequence_shapes_and_range(seed):
    kw = dict(fx=300.0, fy=300.0, cx=80.0, cy=60.0, width=160, height=120)
    poses = [(np.eye(3, dtype=np.float32), np.array([0.1 * f, 0, 0], np.float32))
             for f in range(4)]
    imgs = np.random.default_rng(seed).uniform(size=(4, 120, 160)).astype(np.float32)
    out = tdeg.degrade_sequence(imgs, poses, TCam(**kw), np.random.default_rng(seed + 10))
    _equal(out, jdeg.degrade_sequence(imgs, poses, JCam(**kw), np.random.default_rng(seed + 10)))
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert not np.allclose(out, imgs)


def test_ate_tool_degraded_frames_equal():
    """`tools/ate_torch.py --degrade`'s frames are the benchmark's
    (`tools/ate_benchmark.py --degrade`), bit for bit: two frames of m00."""
    want = ate_benchmark.render_sequence("m00", 2, cache_dir=None, degrade=True)
    got = ate_torch.render_sequence("m00", 2, workers=1, degrade=True)
    for a, b in zip(want, got):
        _equal(a, b)
    clean = ate_torch.render_sequence("m00", 2, workers=1)
    assert not np.array_equal(clean[0], got[0])
    _equal(clean[1], got[1])


@pytest.mark.slow
def test_windowed_sfm_survives_degradation(rng):
    """tests/test_degradation.py's end-to-end claim through the port: the
    occluded urban drive still stitches under the full degradation stack,
    on frames equal to the reference test's."""
    from tpu3drec.data.capture_sim import PlanarScene
    from tpu3drec_torch.pipelines.kitti import (
        KittiRunConfig, evaluate_sequence, run_windowed_sfm)

    scene = PlanarScene.urban(rng, n_boxes=14, extent=40.0)
    kw = dict(fx=718.9, fy=718.9, cx=607.0, cy=185.0, width=1241, height=376)
    cam = JCam(**kw)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    poses = []
    for f in range(12):
        R = ScipyR.from_rotvec([0, 0.012 * f, 0]).as_matrix().astype(np.float32)
        C = np.array([0.45 * f, -1.0, 0.9 * f], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    frames = [scene.render(R, t, cam) for R, t in poses]
    images = np.stack([f[0].mean(-1).astype(np.float32) / 255.0 for f in frames])
    state = rng.bit_generator.state
    images_t = tdeg.degrade_sequence(images, poses, TCam(**kw), rng)
    rng.bit_generator.state = state
    _equal(images_t, jdeg.degrade_sequence(images, poses, cam, rng))

    cfg = KittiRunConfig(window=8, stride=4, max_keypoints=1024, loop_closure=False)
    Ts, _ = run_windowed_sfm(images_t, K, cfg, device="cpu")
    gt = []
    for R, t in poses:
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        gt.append(T)
    m = evaluate_sequence(Ts, np.stack(gt))
    assert m["coverage"] > 0.9, m
    assert m["ate_rms"] < 0.07 * m["traj_len"], m
