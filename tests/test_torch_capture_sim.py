"""Parity of the port's capture simulator (`tpu3drec_torch/data/capture_sim.py`)
and of the port's sequence tool (`tools/ate_torch.py`) with the JAX
package's (`tpu3drec/data/capture_sim.py`, `tools/ate_benchmark.py`).

The port copies the reference's numpy arithmetic, so every comparison is
exact (`np.array_equal`): scenes, trajectories, rendered RGB and depth,
stereo pairs, the noisy frames of `render_sequence` (rendered in worker
processes, noise drawn in frame order), and the files `CaptureSim.capture`
writes.
"""

import os
import sys

import numpy as np
import pytest

from tpu3drec.data import capture_sim as jcs
from tpu3drec.utils.config import CameraConfig as JCam
from tpu3drec_torch.data import capture_sim as tcs
from tpu3drec_torch.utils.config import CameraConfig as TCam

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import ate_benchmark  # noqa: E402
import ate_torch  # noqa: E402

CAM = dict(fx=220.0, fy=220.0, cx=128.0, cy=96.0, width=256, height=192)


def _same(a, b):
    """Two dataclass scenes (or lists of them) hold equal arrays and values."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            _same(getattr(a, k), getattr(b, k))
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_sim_scene_and_splat_render_equal(kind):
    make = lambda m: getattr(m.SimScene, kind)(np.random.default_rng(3))  # noqa: E731
    sj, st = make(jcs), make(tcs)
    _same(sj, st)
    sim_j, sim_t = jcs.CaptureSim(sj, cam=JCam(**CAM)), tcs.CaptureSim(st, cam=TCam(**CAM))
    poses_j = sim_j.fly(3, step=np.array([0.6, 0.0, 0.4]), yaw_rate=0.012)
    poses_t = sim_t.fly(3, step=np.array([0.6, 0.0, 0.4]), yaw_rate=0.012)
    _same(poses_j, poses_t)
    for R, t in poses_j:
        rgb_j, d_j = jcs.render_frame(sj, R, t, JCam(**CAM))
        rgb_t, d_t = tcs.render_frame(st, R, t, TCam(**CAM))
        assert np.array_equal(rgb_j, rgb_t) and np.array_equal(d_j, d_t)


@pytest.mark.parametrize("kind", ["urban", "arena", "room"])
def test_planar_scenes_equal(kind):
    sj = getattr(jcs.PlanarScene, kind)(np.random.default_rng(7))
    st = getattr(tcs.PlanarScene, kind)(np.random.default_rng(7))
    _same(sj.quads, st.quads)
    _same(sj.light_dir, st.light_dir)


def test_arena_orbit_and_stereo_render_equal():
    sj = jcs.PlanarScene.arena(np.random.default_rng(7), n_boxes=4)
    st = tcs.PlanarScene.arena(np.random.default_rng(7), n_boxes=4)
    cam = dict(CAM, width=96, height=64, cx=48.0, cy=32.0)
    pj = jcs.orbit_poses(2, (0.0, 0.0, 20.0), 16.0, span_deg=40)
    pt = tcs.orbit_poses(2, (0.0, 0.0, 20.0), 16.0, span_deg=40)
    _same(pj, pt)
    for a, b in zip(jcs.render_stereo_pairs(sj, pj, JCam(**cam)),
                    tcs.render_stereo_pairs(st, pt, TCam(**cam))):
        assert np.array_equal(a, b)


def test_capture_writes_the_same_dataset(tmp_path):
    sj = jcs.SimScene.clustered(np.random.default_rng(5), n_landmarks=60)
    st = tcs.SimScene.clustered(np.random.default_rng(5), n_landmarks=60)
    cam = dict(CAM, width=128, height=96, cx=64.0, cy=48.0)
    sim_j, sim_t = jcs.CaptureSim(sj, cam=JCam(**cam)), tcs.CaptureSim(st, cam=TCam(**cam))
    poses = sim_j.fly(3)
    rj = sim_j.capture(str(tmp_path / "j"), poses)
    rt = sim_t.capture(str(tmp_path / "t"), poses)
    for a, b in zip(rj, rt):
        assert a.frame_id == b.frame_id and a.image_name == b.image_name
        assert np.array_equal(a.t, b.t)
        np.testing.assert_allclose(a.q_xyzw, b.q_xyzw, rtol=0, atol=1e-7)
    for sub in ("front/0.jpg", "front/2.jpg", "depth/1.png"):
        assert (tmp_path / "j" / sub).read_bytes() == (tmp_path / "t" / sub).read_bytes(), sub
    assert (tmp_path / "j/poses.txt").read_text() == (tmp_path / "t/poses.txt").read_text()


def test_m00_scene_and_trajectory_equal():
    seed, n_boxes, ext, frac = ate_torch.SEQ_LAYOUTS["m00"]
    assert ate_benchmark.SEQ_LAYOUTS == ate_torch.SEQ_LAYOUTS
    assert (ate_torch.FX, ate_torch.FY, ate_torch.CX, ate_torch.CY, ate_torch.WIDTH,
            ate_torch.HEIGHT) == (ate_benchmark.FX, ate_benchmark.FY, ate_benchmark.CX,
                                  ate_benchmark.CY, ate_benchmark.WIDTH, ate_benchmark.HEIGHT)
    _same(ate_benchmark.build_scene(seed, n_boxes, ext, corner_frac=frac).quads,
          ate_torch.build_scene(seed, n_boxes, ext, corner_frac=frac).quads)
    _same(ate_benchmark.city_block_trajectory(150, *ext, corner_frac=frac),
          ate_torch.city_block_trajectory(150, *ext, corner_frac=frac))


def test_m00_planar_render_equal():
    """PlanarScene.render at full width (640x192) on three frames of the
    150-frame m00 loop: a straight, a corner and the far side."""
    seed, n_boxes, ext, frac = ate_torch.SEQ_LAYOUTS["m00"]
    sj = ate_benchmark.build_scene(seed, n_boxes, ext, corner_frac=frac)
    st = ate_torch.build_scene(seed, n_boxes, ext, corner_frac=frac)
    poses = ate_torch.city_block_trajectory(150, *ext, corner_frac=frac)
    cam = dict(fx=ate_torch.FX, fy=ate_torch.FY, cx=ate_torch.CX, cy=ate_torch.CY,
               width=ate_torch.WIDTH, height=ate_torch.HEIGHT)
    for f in (0, 20, 75):
        R, t = poses[f]
        rgb_j, d_j = sj.render(R, t, JCam(**cam), max_depth=120.0)
        rgb_t, d_t = st.render(R, t, TCam(**cam), max_depth=120.0)
        assert np.array_equal(rgb_j, rgb_t) and np.array_equal(d_j, d_t), f


def test_render_sequence_equal():
    """Four noisy frames of m00 with their depth priors: rendered by two
    worker processes in the port, serially in the reference."""
    want = ate_benchmark.render_sequence("m00", 4, cache_dir=None)
    got = ate_torch.render_sequence("m00", 4, workers=2)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
