"""tests/test_widebaseline.py on the port: the multi-octave front end's
yield on an occlusion-heavy textured arena orbited by inward-looking
cameras, with matches verified by the ground-truth depth of frame 0, at 20
and 30 degrees, and its two-view support at 20 degrees. The frames come
from the port's capture simulator (`tpu3drec_torch/data/capture_sim.py`,
bit-equal to the reference's).

Each test keeps the reference test's bar, and holds the port against the
JAX package on the same frames: the keypoints of the two packages agree as
position sets (>= 97% of each side within 1e-2 px of the other's: the
DoG-plateau difference of ROADMAP Queue C moves a few extrema), and the
verified match counts differ by at most 2 + 5% of the JAX count (measured:
33 / 22 / 4 for the port against 34 / 22 / 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.sfm.features import detect_and_describe as j_detect
from tpu3drec.sfm.matching import match_descriptors as j_match
from tpu3drec_torch.data.capture_sim import PlanarScene, orbit_poses
from tpu3drec_torch.sfm.features import detect_and_describe
from tpu3drec_torch.sfm.matching import match_descriptors
from tpu3drec_torch.sfm.twoview import estimate_relative_pose, normalize_points, sampson_error
from tpu3drec_torch.sfm.sampling import seeded_generator
from tpu3drec_torch.utils.config import CameraConfig

torch.set_num_threads(2)
CAM = CameraConfig(fx=220.0, fy=220.0, cx=160.0, cy=120.0, width=320, height=240)
CENTER = np.array([0.0, 0.0, 20.0])


@pytest.fixture(scope="module")
def arena_frames():
    rng = np.random.default_rng(7)
    scene = PlanarScene.arena(rng, n_boxes=10)
    out = {}
    for deg in (0, 20, 30):
        (R, t), = orbit_poses(1, CENTER, 16.0, start_deg=deg, span_deg=0)
        rgb, depth = scene.render(R, t, CAM)
        out[deg] = (R, t, np.asarray(rgb.mean(-1) / 255.0, np.float32), depth)
    return out


def _detect(gray, **kw):
    kps, desc = detect_and_describe(torch.as_tensor(gray), max_keypoints=1024, **kw)
    return kps, desc


def _verified(kp0, kp1, m_valid, m_ia, m_ib, frames, deg):
    """Matches of frame 0 against frame ``deg`` consistent with the known
    geometry through frame 0's true depth (reprojection < 4 px)."""
    R0, t0, _, d0 = frames[0]
    R1, t1, _, _ = frames[deg]
    ia, ib = m_ia[m_valid], m_ib[m_valid]
    if len(ia) == 0:
        return 0, 0
    xa, xb = kp0[ia], kp1[ib]
    u = np.clip(xa[:, 0].round().astype(int), 0, CAM.width - 1)
    vv = np.clip(xa[:, 1].round().astype(int), 0, CAM.height - 1)
    z = d0[vv, u]
    pc = np.stack([(xa[:, 0] - CAM.cx) / CAM.fx * z, (xa[:, 1] - CAM.cy) / CAM.fy * z, z], -1)
    pb = ((pc - t0) @ R0) @ R1.T + t1
    ub = pb[:, 0] / pb[:, 2] * CAM.fx + CAM.cx
    vb = pb[:, 1] / pb[:, 2] * CAM.fy + CAM.cy
    err = np.hypot(ub - xb[:, 0], vb - xb[:, 1])
    return len(ia), int(((z > 0.1) & (err < 4.0)).sum())


def _port_verified(frames, deg, **kw):
    k0, d0 = _detect(frames[0][2], **kw)
    k1, d1 = _detect(frames[deg][2], **kw)
    m = match_descriptors(d0, d1, k0.valid, k1.valid)
    return _verified(k0.xy.numpy(), k1.xy.numpy(), m.valid.numpy(), m.idx_a.numpy(),
                     m.idx_b.numpy(), frames, deg)


def _jax_verified(frames, deg, **kw):
    k0, d0 = j_detect(jnp.asarray(frames[0][2]), max_keypoints=1024, **kw)
    k1, d1 = j_detect(jnp.asarray(frames[deg][2]), max_keypoints=1024, **kw)
    m = j_match(d0, d1, k0.valid, k1.valid)
    return _verified(np.asarray(k0.xy), np.asarray(k1.xy), np.asarray(m.valid),
                     np.asarray(m.idx_a), np.asarray(m.idx_b), frames, deg)


def _near(port, jax_):
    return abs(port - jax_) <= 2 + 0.05 * jax_


def test_keypoints_agree_with_jax_as_positions(arena_frames):
    for deg in (0, 20):
        k, _ = _detect(arena_frames[deg][2], num_octaves=3, upright=True)
        kj, _ = j_detect(jnp.asarray(arena_frames[deg][2]), max_keypoints=1024, num_octaves=3,
                         upright=True)
        a = k.xy.numpy()[k.valid.numpy()]
        b = np.asarray(kj.xy)[np.asarray(kj.valid)]
        d = np.linalg.norm(a[:, None] - b[None], axis=-1)
        assert (d.min(1) < 1e-2).mean() >= 0.97
        assert (d.min(0) < 1e-2).mean() >= 0.97


def test_pyramid_yield_at_20deg(arena_frames):
    n, good = _port_verified(arena_frames, 20, num_octaves=3, upright=True)
    assert good >= 8, f"pyramid 20deg verified matches collapsed: {good} (of {n})"
    assert _near(good, _jax_verified(arena_frames, 20, num_octaves=3, upright=True)[1])


def test_pyramid_yield_at_30deg(arena_frames):
    n, good = _port_verified(arena_frames, 30, num_octaves=3, upright=True)
    assert good >= 5, f"pyramid 30deg verified matches collapsed: {good} (of {n})"
    assert _near(good, _jax_verified(arena_frames, 30, num_octaves=3, upright=True)[1])


def test_pyramid_beats_single_octave(arena_frames):
    _, good_pyr = _port_verified(arena_frames, 20, num_octaves=3, upright=True)
    _, good_old = _port_verified(arena_frames, 20, num_octaves=1, upright=True)
    assert good_pyr > good_old, (good_pyr, good_old)
    assert _near(good_old, _jax_verified(arena_frames, 20, num_octaves=1, upright=True)[1])


def test_twoview_support_at_wide_baseline(arena_frames):
    """The 20-degree pair gives the two-view RANSAC real support (>= 10
    epipolar inliers), and the true relative pose explains >= 8 of the
    accepted matches."""
    R0, t0, g0, _ = arena_frames[0]
    R1, t1, g1, _ = arena_frames[20]
    k0, dd0 = _detect(g0, num_octaves=3, upright=True)
    k1, dd1 = _detect(g1, num_octaves=3, upright=True)
    m = match_descriptors(dd0, dd1, k0.valid, k1.valid)
    K = torch.tensor([[CAM.fx, 0, CAM.cx], [0, CAM.fy, CAM.cy], [0, 0, 1]], dtype=torch.float32)
    uv1 = k0.xy  # one row per keypoint of frame 0
    uv2 = k1.xy[m.idx_b.long()]
    tv = estimate_relative_pose(uv1, uv2, m.valid, K, seeded_generator("cpu", 0),
                                inlier_px=2.0, num_hypotheses=2048)
    assert int(tv.n_inliers) >= 10, f"only {int(tv.n_inliers)} epipolar inliers"
    R_rel = R1 @ R0.T
    t_rel = t1 - R_rel @ t0
    tx = np.array([[0, -t_rel[2], t_rel[1]], [t_rel[2], 0, -t_rel[0]], [-t_rel[1], t_rel[0], 0]])
    E_gt = torch.as_tensor(tx @ R_rel, dtype=torch.float32)
    err = sampson_error(E_gt, normalize_points(uv1, K), normalize_points(uv2, K)).numpy()
    consistent = (err < (2.0 / CAM.fx) ** 2) & m.valid.numpy()
    assert consistent.sum() >= 8, consistent.sum()
