"""Parity of the port's flight-autonomy stack (`tpu3drec_torch/autonomy/`) with
the JAX package's, on tests/test_autonomy.py's cases.

Tolerances:
  * integer outputs (component labels, blob areas, ring centres and radii,
    template ids and positions, marker ids, Hamming distances, found flags)
    are equal;
  * float outputs within 1e-5 relative (centroids, circularity) and 1e-4
    relative for the ring and template scores, which sum large convolutions
    in another order;
  * missions: the phase sequence is identical tick for tick, and the
    trajectories too (the port rounds each tick as XLA's fused scan does).
The reference's own assertions are kept beside each comparison. Where the
reference draws noise with `jax.random`, both sides take the same numpy
noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.autonomy import aruco as ja
from tpu3drec.autonomy import detect as jd
from tpu3drec.autonomy import mission as jm
from tpu3drec_torch.autonomy import aruco as ta
from tpu3drec_torch.autonomy import detect as td
from tpu3drec_torch.autonomy import mission as tm
from tpu3drec_torch.models.convert import tuple_from_numpy

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(1.0, float(np.abs(b).max())))


def _same_blob(got, want, rtol=1e-5):
    np.testing.assert_array_equal(got.area.numpy(), np.asarray(want.area))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    for name in ("cx", "cy", "circularity"):
        if hasattr(want, name):
            _close(getattr(got, name).numpy(), getattr(want, name), rtol)


# ---- components and blobs ---------------------------------------------------


def test_label_components_two_blobs():
    mask = np.zeros((32, 32), bool)
    mask[2:6, 2:6] = True
    mask[20:30, 18:30] = True
    labels = td.label_components(mask, device="cpu").numpy()
    np.testing.assert_array_equal(labels, np.asarray(jd.label_components(jnp.asarray(mask))))
    assert labels.dtype == np.int32 and len(np.unique(labels[mask])) == 2
    assert np.all(labels[~mask] == 32 * 32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_components_random_masks(seed):
    """Random masks of many components, with spirals and diagonal-only links
    (8-neighbourhood), batched: labels equal as integers."""
    rng = np.random.default_rng(seed)
    mask = rng.random((3, 40, 56)) < [[[0.35]], [[0.5]], [[0.6]]]
    mask[0, 5:35:2, 5] = True
    labels = td.label_components(mask, device="cpu").numpy()
    np.testing.assert_array_equal(labels, np.asarray(jd.label_components(jnp.asarray(mask))))


def test_largest_blob_centroid_and_shape():
    img = np.zeros((64, 96), np.float32)
    img[10:20, 5:15] = 1.0
    img[30:60, 40:80] = 1.0
    blob = td.largest_blob(img[None], thresh=0.5, device="cpu")
    _same_blob(blob, jd.largest_blob(jnp.asarray(img)[None], thresh=0.5))
    assert bool(blob.found[0])
    assert abs(float(blob.cx[0]) - 59.5) < 0.6 and abs(float(blob.cy[0]) - 44.5) < 0.6
    assert 0.55 < float(blob.circularity[0]) < 1.0
    one = td.largest_blob_from_mask(img > 0.5, device="cpu")
    _same_blob(one, jd.largest_blob_from_mask(jnp.asarray(img > 0.5)))


def test_largest_blob_batched_and_inverted():
    img = np.ones((2, 48, 48), np.float32)
    img[0, 10:20, 10:20] = 0.0
    img[1, 30:40, 5:25] = 0.0
    blob = td.largest_blob(img, thresh=0.5, invert=True, device="cpu")
    _same_blob(blob, jd.largest_blob(jnp.asarray(img), thresh=0.5, invert=True))
    assert bool(blob.found[0]) and bool(blob.found[1])
    assert abs(float(blob.cx[0]) - 14.5) < 0.6 and abs(float(blob.cy[1]) - 34.5) < 0.6


@pytest.mark.parametrize("seed", [0, 1])
def test_largest_blob_ties_and_small(seed):
    """Two equal-area blobs (the first label wins) and a blob below
    ``min_area`` (not found)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((3, 40, 40), np.float32)
    img[0, 5:10, 5:10] = 1.0
    img[0, 20:25, 30:35] = 1.0
    img[1, 2:4, 2:5] = 1.0
    img[2] = rng.random((40, 40)) > 0.7
    blob = td.largest_blob(img, thresh=0.5, min_area=16, device="cpu")
    _same_blob(blob, jd.largest_blob(jnp.asarray(img), thresh=0.5, min_area=16))
    assert not bool(blob.found[1])


# ---- rings and templates ----------------------------------------------------


def _same_ring(got, want):
    for name in ("cx", "cy", "radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    _close(got.score.numpy(), want.score, 1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_ring_detection_center_and_radius(rng, stride):
    H, W = 120, 160
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    d = np.sqrt((ys - 70) ** 2 + (xs - 100) ** 2)
    img = 0.05 * rng.uniform(size=(H, W)).astype(np.float32)
    img[np.abs(d - 26) < 2.0] = 1.0
    ring = td.detect_rings(img[None], radii=(12, 20, 26, 32), stride=stride, device="cpu")
    _same_ring(ring, jd.detect_rings(jnp.asarray(img)[None], radii=(12, 20, 26, 32),
                                     stride=stride))
    assert abs(float(ring.cx[0]) - 100) <= 2 and abs(float(ring.cy[0]) - 70) <= 2
    assert float(ring.radius[0]) == 26.0


def test_ring_scores_rank_noise_below_ring(rng):
    H, W = 96, 96
    noise = 0.05 * rng.uniform(size=(H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    d = np.sqrt((ys - 48) ** 2 + (xs - 48) ** 2)
    ringed = noise.copy()
    ringed[np.abs(d - 20) < 1.5] = 1.0
    batch = np.stack([ringed, noise])
    r = td.detect_rings(batch, radii=(16, 20, 24), stride=1, device="cpu")
    jr = jd.detect_rings(jnp.asarray(batch), radii=(16, 20, 24), stride=1)
    np.testing.assert_array_equal(r.radius.numpy()[:1], np.asarray(jr.radius)[:1])
    _close(r.score.numpy(), jr.score, 1e-4)
    assert float(r.score[0]) > 2.5 * float(r.score[1]) and float(r.score[0]) > 4.0
    assert float(r.score[1]) < 2.5


def test_ring_default_bank_at_odd_size(rng):
    """The default eight radii (121x121 kernels) at stride 2 on an odd frame
    size: XLA's SAME padding puts the odd pixel after."""
    H, W = 151, 203
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    d = np.sqrt((ys - 77) ** 2 + (xs - 91) ** 2)
    img = 0.05 * rng.uniform(size=(H, W)).astype(np.float32)
    img[np.abs(d - 40) < 2.0] = 1.0
    _same_ring(td.detect_rings(img[None], device="cpu"), jd.detect_rings(jnp.asarray(img)[None]))


def test_match_templates_finds_location_and_id(rng):
    temps = rng.uniform(size=(9, 12, 12)).astype(np.float32)
    img = 0.5 * np.ones((2, 64, 64), np.float32)
    img[0, 20:32, 30:42] = temps[3]
    img[1, 5:17, 8:20] = temps[7]
    m = td.match_templates(img, temps, device="cpu")
    jmt = jd.match_templates(jnp.asarray(img), jnp.asarray(temps))
    for name in ("index", "cx", "cy"):
        np.testing.assert_array_equal(getattr(m, name).numpy(), np.asarray(getattr(jmt, name)))
    _close(m.score.numpy(), jmt.score, 1e-4)
    assert int(m.index[0]) == 3 and int(m.index[1]) == 7
    assert abs(float(m.cx[0]) - 35.5) < 1.0 and abs(float(m.cy[1]) - 10.5) < 1.0
    assert float(m.score[0]) > 0.9


def test_tree_like_green_blob():
    img = np.full((1, 48, 64, 3), 0.4, np.float32)
    img[0, 10:30, 20:40, 1] = 0.9
    blob = td.detect_color_blob(img, channel=1, device="cpu")
    _same_blob(blob, jd.detect_color_blob(jnp.asarray(img), channel=1))
    assert bool(blob.found[0])
    assert abs(float(blob.cx[0]) - 29.5) < 1.0 and abs(float(blob.cy[0]) - 19.5) < 1.0


# ---- ArUco --------------------------------------------------------------------


def test_dictionary_and_rendering():
    d = ta.aruco_original_dictionary(1024)
    np.testing.assert_array_equal(d, ja.aruco_original_dictionary(1024))
    np.testing.assert_array_equal(
        d[100], [[1, 0, 0, 0, 0], [1, 0, 1, 1, 1], [0, 1, 0, 0, 1],
                 [1, 0, 1, 1, 1], [1, 0, 0, 0, 0]])
    for mid, cell, border in ((0, 8, 0), (451, 10, 24), (1023, 5, 7)):
        np.testing.assert_array_equal(ta.render_marker(mid, cell, border),
                                      ja.render_marker(mid, cell, border))


def _same_detection(got, want):
    for name in ("marker_id", "hamming", "found"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert got.marker_id.dtype == torch.int32 and got.hamming.dtype == torch.int32


def test_decode_own_rendering():
    imgs = np.stack([ta.render_marker(mid, cell_px=10, border_px=24) for mid in (0, 17, 451, 1023)])
    det = ta.decode_marker(imgs, device="cpu")
    _same_detection(det, ja.decode_marker(jnp.asarray(imgs)))
    np.testing.assert_array_equal(det.marker_id.numpy(), [0, 17, 451, 1023])
    assert det.found.all() and (det.hamming == 0).all()


def test_decode_rotated():
    img = ta.render_marker(321, cell_px=10, border_px=24)
    imgs = np.stack([np.rot90(img, k) for k in range(4)])
    det = ta.decode_marker(imgs, device="cpu")
    _same_detection(det, ja.decode_marker(jnp.asarray(imgs)))
    np.testing.assert_array_equal(det.marker_id.numpy(), [321] * 4)
    np.testing.assert_array_equal(det.corners.numpy()[1:], np.asarray(
        ja.decode_marker(jnp.asarray(imgs[1:])).corners))


def test_decode_noisy_and_flipped_bits(rng):
    """Sensor noise on a marker, and one flipped code cell: with
    ``max_hamming`` 0 the flipped marker is refused, with 1 it is read."""
    img = ta.render_marker(700, cell_px=9, border_px=20)
    noisy = np.clip(img + 0.1 * rng.standard_normal(img.shape), 0, 1).astype(np.float32)
    flipped = img.copy()
    flipped[20 + 9 * 2:20 + 9 * 3, 20 + 9 * 3:20 + 9 * 4] = 1.0 - flipped[20 + 18, 20 + 27]
    imgs = np.stack([noisy, flipped])
    for max_h in (0, 1):
        det = ta.decode_marker(imgs, max_hamming=max_h, device="cpu")
        _same_detection(det, ja.decode_marker(jnp.asarray(imgs), max_hamming=max_h))
    assert int(det.marker_id[0]) == 700


def test_task_list():
    det = ta.MarkerDetection(
        marker_id=torch.tensor([5, -1, 99], dtype=torch.int32),
        hamming=torch.zeros(3, dtype=torch.int32), corners=torch.zeros((3, 4, 2)),
        found=torch.tensor([True, False, True]))
    got = ta.match_task_list(det, torch.tensor([99, 7, 5]))
    jdet = ja.MarkerDetection(marker_id=jnp.asarray([5, -1, 99]), hamming=jnp.zeros(3, jnp.int32),
                              corners=jnp.zeros((3, 4, 2)),
                              found=jnp.asarray([True, False, True]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ja.match_task_list(jdet, jnp.asarray([99, 7, 5]))))
    np.testing.assert_array_equal(got.numpy(), [True, False, True])


def test_reject_non_marker(rng):
    img = rng.uniform(size=(60, 60)).astype(np.float32)
    det = ta.decode_marker(img[None], device="cpu")
    _same_detection(det, ja.decode_marker(jnp.asarray(img)[None]))
    assert not bool(det.found[0])


# ---- missions -----------------------------------------------------------------


def _cfgs(**over):
    kw = dict(waypoints=np.array([[2.0, 0.0, 4.0], [6.0, 0.0, 4.0]], np.float32),
              gate_waypoint=np.array([False, True]), task_ids=np.array([3, 8], np.int32),
              image_center=np.array([160.0, 120.0], np.float32), cruise_alt=4.0,
              scan_ticks=10, pass_ticks=15, servo_gain=(0.02, 0.0, 0.005))
    kw.update(over)
    jcfg = jm.MissionConfig(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                               for k, v in kw.items()})
    return tuple_from_numpy(tm.MissionConfig, jcfg, "cpu"), jcfg


def _worlds(center, gate, pad):
    """tests/test_autonomy.py's pinhole world in both packages: the gate in
    the front camera, the pad in the below camera."""
    f = 200.0

    def jobserve(pos):
        rel = jnp.asarray(gate) - pos
        depth = jnp.maximum(rel[0], 0.3)
        visible = (rel[0] > 0.5) & (jnp.abs(rel[1]) < 4.0) & (jnp.abs(rel[2]) < 4.0)
        relp = jnp.asarray(pad) - pos
        alt = jnp.maximum(pos[2] - pad[2], 0.3)
        return jm.Observation(
            ring_px=jnp.stack([center[0] - f * rel[1] / depth, center[1] - f * rel[2] / depth]),
            ring_score=jnp.where(visible, 0.9, 0.01),
            blob_px=jnp.stack([center[0] - f * relp[1] / alt, center[1] - f * relp[0] / alt]),
            blob_found=(jnp.abs(relp[0]) < 2.0) & (jnp.abs(relp[1]) < 2.0),
            altitude=pos[2], position=pos, marker_ids=jnp.full((2,), -1, jnp.int32))

    def observe(pos):
        rel = torch.as_tensor(gate) - pos
        depth = torch.clamp(rel[0], min=0.3)
        visible = (rel[0] > 0.5) & (torch.abs(rel[1]) < 4.0) & (torch.abs(rel[2]) < 4.0)
        relp = torch.as_tensor(pad) - pos
        alt = torch.clamp(pos[2] - float(pad[2]), min=0.3)
        c0 = torch.as_tensor(center)
        return tm.Observation(
            ring_px=torch.stack([c0[0] - f * rel[1] / depth, c0[1] - f * rel[2] / depth]),
            ring_score=torch.where(visible, torch.tensor(0.9), torch.tensor(0.01)),
            blob_px=torch.stack([c0[0] - f * relp[1] / alt, c0[1] - f * relp[0] / alt]),
            blob_found=(torch.abs(relp[0]) < 2.0) & (torch.abs(relp[1]) < 2.0),
            altitude=pos[2], position=pos, marker_ids=torch.full((2,), -1, dtype=torch.int32))

    return observe, jobserve


def _same_rollout(cfg, jcfg, observe, jobserve, n_steps):
    state, traj, phases = tm.mission_rollout(cfg, observe, n_steps=n_steps, start=np.zeros(3),
                                             dt=0.1)
    jstate, jtraj, jphases = jm.mission_rollout(jcfg, jobserve, n_steps=n_steps,
                                                start=jnp.zeros(3), dt=0.1)
    np.testing.assert_array_equal(phases.numpy(), np.asarray(jphases))
    np.testing.assert_array_equal(traj.numpy(), np.asarray(jtraj))
    for name in ("phase", "wp_index", "ticks_in_phase", "align_streak", "scan_leg", "found_mask"):
        np.testing.assert_array_equal(getattr(state, name).numpy(), np.asarray(getattr(jstate, name)))
    return state, traj.numpy(), phases.numpy()


@pytest.mark.parametrize("gate,pad", [((9.0, 0.6, 4.4), (13.0, 0.5, 0.0)),
                                      ((8.5, -0.9, 3.6), (11.0, -1.2, 0.0))])
def test_full_mission_reaches_landing(gate, pad):
    """The reference's mission (and a second world): identical phases tick
    for tick, landing on the pad after passing the gate near its centre."""
    cfg, jcfg = _cfgs()
    gate, pad = np.array(gate, np.float32), np.array(pad, np.float32)
    observe, jobserve = _worlds(np.array([160.0, 120.0], np.float32), gate, pad)
    state, traj, phases = _same_rollout(cfg, jcfg, observe, jobserve, 1200)
    for ph in (tm.Phase.TAKEOFF, tm.Phase.NAV_WAYPOINT, tm.Phase.SEARCH_GATE,
               tm.Phase.ALIGN_GATE, tm.Phase.PASS_GATE, tm.Phase.ARUCO_SCAN,
               tm.Phase.PARK_SEARCH, tm.Phase.DESCEND, tm.Phase.LANDED):
        assert (phases == int(ph)).any(), ph.name
    assert int(state.phase) == int(tm.Phase.LANDED)
    final = traj[-1]
    assert abs(final[0] - pad[0]) < 1.0 and abs(final[1] - pad[1]) < 1.0 and final[2] <= 0.4
    through = traj[np.abs(traj[:, 0] - gate[0]) < 0.3]
    assert len(through) > 0
    assert np.min(np.abs(through[:, 1] - gate[1])) < 0.5
    assert np.min(np.abs(through[:, 2] - gate[2])) < 0.5


def _obs(marker_ids, **kw):
    base = dict(ring_px=np.zeros(2, np.float32), ring_score=np.float32(0),
                blob_px=np.zeros(2, np.float32), blob_found=np.bool_(False),
                altitude=np.float32(0), position=np.zeros(3, np.float32),
                marker_ids=np.asarray(marker_ids, np.int32))
    base.update(kw)
    return (tuple_from_numpy(tm.Observation, tm.Observation(**base), "cpu"),
            jm.Observation(**{k: jnp.asarray(v) for k, v in base.items()}))


def test_mission_collects_task_markers():
    cfg, jcfg = _cfgs()
    obs, jobs = _obs([8, -1])
    state, _ = tm.mission_step(cfg, tm.mission_init(cfg), obs)
    jstate, _ = jm.mission_step(jcfg, jm.mission_init(jcfg), jobs)
    np.testing.assert_array_equal(state.found_mask.numpy(), np.asarray(jstate.found_mask))
    np.testing.assert_array_equal(state.found_mask.numpy(), [False, True])


@pytest.mark.parametrize("phase", list(range(10)))
def test_mission_step_each_phase(phase):
    """One tick from each phase on the same state and observation: the same
    next state and command, with the reference's types."""
    rng = np.random.default_rng(phase)
    cfg, jcfg = _cfgs()
    obs, jobs = _obs([3, -1], ring_px=rng.uniform(100, 200, 2).astype(np.float32),
                     ring_score=np.float32(0.5), blob_px=rng.uniform(100, 200, 2).astype(np.float32),
                     blob_found=np.bool_(phase % 2), altitude=np.float32(2.0 + phase * 0.3),
                     position=np.array([1.0, 0.2, 2.0 + phase * 0.3], np.float32))
    state = tm.mission_init(cfg)._replace(phase=torch.tensor(phase, dtype=torch.int32),
                                          ticks_in_phase=torch.tensor(15, dtype=torch.int32))
    jstate = jm.mission_init(jcfg)._replace(phase=jnp.int32(phase), ticks_in_phase=jnp.int32(15))
    s2, cmd = tm.mission_step(cfg, state, obs)
    js2, jcmd = jm.mission_step(jcfg, jstate, jobs)
    assert s2.phase.dtype == torch.int32 and cmd.velocity.shape == (3,)
    _close(cmd.velocity.numpy(), jcmd.velocity, 1e-6)
    for name in ("phase", "wp_index", "ticks_in_phase", "align_streak", "scan_leg", "found_mask"):
        np.testing.assert_array_equal(getattr(s2, name).numpy(), np.asarray(getattr(js2, name)))
    for got, want in zip((*s2.pid_y, *s2.pid_z), (*js2.pid_y, *js2.pid_z)):
        _close(got.numpy(), want, 1e-6)


def test_mission_sim_cli(capsys):
    """`mission-sim` ends LANDED (exit 0) and flies the reference's world:
    the trajectory equals the JAX package's rollout of the same world."""
    from tpu3drec_torch.pipelines.cli import main, mission_sim

    assert main(["--device", "cpu", "mission-sim"]) == 0
    out = capsys.readouterr().out
    assert "final: LANDED" in out and "ticks/s" in out
    _, traj, phases = mission_sim(device="cpu")
    cfg, jcfg = _cfgs()
    _, jobserve = _worlds(np.array([160.0, 120.0], np.float32), np.array([9.0, 0.6, 4.4], np.float32),
                          np.array([13.0, 0.5, 0.0], np.float32))
    _, jtraj, jphases = jm.mission_rollout(jcfg, jobserve, n_steps=1200, start=jnp.zeros(3), dt=0.1)
    np.testing.assert_array_equal(phases.numpy(), np.asarray(jphases))
    np.testing.assert_array_equal(traj.numpy(), np.asarray(jtraj))
    assert main(["--device", "cpu", "mission-sim", "--steps", "50"]) == 1  # not landed yet


@pytest.mark.slow
def test_mission_flies_through_rendered_gate():
    """tests/test_autonomy.py's perception-in-the-loop mission: each tick
    renders the front camera, runs `detect_rings` on it and feeds the
    controller, with the same numpy noise on both sides: identical phases
    tick for tick, and the gate crossed near its centre."""
    H, W, f = 96, 128, 110.0
    cfg, jcfg = _cfgs(waypoints=np.array([[4.0, 0.0, 4.0]], np.float32),
                      gate_waypoint=np.array([True]), task_ids=np.array([1], np.int32),
                      image_center=np.array([W / 2, H / 2], np.float32), pass_ticks=25,
                      ring_score_min=2.5, servo_gain=(0.03, 0.0, 0.008))
    gate = np.array([8.0, 0.8, 4.5], np.float32)
    radii = (6, 8, 10, 13, 16, 20)
    noise = (0.05 * np.random.default_rng(0).uniform(size=(H, W))).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]

    def render(lib, pos):
        rel = lib.asarray(gate) - pos if lib is jnp else torch.as_tensor(gate) - pos
        if lib is jnp:
            depth = jnp.maximum(rel[0], 0.5)
            r_px = jnp.clip(f * 0.8 / depth, 3.0, 24.0)
            cx, cy = W / 2 - f * rel[1] / depth, H / 2 - f * rel[2] / depth
            d = jnp.sqrt((ys - cy) ** 2 + (xs - cx) ** 2)
            ring = jnp.exp(-((d - r_px) ** 2) / (2.0 * 1.2 ** 2))
            return jnp.clip(noise + (rel[0] > 0.5).astype(jnp.float32) * ring, 0.0, 1.0)
        depth = torch.clamp(rel[0], min=0.5)
        r_px = torch.clamp(f * 0.8 / depth, 3.0, 24.0)
        cx, cy = W / 2 - f * rel[1] / depth, H / 2 - f * rel[2] / depth
        d = torch.sqrt((torch.as_tensor(ys) - cy) ** 2 + (torch.as_tensor(xs) - cx) ** 2)
        ring = torch.exp(-((d - r_px) ** 2) / (2.0 * 1.2 ** 2))
        return torch.clamp(torch.as_tensor(noise) + (rel[0] > 0.5).float() * ring, 0.0, 1.0)

    def jobserve(pos):
        ring = jd.detect_rings(render(jnp, pos)[None], radii=radii, stride=1)
        return jm.Observation(ring_px=jnp.stack([ring.cx[0], ring.cy[0]]),
                              ring_score=ring.score[0], blob_px=jnp.zeros(2),
                              blob_found=jnp.bool_(False), altitude=pos[2], position=pos,
                              marker_ids=jnp.full((1,), -1, jnp.int32))

    def observe(pos):
        ring = td.detect_rings(render(torch, pos)[None], radii=radii, stride=1, device="cpu")
        return tm.Observation(ring_px=torch.stack([ring.cx[0], ring.cy[0]]),
                              ring_score=ring.score[0], blob_px=torch.zeros(2),
                              blob_found=torch.tensor(False), altitude=pos[2], position=pos,
                              marker_ids=torch.full((1,), -1, dtype=torch.int32))

    state, traj, phases = tm.mission_rollout(cfg, observe, n_steps=420, start=np.zeros(3), dt=0.1)
    jstate, jtraj, jphases = jm.mission_rollout(jcfg, jobserve, n_steps=420, start=jnp.zeros(3),
                                                dt=0.1)
    phases, traj = phases.numpy(), traj.numpy()
    np.testing.assert_array_equal(phases, np.asarray(jphases))
    np.testing.assert_allclose(traj, np.asarray(jtraj), atol=1e-3)
    assert (phases == int(tm.Phase.ALIGN_GATE)).any() and (phases == int(tm.Phase.PASS_GATE)).any()
    through = traj[np.abs(traj[:, 0] - 8.0) < 0.25]
    assert len(through) > 0
    assert np.min(np.abs(through[:, 1] - 0.8)) < 0.45
    assert np.min(np.abs(through[:, 2] - 4.5)) < 0.45
