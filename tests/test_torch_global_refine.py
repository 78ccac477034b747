"""The port's global refinement against the JAX package: the class-aware
pose-graph refinement of `tpu3drec_torch/pipelines/kitti.py`
(`_refine_with_pose_graph`) and the global bundle adjustment of
`tpu3drec_torch/sfm/global_refine.py`, on the fixtures of
tests/test_global_refine.py.

The reference tests run on the port with their own bars (all of them,
including the two `slow` global-BA tests, which take a few seconds here).
Parity, same inputs through both packages:
  * `_refine_with_pose_graph` on the drifted circle with closures: camera
    centres within 1e-3 (a float32 switchable LM of 40 nodes; 1e-3 is
    ~3e-5 of the 40 m loop and ~1e-3 of the 1-4 m drift it removes);
  * `global_bundle_adjust` on `_synth_sequence` with a drifted start:
    poses within 1e-4 (measured 1e-6), and equal where the solve cannot
    reach a frame;
  * `_closure_pair_matches`: equal.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec.pipelines.kitti import _refine_with_pose_graph as j_refine
from tpu3drec.sfm import global_refine as jgr
from tpu3drec_torch.pipelines import kitti as tkitti
from tpu3drec_torch.sfm import global_refine as tgr

from test_global_refine import _circle_gt, _drifted_edges, _synth_sequence

torch.set_num_threads(2)


def _refine(Ts, edges):
    return tkitti._refine_with_pose_graph(Ts, edges, device="cpu")


# ------------------------------- tests/test_global_refine.py, on the port

class TestRobustPoseGraph:
    def test_closure_survives_gate_and_removes_drift(self):
        gt = _circle_gt(40)
        edges, Ts = _drifted_edges(gt)
        drift0 = np.linalg.norm(Ts[-1][:3, 3] - gt[-1][:3, 3])
        assert drift0 > 1.0
        T_cl = np.linalg.inv(gt[0]) @ gt[-1]
        out = _refine(list(Ts), edges + [(0, len(gt) - 1, T_cl, 1.0, "closure")])
        drift1 = np.linalg.norm(out[-1][:3, 3] - gt[-1][:3, 3])
        assert drift1 < 0.35 * drift0, (drift0, drift1)

    def test_without_closure_drift_remains(self):
        gt = _circle_gt(40)
        edges, Ts = _drifted_edges(gt)
        drift0 = np.linalg.norm(Ts[-1][:3, 3] - gt[-1][:3, 3])
        out = _refine(list(Ts), edges)
        drift1 = np.linalg.norm(out[-1][:3, 3] - gt[-1][:3, 3])
        assert drift1 > 0.7 * drift0

    def test_false_closure_downweighted(self):
        gt = _circle_gt(40)
        edges, Ts = _drifted_edges(gt)
        n = len(gt)
        good1 = (0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1], 1.0, "closure")
        good2 = (1, n - 2, np.linalg.inv(gt[1]) @ gt[n - 2], 1.0, "closure")
        bad = (5, 20, np.eye(4), 1.0, "closure")
        out = _refine(list(Ts), edges + [good1, good2, bad])
        err = np.linalg.norm(out[-1][:3, 3] - gt[-1][:3, 3])
        gap = np.linalg.norm(out[5][:3, 3] - out[20][:3, 3])
        gt_gap = np.linalg.norm(gt[5][:3, 3] - gt[20][:3, 3])
        assert gap > 0.5 * gt_gap, f"false closure collapsed the loop: {gap}"
        drift0 = np.linalg.norm(Ts[-1][:3, 3] - gt[-1][:3, 3])
        assert err < 0.5 * drift0

    def test_nonfinite_pose_excluded(self):
        gt = _circle_gt(10)
        edges, Ts = _drifted_edges(gt)
        Ts[4] = np.full((4, 4), np.nan)
        out = _refine(list(Ts), edges)
        finite = [T for T in out if T is not None and np.isfinite(T).all()]
        assert len(finite) == 9


class TestPoseGraphConnectivity:
    def test_chain_with_one_corrupt_edge_stays_finite(self):
        gt = _circle_gt(30)
        edges, Ts = _drifted_edges(gt, yaw_bias=0.001)
        f1, f2, T_rel, w = edges[14]
        bad = T_rel.copy()
        bad[:3, 3] += np.array([30.0, 0.0, 0.0])
        edges[14] = (f1, f2, bad, w)
        out = _refine(list(Ts), edges)
        pos = np.stack([T[:3, 3] for T in out])
        in_pos = np.stack([T[:3, 3] for T in Ts])
        span = np.ptp(in_pos, axis=0).max()
        assert np.linalg.norm(pos - in_pos, axis=1).max() < 2.0 * span

    def test_redundant_corrupt_edge_still_gated(self):
        gt = _circle_gt(30)
        edges, Ts = _drifted_edges(gt, yaw_bias=0.001)
        for i in range(len(gt) - 2):
            edges.append((i, i + 2, np.linalg.inv(gt[i]) @ gt[i + 2], 1.0))
        f1, f2, T_rel, w = edges[14]
        bad = T_rel.copy()
        bad[:3, 3] += np.array([30.0, 0.0, 0.0])
        edges[14] = (f1, f2, bad, w)
        out = _refine(list(Ts), edges)
        pos = np.stack([T[:3, 3] for T in out])
        err = np.linalg.norm(pos - np.stack([T[:3, 3] for T in gt]), axis=1).max()
        assert err < 3.0, err


def _drifted_start(gt_T):
    """tests/test_global_refine.py's smooth cumulative drift (frame 0 exact)."""
    rng = np.random.default_rng(1)
    Ts, D = [], np.eye(4)
    for f, T in enumerate(gt_T):
        if f > 0:
            step = np.eye(4)
            step[:3, :3] = ScipyR.from_rotvec(0.004 * rng.standard_normal(3)).as_matrix()
            step[:3, 3] = 0.04 * rng.standard_normal(3)
            D = D @ step
        Ts.append(D @ T.copy())
    return Ts


def _mean_err(out, gt_T):
    return np.mean([np.linalg.norm(out[f][:3, 3] - gt_T[f][:3, 3]) for f in range(len(gt_T))])


class TestGlobalBundleAdjust:
    def test_reduces_pose_error(self):
        gt_T, kps, descs, depth_maps, K = _synth_sequence()
        Ts = _drifted_start(gt_T)
        out = tgr.global_bundle_adjust(Ts, (kps, descs), K, depth_maps=depth_maps, device="cpu")
        assert _mean_err(out, gt_T) < 0.35 * _mean_err(Ts, gt_T)

    def test_none_frames_passthrough(self):
        gt_T, kps, descs, depth_maps, K = _synth_sequence()
        Ts = list(gt_T)
        Ts[5] = None
        Ts[6] = np.full((4, 4), np.nan)
        out = tgr.global_bundle_adjust(Ts, (kps, descs), K, depth_maps=depth_maps, device="cpu")
        assert out[5] is None
        assert not np.isfinite(out[6]).all()
        for f in (0, 1, 2, 3, 4, 7, 8):
            assert np.isfinite(out[f]).all()

    def test_closure_pixel_to_index_recovery(self):
        rng = np.random.default_rng(2)
        xy = rng.uniform(0, 300, (4, 32, 2)).astype(np.float32)
        ia = np.array([3, 7, 11, 20, 25, 1, 2, 9])
        ib = np.array([5, 8, 12, 21, 26, 0, 4, 10])

        class C:
            i, j = 1, 3
            uv_i = xy[1, ia]
            uv_j = xy[3, ib]

        out = tgr._closure_pair_matches([C()], xy)
        got_a, got_b = out[(1, 3)]
        np.testing.assert_array_equal(np.sort(got_a), np.sort(ia))
        np.testing.assert_array_equal(np.sort(got_b), np.sort(ib))
        want = jgr._closure_pair_matches([C()], xy)
        for a, b in zip(out[(1, 3)], want[(1, 3)]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- parity with JAX

@pytest.mark.parametrize("with_false", [False, True])
def test_refine_with_pose_graph_matches_jax(with_false):
    gt = _circle_gt(40)
    edges, Ts = _drifted_edges(gt)
    n = len(gt)
    edges = edges + [(0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1], 1.0, "closure"),
                     (1, n - 2, np.linalg.inv(gt[1]) @ gt[n - 2], 1.0, "closure")]
    if with_false:
        edges.append((5, 20, np.eye(4), 1.0, "closure"))
    want = j_refine(list(Ts), edges)
    got = _refine(list(Ts), edges)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=1e-3)


@pytest.mark.parametrize("drop", [False, True])
def test_global_bundle_adjust_matches_jax(drop):
    gt_T, kps, descs, depth_maps, K = _synth_sequence()
    Ts = _drifted_start(gt_T)
    if drop:
        Ts[5] = None
    want = jgr.global_bundle_adjust(Ts, (kps, descs), K, depth_maps=depth_maps)
    got = tgr.global_bundle_adjust(Ts, (kps, descs), K, depth_maps=depth_maps, device="cpu")
    for f, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"frame {f}")


def test_match_sequential_pads_its_chunk():
    """Short chunks are padded with their first pair: 5 pairs of 12 frames
    go through one matcher call of MATCH_CHUNK pairs, and the padding
    changes no result."""
    _, kps, descs, _, _ = _synth_sequence()
    from tpu3drec_torch.ops import matcher

    calls = []
    orig = matcher.topk2_scores_batched

    def spy(a, b, v):
        calls.append(a.shape)
        return orig(a, b, v)

    matcher.topk2_scores_batched = spy
    try:
        got = tgr._match_sequential(descs, kps.valid, [0, 1, 2, 3, 4, 5], (1,), 0.85,
                                    device="cpu")
    finally:
        matcher.topk2_scores_batched = orig
    assert calls == [(tgr.MATCH_CHUNK, descs.shape[1], descs.shape[2])] * 2
    want = jgr._match_sequential(descs, kps.valid, [0, 1, 2, 3, 4, 5], (1,), 0.85)
    assert sorted(got) == sorted(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)


def test_global_bundle_adjust_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gt_T, kps, descs, depth_maps, K = _synth_sequence()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgr.global_bundle_adjust(list(gt_T), (kps, descs), K, depth_maps=depth_maps)
