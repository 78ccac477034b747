"""Parity of the port's loop-closure detection
(`tpu3drec_torch/sfm/loopclosure.py`) with the JAX package's, on the
`loop_capture` scene of tests/test_loopclosure.py (a camera circling a
blob scene for 1.06 turns: frames 32 and 33 revisit frames 0 and 1).

Both packages get the same inputs: the JAX package's detections (256
keypoints a frame), as numpy. Tolerances:
  * global descriptors and VLAD vectors: within 1e-5 absolute; k-means
    assignments equal; codebook within 1e-5;
  * `propose_candidates`: the same pair list, in the same order except
    among pairs whose similarities lie within 1e-6 of each other, which
    rounding may order either way (mean pooling and VLAD);
  * `detect_loop_closures` with the RANSAC samples the JAX package draws
    (`jax.random.split(PRNGKey(seed), P)`, one key a candidate) injected:
    the same verified (i, j) pairs, in the same order up to such ties,
    `n_inliers` within 1
    (a match whose Sampson error sits at the inlier gate may round to
    either side), rotations within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.data.capture_sim import SimScene, render_frame
from tpu3drec.sfm import loopclosure as jlc
from tpu3drec.sfm.features import detect_and_describe
from tpu3drec.sfm.matching import match_pairs as jmatch_pairs
from tpu3drec.utils.config import CameraConfig
from tpu3drec_torch.sfm import loopclosure as tlc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def loop_features():
    """tests/test_loopclosure.py's loop_capture, detected by the JAX package."""
    rng = np.random.default_rng(5)
    scene = SimScene.clustered(rng, n_landmarks=250, sats=4, extent=((-8, -5, -8), (8, 5, 8)))
    cam = CameraConfig(fx=220.0, fy=220.0, cx=128.0, cy=96.0, width=256, height=192)
    r, F = 25.0, 34
    poses = []
    for k in range(F):
        th = 2 * np.pi * k / 32.0
        C = np.array([r * np.sin(th), 0.0, -r * np.cos(th)], np.float32)
        d = -C / np.linalg.norm(C)
        yaw = np.arctan2(d[0], d[2])
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        Rcw = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], np.float32)
        R = Rcw.T
        poses.append((R, (-R @ C).astype(np.float32)))
    frames = [render_frame(scene, R, t, cam, max_depth=80.0) for R, t in poses]
    images = np.stack([f[0].mean(-1).astype(np.float32) / 255.0 for f in frames])
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    det = jax.jit(jax.vmap(lambda im: detect_and_describe(im, max_keypoints=256, upright=True)))
    kps, descs = det(jnp.asarray(images))
    return np.asarray(descs), np.asarray(kps.valid), np.asarray(kps.xy), K


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_global_descriptors_match_jax(loop_features):
    descs, valid, _, _ = loop_features
    gj = np.asarray(jlc.global_descriptors(jnp.asarray(descs), jnp.asarray(valid)))
    gt = tlc.global_descriptors(_t(descs), _t(valid)).numpy()
    np.testing.assert_allclose(gt, gj, atol=1e-5)


def test_codebook_and_vlad_match_jax(loop_features):
    descs, valid, _, _ = loop_features
    cj = jlc.fit_codebook(jnp.asarray(descs), jnp.asarray(valid), n_words=32)
    ct = tlc.fit_codebook(_t(descs), _t(valid), n_words=32)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    # assignments of every descriptor to the JAX codebook, in full float32
    X = descs.reshape(-1, descs.shape[-1])
    aj = np.asarray(jnp.argmax(jax.lax.dot_general(
        jnp.asarray(X), cj, (((1,), (1,)), ((), ())), precision=jax.lax.Precision.HIGHEST), 1))
    at = torch.argmax(_t(X) @ _t(np.asarray(cj)).T, 1).numpy()
    np.testing.assert_array_equal(at, aj)
    vj = np.asarray(jlc.vlad_descriptors(jnp.asarray(descs), jnp.asarray(valid), cj))
    vt = tlc.vlad_descriptors(_t(descs), _t(valid), _t(np.asarray(cj))).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-5)


def _similarity(descs, valid, method):
    """The JAX package's (F, F) global-descriptor similarity."""
    d, v = jnp.asarray(descs), jnp.asarray(valid)
    if method == "vlad":
        g = jlc.vlad_descriptors(d, v, jlc.fit_codebook(d, v))
    else:
        g = jlc.global_descriptors(d, v)
    return np.asarray(jnp.einsum("id,jd->ij", g, g, precision=jax.lax.Precision.HIGHEST))


def _in_tie_groups(pairs, S):
    """Pairs ranked by similarity, as a list of sets: consecutive pairs
    whose similarities lie within 1e-6 (the descriptors' rounding; the
    exact revisits (0, 32) and (1, 33) both sit at 1.0) form one group,
    whose order either package may take."""
    groups = []
    for i, j in (tuple(int(x) for x in p) for p in pairs):
        if groups and abs(S[i, j] - groups[-1][1]) <= 1e-6:
            groups[-1][0].add((i, j))
        else:
            groups.append(({(i, j)}, S[i, j]))
    return [g for g, _ in groups]


@pytest.mark.parametrize("method", ["mean", "vlad"])
def test_propose_candidates_match_jax(loop_features, method):
    descs, valid, _, _ = loop_features
    kw = dict(min_gap=20, sim_threshold=0.8, method=method)
    cj = jlc.propose_candidates(jnp.asarray(descs), jnp.asarray(valid), **kw)
    ct = tlc.propose_candidates(_t(descs), _t(valid), **kw)
    assert len(cj) > 0 and ct.shape == cj.shape
    S = _similarity(descs, valid, method)
    assert _in_tie_groups(ct, S) == _in_tie_groups(cj, S)


def _jax_samples(descs, valid, cands, seed):
    """The minimal samples the JAX package draws for each candidate: its
    matches packed first, then jax.random.categorical over the valid rows
    with the candidate's split key."""
    m = jmatch_pairs(jnp.asarray(descs), jnp.asarray(valid), jnp.asarray(cands), ratio=0.85)
    m_valid = np.asarray(m.valid)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(cands))
    out = []
    for p in range(len(cands)):
        vm = np.arange(descs.shape[1]) < m_valid[p].sum()
        logits = jnp.where(jnp.asarray(vm), 0.0, -jnp.inf)
        out.append(np.asarray(jax.random.categorical(keys[p], logits, shape=(2048, 8))))
    return np.stack(out)


@pytest.mark.parametrize("method", ["mean", "vlad"])
def test_detect_loop_closures_match_jax(loop_features, method):
    descs, valid, xy, K = loop_features
    kw = dict(min_gap=20, sim_threshold=0.8, method=method, seed=0)
    cj = jlc.detect_loop_closures(jnp.asarray(descs), jnp.asarray(valid), xy, K, **kw)
    # the JAX draws follow the JAX candidate order, the port's samples the
    # port's: reorder them to the port's candidates
    cands_j = jlc.propose_candidates(jnp.asarray(descs), jnp.asarray(valid), min_gap=20,
                                     sim_threshold=0.8, method=method)
    cands_t = tlc.propose_candidates(_t(descs), _t(valid), min_gap=20, sim_threshold=0.8,
                                     method=method)
    row = {(int(i), int(j)): p for p, (i, j) in enumerate(cands_j)}
    samples = _jax_samples(descs, valid, cands_j, 0)[[row[(int(i), int(j))] for i, j in cands_t]]
    ct = tlc.detect_loop_closures(descs, valid, xy, K, samples=samples, device="cpu", **kw)
    assert len(cj) > 0
    S = _similarity(descs, valid, method)
    assert (_in_tie_groups([(c.i, c.j) for c in ct], S)
            == _in_tie_groups([(c.i, c.j) for c in cj], S))
    by_pair = {(c.i, c.j): c for c in cj}
    for a in ct:
        b = by_pair[(a.i, a.j)]
        assert abs(a.n_inliers - b.n_inliers) <= 1, (a.i, a.j, a.n_inliers, b.n_inliers)
        np.testing.assert_allclose(a.R_rel, np.asarray(b.R_rel), atol=1e-3)
        assert len(a.uv_i) == a.n_inliers and len(a.uv_j) == a.n_inliers
    # the true revisits are among them, as tests/test_loopclosure.py asks
    assert {(0, 32), (1, 33)} & {(c.i, c.j) for c in ct}


def test_detect_loop_closures_own_generator(loop_features):
    """The port's own draws (no injected samples) find the revisits too."""
    descs, valid, xy, K = loop_features
    ct = tlc.detect_loop_closures(descs, valid, xy, K, min_gap=20, sim_threshold=0.8,
                                  device="cpu")
    pairs = {(c.i, c.j) for c in ct}
    assert {(0, 32), (1, 33)} & pairs, pairs
    assert all(c.n_inliers >= 15 for c in ct)


def test_detect_loop_closures_defaults_to_the_card(loop_features):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    descs, valid, xy, K = loop_features
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlc.detect_loop_closures(descs, valid, xy, K)
