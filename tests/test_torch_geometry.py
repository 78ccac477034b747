"""Parity of the port's two-view geometry, triangulation and PnP
(`tpu3drec_torch/sfm/{triangulate,twoview,pnp,sampling}.py`) with the JAX
package on the CPU.

RANSAC draws its minimal samples from JAX's PRNG in the reference and from
a torch.Generator in the port; the parity tests draw the indices with
JAX (the same ``jax.random.categorical`` call the estimator makes) and
inject them, then hold R within 1e-4 rad, t within 1e-4 and the inlier sets
identical except for points on the gate: reprojection error within 1e-3 px
of it (PnP), Sampson error within 1e-3 of it, relative (two-view). Each estimator also mirrors its
reference test in tests/test_twoview.py with the port's own generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec.sfm import pnp as jpnp
from tpu3drec.sfm import triangulate as jtri
from tpu3drec.sfm import twoview as jtv
from tpu3drec_torch.sfm import pnp, triangulate, twoview
from tpu3drec_torch.sfm.sampling import draw_samples, seeded_generator

from test_twoview import K, _project, _scene


def _t(x):
    return torch.tensor(np.array(x))


def _rot_err(Ra, Rb):
    """Angle of Ra^T Rb in radians, from its antisymmetric part (accurate
    for small angles, unlike arccos of the trace in float32)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2
    return float(np.arcsin(min(np.linalg.norm(w), 1.0)))


def _jax_samples(key, valid, m, n=2048):
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    return np.asarray(jax.random.categorical(key, logits, shape=(n, m)))


# ------------------------------------------------------------ triangulation

def test_two_view_triangulation_matches_jax(rng):
    X, R, t = _scene(rng, 50)
    uv1 = _project(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2 = _project(X, R, t) + rng.normal(0, 0.3, (50, 2)).astype(np.float32)
    P1 = jtri.projection_matrix(jnp.eye(3), jnp.zeros(3), jnp.asarray(K))
    P2 = jtri.projection_matrix(jnp.asarray(R), jnp.asarray(t), jnp.asarray(K))
    Xj = np.asarray(jtri.triangulate_two_view(P1, P2, jnp.asarray(uv1), jnp.asarray(uv2)))
    tP1 = triangulate.projection_matrix(torch.eye(3), torch.zeros(3), _t(K))
    tP2 = triangulate.projection_matrix(_t(R), _t(t), _t(K))
    np.testing.assert_allclose(tP2.numpy(), np.asarray(P2), rtol=1e-6)
    Xt = triangulate.triangulate_two_view(tP1, tP2, _t(uv1), _t(uv2)).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)
    Xn = triangulate.triangulate_two_view_np(np.asarray(P1), np.asarray(P2), uv1, uv2)
    np.testing.assert_allclose(Xn, jtri.triangulate_two_view_np(P1, P2, uv1, uv2), rtol=1e-6)
    e = triangulate.reprojection_errors(_t(Xt), _t(R), _t(t), _t(K), _t(uv2)).numpy()
    ej = np.asarray(jtri.reprojection_errors(jnp.asarray(Xt), jnp.asarray(R), jnp.asarray(t),
                                             jnp.asarray(K), jnp.asarray(uv2)))
    np.testing.assert_allclose(e, ej, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(triangulate.reprojection_errors_np(Xt, R, t, K, uv2), ej,
                               rtol=1e-4, atol=1e-4)


def test_multiview_triangulation_with_mask(rng):
    X, R, t = _scene(rng, 1)
    R2 = ScipyR.from_rotvec([0.1, 0.2, 0]).as_matrix().astype(np.float32)
    t2 = np.array([-1.0, 0.5, 0.2], np.float32)
    views = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), (R, t), (R2, t2)]
    Ps = np.stack([K @ np.concatenate([r, tt[:, None]], 1) for r, tt in views]).astype(np.float32)
    uvs = np.stack([_project(X, r, tt)[0] for r, tt in views])
    uvs[2] = [9999, 9999]
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    Xt = triangulate.triangulate_multiview(_t(Ps), _t(uvs), _t(mask)).numpy()
    Xj = np.asarray(jtri.triangulate_multiview(jnp.asarray(Ps), jnp.asarray(uvs), jnp.asarray(mask)))
    np.testing.assert_allclose(Xt, X[0], atol=1e-2)
    np.testing.assert_allclose(Xt, Xj, rtol=1e-3, atol=1e-3)


# -------------------------------------------------------------- eight point

def test_eight_point_and_sampson_match_jax(rng):
    X, R, t = _scene(rng, 64)
    uv1 = _project(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2 = _project(X, R, t)
    x1j = jtv.normalize_points(jnp.asarray(uv1), jnp.asarray(K))
    x2j = jtv.normalize_points(jnp.asarray(uv2), jnp.asarray(K))
    x1 = twoview.normalize_points(_t(uv1), _t(K))
    x2 = twoview.normalize_points(_t(uv2), _t(K))
    np.testing.assert_array_equal(x1.numpy(), np.asarray(x1j))
    Ej = np.asarray(jtv.eight_point(x1j, x2j, jnp.ones(64)))
    Et = twoview.eight_point(x1, x2, torch.ones(64)).numpy()
    # E is defined up to sign: compare after fixing it
    Et = Et * np.sign(np.sum(Et * Ej))
    np.testing.assert_allclose(Et, Ej, atol=1e-5)
    assert twoview.sampson_error(_t(Ej), x1, x2).numpy().max() < 1e-8
    # decompositions agree as sets of candidate poses
    Rs, ts = twoview.decompose_essential(_t(Ej))
    Rj, tj = jtv.decompose_essential(jnp.asarray(Ej))
    for k in range(4):
        assert min(_rot_err(Rs[k].numpy(), np.asarray(Rj)[i]) for i in range(4)) < 1e-4
        assert min(np.abs(ts[k].numpy() - np.asarray(tj)[i]).max() for i in range(4)) < 1e-5


# ------------------------------------------------------------------ RANSAC

def test_draw_samples_law(rng):
    valid = _t(rng.random((3, 50)) < 0.3)
    valid[2] = False
    s = draw_samples(valid, 512, 8, seeded_generator("cpu", 0))
    assert tuple(s.shape) == (3, 512, 8)
    for b in range(2):
        allowed = set(np.nonzero(valid[b].numpy())[0])
        assert set(np.unique(s[b].numpy())) == allowed  # every valid index, nothing else
    assert (s[2] == 0).all()  # no valid entry: index 0, as the all--inf categorical gives
    again = draw_samples(valid, 512, 8, seeded_generator("cpu", 0))
    assert torch.equal(s, again)


def _outlier_pair(rng, n=300, n_out=75):
    X, R, t = _scene(rng, n)
    uv1 = _project(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2 = _project(X, R, t)
    uv2[:n_out] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return uv1, uv2, R, t


def _gate_near(uv1, uv2, R, t, inlier_px):
    """Correspondences whose Sampson error lies within 1e-3 (relative) of
    the two-view gate."""
    x1 = jtv.normalize_points(jnp.asarray(uv1), jnp.asarray(K))
    x2 = jtv.normalize_points(jnp.asarray(uv2), jnp.asarray(K))
    E = jtv._skew(jnp.asarray(t)) @ jnp.asarray(R)
    err = np.asarray(jtv.sampson_error(E, x1, x2))
    thresh = (inlier_px / K[0, 0]) ** 2
    return np.abs(err - thresh) <= 1e-3 * thresh


@pytest.mark.parametrize("key", [0, 5])
def test_relative_pose_matches_jax_with_its_samples(key, rng):
    uv1, uv2, R, t = _outlier_pair(rng)
    valid = np.ones(300, bool)
    valid[-20:] = False
    pk = jax.random.PRNGKey(key)
    rj = jtv.estimate_relative_pose(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                                    jnp.asarray(K), pk)
    rt = twoview.estimate_relative_pose(_t(uv1), _t(uv2), _t(valid), _t(K),
                                        samples=_t(_jax_samples(pk, valid, 8)))
    assert _rot_err(rt.R.numpy(), np.asarray(rj.R)) < 1e-4
    assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < 1e-4
    differ = rt.inliers.numpy() != np.asarray(rj.inliers)
    near = _gate_near(uv1, uv2, np.asarray(rj.R), np.asarray(rj.t), 1.5)
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert int(rt.n_inliers) > 200


def test_relative_pose_batched_equals_single(rng):
    uv1, uv2, _, _ = _outlier_pair(rng, 200, 40)
    valid = np.ones(200, bool)
    s = _jax_samples(jax.random.PRNGKey(1), valid, 8, n=256)
    one = twoview.estimate_relative_pose(_t(uv1), _t(uv2), _t(valid), _t(K), samples=_t(s))
    two = twoview.estimate_relative_pose(_t(np.stack([uv2, uv1])), _t(np.stack([uv1, uv2])),
                                         _t(np.stack([valid, valid])), _t(K),
                                         samples=_t(np.stack([s, s])))
    np.testing.assert_allclose(two.R[1].numpy(), one.R.numpy(), atol=1e-6)
    assert torch.equal(two.inliers[1], one.inliers)
    assert tuple(two.n_inliers.shape) == (2,)


def test_recover_pose_with_outliers_own_generator(rng):
    """tests/test_twoview.py::TestRelativePose with the port's generator."""
    uv1, uv2, R, t = _outlier_pair(rng)
    res = twoview.estimate_relative_pose(_t(uv1), _t(uv2), torch.ones(300, dtype=torch.bool),
                                         _t(K), seeded_generator("cpu", 0))
    np.testing.assert_allclose(res.R.numpy(), R, atol=2e-2)
    np.testing.assert_allclose(res.t.numpy(), t / np.linalg.norm(t), atol=3e-2)
    assert int(res.n_inliers) > 200
    assert res.inliers.numpy()[:75].mean() < 0.1


def _pnp_case(rng, kind):
    if kind == "exact":
        X, R, t = _scene(rng, 100)
        return X, _project(X, R, t), R, t
    if kind == "outliers":
        X, R, t = _scene(rng, 200)
        uv = _project(X, R, t) + rng.normal(0, 0.5, size=(200, 2)).astype(np.float32)
        uv[:40] = rng.uniform([0, 0], [640, 480], size=(40, 2))
        return X, uv, R, t
    # coplanar: a tilted facade filling the view (the DLT is rank-deficient)
    e1 = np.array([1.0, 0.1, 0.2])
    e1 /= np.linalg.norm(e1)
    e2 = np.array([-0.1, 1.0, 0.1])
    e2 -= e1 * (e2 @ e1)
    e2 /= np.linalg.norm(e2)
    ab = rng.uniform(-3, 3, size=(120, 2))
    X = (np.array([0.0, 0.0, 9.0]) + ab[:, :1] * e1 + ab[:, 1:] * e2).astype(np.float32)
    R = ScipyR.from_rotvec([0.05, -0.15, 0.02]).as_matrix().astype(np.float32)
    t = np.array([0.4, -0.1, 0.3], np.float32)
    return X, _project(X, R, t) + rng.normal(0, 0.3, (120, 2)).astype(np.float32), R, t


@pytest.mark.parametrize("kind", ["exact", "outliers", "coplanar"])
def test_pnp_matches_jax_with_its_samples(kind, rng):
    X, uv, R, t = _pnp_case(rng, kind)
    n = X.shape[0]
    valid = np.ones(n, bool)
    pk = jax.random.PRNGKey(3)
    rj = jpnp.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(K), pk)
    rt = pnp.pnp_ransac(_t(X), _t(uv), _t(valid), _t(K), samples=_t(_jax_samples(pk, valid, 6)))
    assert _rot_err(rt.R.numpy(), np.asarray(rj.R)) < 1e-4
    assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < 1e-4
    err = np.asarray(jtri.reprojection_errors(jnp.asarray(X), rj.R, rj.t, jnp.asarray(K),
                                              jnp.asarray(uv)))
    differ = rt.inliers.numpy() != np.asarray(rj.inliers)
    assert not (differ & (np.abs(err - 3.0) > 1e-3)).any()
    # and the reference test's own bars, with the port's generator
    own = pnp.pnp_ransac(_t(X), _t(uv), _t(valid), _t(K), seeded_generator("cpu", 7))
    tol = {"exact": (1e-3, 1e-3), "outliers": (1e-2, 5e-2), "coplanar": (2e-2, 8e-2)}[kind]
    np.testing.assert_allclose(own.R.numpy(), R, atol=tol[0])
    np.testing.assert_allclose(own.t.numpy(), t, atol=tol[1])
    assert int(own.n_inliers) >= {"exact": 100, "outliers": 141, "coplanar": 101}[kind]
