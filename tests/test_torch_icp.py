"""Parity of the port's ICP (`tpu3drec_torch/sfm/icp.py`) and of the ICP
nearest-neighbour kernel's plain version (`tpu3drec_torch/ops/icp_nn.py`)
with the JAX package.

Tolerances:
  * nearest_neighbors_plain vs the Pallas kernel (interpret mode): idx
    equal, d2 within 1e-6 relative; both compute direct differences.
  * vs the JAX blocked scan, which uses the |a|^2+|b|^2-2ab identity and
    so rounds differently: d2 within 1e-4 absolute (that test's own bound),
    idx equal except at near ties (float64 distances within 1e-6 relative).
  * icp / icp_scale_correction on the fixtures of tests/test_icp.py: T
    within 1e-4 absolute.
  * point-to-plane: kNN indices equal on tied grids; normals equal up to
    sign within 1e-5 (|dot| >= 1 - 1e-5; eigh may return either sign in
    either package); T within 1e-5 absolute (measured 1.2e-7).
The CUDA kernel itself runs only on the card: its test is in
tests/test_torch_smoke.py, which does not import JAX.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec.ops.icp_nn import nearest_neighbors_pallas
from tpu3drec.sfm import icp as jicp
from tpu3drec_torch.ops import icp_nn as ticp_nn
from tpu3drec_torch.sfm import icp as ticp

torch.set_num_threads(2)
SEEDS = [0, 1, 2]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _brute(q, r):
    d = ((q[:, None].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    return d.argmin(1), d


def _assert_near_ties(q, r, idx, want_idx):
    """Indices equal, except where both candidates are equally near in
    float64 (to 1e-6 relative)."""
    idx, want_idx = np.asarray(idx), np.asarray(want_idx)
    diff = np.nonzero(idx != want_idx)[0]
    if diff.size:
        _, d = _brute(q[diff], r)
        da = d[np.arange(diff.size), idx[diff]]
        db = d[np.arange(diff.size), want_idx[diff]]
        np.testing.assert_allclose(da, db, rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("nq,nr", [(1, 1), (300, 700), (257, 1025), (100, 3001)])
def test_plain_matches_pallas(seed, nq, nr):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, 3)).astype(np.float32)
    r = rng.normal(size=(nr, 3)).astype(np.float32)
    idx, d2 = ticp_nn.nearest_neighbors_plain(_t(q), _t(r))
    jidx, jd2 = nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(r), interpret=True)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("block", [64, 1024])
def test_plain_matches_blocked_scan(seed, block):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(128, 3)).astype(np.float32)
    r = rng.normal(size=(777, 3)).astype(np.float32)
    idx, d2 = ticp.nearest_neighbors(_t(q), _t(r), block=block)
    jidx, jd2 = jicp._nearest_neighbors_scan(jnp.asarray(q), jnp.asarray(r), block=128)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-4)
    _assert_near_ties(q, r, idx.numpy(), jidx)
    bidx, bd = _brute(q, r)
    _assert_near_ties(q, r, idx.numpy(), bidx)


@pytest.mark.parametrize("block", [1, 5, 1024])
def test_plain_ties_go_to_first_index(block):
    lattice = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    r = np.concatenate([lattice[::-1], lattice, lattice]).astype(np.float32)
    q = np.concatenate([lattice + 0.5, lattice]).astype(np.float32)
    idx, d2 = ticp_nn.nearest_neighbors_plain(_t(q), _t(r), block=block)
    _, d = _brute(q, r)
    first = (d == d.min(1, keepdims=True)).argmax(1)  # lowest index among the minima
    np.testing.assert_array_equal(idx.numpy(), first)
    np.testing.assert_array_equal(d2.numpy(), d.min(1).astype(np.float32))
    jidx, _ = nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(r), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_plain_padding_sentinel_never_wins():
    """Rows at the ICP's 1e9 sentinel lose to any real reference."""
    q = np.array([[100.0, 100.0, 100.0]], np.float32)
    r = np.concatenate([np.random.default_rng(0).normal(size=(5, 3)),
                        np.full((3, 3), 1e9)]).astype(np.float32)
    idx, _ = ticp_nn.nearest_neighbors_plain(_t(q), _t(r))
    assert int(idx[0]) == int(_brute(q, r[:5])[0][0])


def test_wrapper_checks_its_inputs():
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        ticp_nn.nearest_neighbors_cuda(q, q)
    with pytest.raises(ValueError, match="float32"):
        ticp_nn.nearest_neighbors_cuda(q.double(), q)
    with pytest.raises(ValueError, match="float32"):
        ticp_nn.nearest_neighbors_cuda(torch.zeros((4, 2)), q)
    with pytest.raises(ValueError, match="contiguous"):
        ticp_nn.nearest_neighbors_cuda(torch.zeros((3, 4)).t(), q)
    with pytest.raises(ValueError, match="empty"):
        ticp_nn.nearest_neighbors_plain(q, torch.zeros((0, 3)))


def test_build_without_nvcc_raises():
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    from tpu3drec_torch.ops import build

    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


# ---- the kernel's split plan and key merge, held here on the CPU ----------


def _key_np(d, idx):
    return (d.astype(np.float32).view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
        idx.astype(np.uint64)


@pytest.mark.parametrize("seed", SEEDS)
def test_packed_key_orders_as_distance_then_index(seed):
    """bits(d) << 32 | idx, as an unsigned integer, orders like (d, idx) for
    d >= 0: +0, subnormals, 1e30 (the start value), inf and random d."""
    rng = np.random.default_rng(seed)
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    special = np.array([0.0, tiny, 2 * tiny, np.finfo(np.float32).tiny, 1e-30, 1.0, 1e30,
                        np.nextafter(np.float32(1e30), np.float32(np.inf)), np.inf], np.float32)
    d = np.concatenate([special, rng.exponential(size=200).astype(np.float32),
                        rng.choice(special, 200)])
    idx = rng.integers(0, 2**31 - 1, d.size).astype(np.int64)
    idx[:50] = idx[50:100]  # equal indices too
    key = ticp_nn.pack_key(torch.as_tensor(d), torch.as_tensor(idx))
    assert key.dtype == torch.int64 and bool((key >= 0).all())  # never negative as int64
    np.testing.assert_array_equal(key.numpy().astype(np.uint64), _key_np(d, idx))
    by_key = np.argsort(key.numpy(), kind="stable")
    by_pair = np.lexsort((idx, d))
    np.testing.assert_array_equal(key.numpy()[by_key], key.numpy()[by_pair])
    np.testing.assert_array_equal(d[by_key], d[by_pair])
    np.testing.assert_array_equal(idx[by_key], idx[by_pair])
    back_i, back_d = ticp_nn.unpack_key(key)
    np.testing.assert_array_equal(back_i.numpy(), idx.astype(np.int32))
    np.testing.assert_array_equal(back_d.numpy().view(np.uint32), d.view(np.uint32))
    assert ticp_nn.KEY_INIT == int(_key_np(np.array([1e30]), np.array([0]))[0])


def _plan_ranges(splits, chunk, nr):
    return [(s * chunk, min(nr, (s + 1) * chunk)) for s in range(splits)]


@pytest.mark.parametrize("nq,nr", [(1, 1), (76_800, 5), (76_800, 20), (1000, 3001),
                                   (76_800, 76_800), (76_801, 76_799)])
@pytest.mark.parametrize("sms,bps", [(132, 8), (132, 7), (114, 5), (1, 1)])
def test_split_plan_covers_every_reference_once(nq, nr, sms, bps):
    splits, chunk = ticp_nn.split_plan(nq, nr, sms, bps)
    assert 1 <= splits <= ticp_nn.MAX_SPLITS and chunk % ticp_nn.GROUP == 0
    ranges = _plan_ranges(splits, chunk, nr)
    assert all(lo < hi for lo, hi in ranges)  # no empty split
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    np.testing.assert_array_equal(covered, np.arange(nr))
    if nr >= ticp_nn.GROUP * ticp_nn.MAX_SPLITS and sms * bps > 1:
        # the slowest SM's references stay within 10% of an even spread
        qblocks = -(-nq // ticp_nn.Q_PER_BLOCK)
        waves = -(-qblocks * splits // (sms * bps))
        assert waves * chunk <= 1.1 * qblocks * nr / (sms * bps) + chunk


def test_split_plan_at_the_slice_shape():
    # 150 query blocks x 7 splits = 1050 blocks in 132 SMs x 8 slots: one wave
    assert ticp_nn.split_plan(76_800, 76_800, 132, 8) == (7, 10_976)
    with pytest.raises(ValueError):
        ticp_nn.split_plan(1, 0, 132, 8)


def _split_merged_plain(q, r, chunk):
    """The kernel's merge with the plain version: each split's answer, where
    it beat the 1e30 start, folded into keys by their minimum."""
    key = torch.full((q.shape[0],), ticp_nn.KEY_INIT, dtype=torch.int64)
    ranges = _plan_ranges(-(-r.shape[0] // chunk), chunk, r.shape[0])
    for lo, hi in ranges[::-1]:  # any order of arrival
        idx, d2 = ticp_nn.nearest_neighbors_plain(q, r[lo:hi])
        k = ticp_nn.pack_key(d2, idx + lo)
        key = torch.where(d2 < 1e30, torch.minimum(key, k), key)
    return ticp_nn.unpack_key(key)


def _tie_lattice(rng):
    """chip_smoke.py phase 3's `ties` case: exact duplicates in the
    reference set and queries on lattice points and midpoints."""
    lattice = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    dup = rng.normal(size=(700, 3))
    return (np.concatenate([lattice + 0.5, lattice, dup[:300]]),
            np.concatenate([dup, lattice, dup, lattice[::-1]]))


@pytest.mark.parametrize("case", ["random", "ties", "far_split"])
@pytest.mark.parametrize("chunk", [8, 16, 216, 704])
def test_split_merge_equals_unsplit_plain(case, chunk):
    rng = np.random.default_rng(chunk)
    if case == "random":
        q, r = rng.normal(size=(300, 3)), rng.normal(size=(1001, 3))
    elif case == "ties":
        q, r = _tie_lattice(rng)
    else:  # a split whose distances all reach the 1e30 start: it never merges
        q, r = rng.normal(size=(200, 3)), rng.normal(size=(900, 3))
        r[chunk:2 * chunk] = 1e16
    q, r = _t(q), _t(r)
    idx, d2 = _split_merged_plain(q, r, chunk)
    pidx, pd2 = ticp_nn.nearest_neighbors_plain(q, r)
    assert torch.equal(idx, pidx) and torch.equal(d2, pd2)


@pytest.mark.parametrize("seed", SEEDS)
def test_pairwise_sqdist(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(10, 3)).astype(np.float32)
    b = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(ticp.pairwise_sqdist(_t(a), _t(b)).numpy(),
                               np.asarray(jicp.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)


def _random_similarity(rng, scale):
    T = np.eye(4)
    T[:3, :3] = scale * ScipyR.from_rotvec(rng.normal(size=3) * 0.3).as_matrix()
    T[:3, 3] = rng.normal(size=3)
    return T


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama(seed, with_scale):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(100, 3)).astype(np.float32)
    T = _random_similarity(rng, 2.5 if with_scale else 1.0)
    dst = (src @ T[:3, :3].T + T[:3, 3] + rng.normal(size=src.shape) * 0.01).astype(np.float32)
    w = (rng.random(100) < 0.9).astype(np.float32)
    s, R, t = ticp.umeyama(_t(src), _t(dst), _t(w), with_scale=with_scale)
    js, jR, jt = jicp.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), with_scale=with_scale)
    np.testing.assert_allclose(float(s), float(js), atol=1e-4)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)


def _grid_fixture(rng):
    """tests/test_icp.py::test_icp_recovers_similarity's inputs."""
    g = np.stack(np.meshgrid(np.linspace(0, 2, 12), np.linspace(0, 1, 8),
                             np.linspace(0, 0.5, 4)), -1).reshape(-1, 3)
    src = (g + 0.01 * rng.normal(size=g.shape)).astype(np.float32)
    T_true = _random_similarity(rng, 1.8)
    return src, (src @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32), {}


def _partial_fixture(rng):
    """tests/test_icp.py::test_icp_partial_overlap_trimming's inputs."""
    g = rng.uniform([0, 0, 0], [2, 1, 0.5], size=(300, 3)).astype(np.float32)
    T_true = _random_similarity(rng, 1.0)
    dst = (g @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    return g[: int(0.8 * len(g))], dst, dict(with_scale=False, inlier_quantile=0.8)


def _trim_rounding_band(src, dst, T_prev, inlier_quantile):
    """The last ICP step seen from the port, from the transform before it.

    The JAX CPU scan forms distances by the |a|^2+|b|^2-2ab identity, which
    is off from direct differences by at most ``err`` = 4 eps (|a|^2+|b|^2),
    and its trim threshold, an interpolated order statistic of those
    distances, moves by no more. A point's trimming can differ between the
    two packages only if its distance lies within 2 err of the threshold.
    Returns (number of such points, err)."""
    s, d = torch.as_tensor(src), torch.as_tensor(dst)
    cur = s @ T_prev[:3, :3].T + T_prev[:3, 3]
    idx, d2 = ticp.nearest_neighbors(cur, d)
    thresh = torch.nanquantile(d2, inlier_quantile)
    eps = float(np.finfo(np.float32).eps)
    err = 4 * eps * float(((cur * cur).sum(1) + (d[idx.long()] ** 2).sum(1)).max())
    return int(((d2 - thresh).abs() <= 2 * err).sum()), err


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fixture", [_grid_fixture, _partial_fixture])
def test_icp_matches_jax(seed, fixture):
    src, dst, kw = fixture(np.random.default_rng(seed))
    res = ticp.icp(src, dst, iters=30, block=128, device="cpu", **kw)
    jres = jicp.icp(jnp.asarray(src), jnp.asarray(dst), iters=30, block=128, **kw)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jres.T), atol=1e-4)
    np.testing.assert_allclose(float(res.scale), float(jres.scale), atol=1e-4)
    T_prev = ticp.icp(src, dst, iters=29, block=128, device="cpu", **kw).T
    band, err = _trim_rounding_band(src, dst, T_prev, kw.get("inlier_quantile", 0.9))
    # Inlier counts agree but for the points whose trimming rounding decides.
    assert abs(int(res.n_inliers) - int(jres.n_inliers)) <= band
    if band == 0:
        # The same inliers, each distance within err: |rmse^2 - rmse_jax^2|
        # <= err, so the RMSEs differ by at most err / rmse.
        np.testing.assert_allclose(float(res.rmse), float(jres.rmse),
                                   atol=err / float(res.rmse))
    else:
        # Converged fixtures: every distance sits within rounding of zero and
        # of the threshold, and the identity form's rounding reaches ~3e-4
        # in the JAX RMSE where direct differences give ~1e-6.
        np.testing.assert_allclose(float(res.rmse), float(jres.rmse), atol=1e-3)


@pytest.mark.parametrize("seed", SEEDS)
def test_icp_scale_correction_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform([0, 0, 0], [3, 2, 1], size=(400, 3)).astype(np.float32)
    T_ba = _random_similarity(rng, 1.25)
    b = (a @ T_ba[:3, :3].T + T_ba[:3, 3]).astype(np.float32)
    T = ticp.icp_scale_correction(a, b, iters=40, device="cpu")
    jT = jicp.icp_scale_correction(jnp.asarray(a), jnp.asarray(b), iters=40)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)


def test_icp_with_init_T():
    rng = np.random.default_rng(7)
    src, dst, _ = _grid_fixture(rng)
    init = np.eye(4, dtype=np.float32)
    res = ticp.icp(src, dst, iters=5, block=128, init_T=init, device="cpu")
    jres = jicp.icp(jnp.asarray(src), jnp.asarray(dst), iters=5, block=128, init_T=jnp.asarray(init))
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jres.T), atol=1e-4)
    with pytest.raises(ValueError):
        ticp.icp(src, dst, iters=0, device="cpu")


# ---- point-to-plane ICP ------------------------------------------------------


def _jax_knn(points, k, block):
    """tpu3drec/sfm/icp.py:228-246's running ``lax.top_k`` kNN, as written
    there (the JAX package keeps it inside `estimate_normals`)."""
    import jax

    n = points.shape[0]
    nblocks = -(-n // block)
    ref = jnp.pad(points, ((0, nblocks * block - n), (0, 0)), constant_values=1e9)
    best_d, best_i = jnp.full((n, k), -jnp.inf), jnp.zeros((n, k), jnp.int32)
    for b in range(nblocks):
        d = jicp.pairwise_sqdist(points, ref[b * block:(b + 1) * block])
        cat_d = jnp.concatenate([best_d, -d], axis=1)
        cat_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(jnp.arange(block, dtype=jnp.int32)[None] + b * block,
                                      d.shape)], axis=1)
        best_d, sel = jax.lax.top_k(cat_d, k)
        best_i = jnp.take_along_axis(cat_i, sel, axis=1)
    return np.asarray(best_i)


def _same_up_to_sign(n1, n2, tol=1e-5):
    assert np.abs(np.abs((n1 * n2).sum(1)) - 1.0).max() <= tol


@pytest.mark.parametrize("block", [37, 64, 2048])
@pytest.mark.parametrize("k", [6, 8, 16])
def test_knn_ties_on_a_grid(block, k):
    """On a regular grid every distance is an exact integer and most are
    tied: the earlier neighbour must win each tie, as ``lax.top_k`` lets it."""
    g = np.stack(np.meshgrid(np.arange(7.0), np.arange(5.0), np.arange(3.0), indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    got = ticp.knn_indices(_t(g), k=k, block=block).numpy()
    np.testing.assert_array_equal(got, _jax_knn(jnp.asarray(g), k, block))
    d = ((g[:, None] - g[None]) ** 2).sum(-1)
    want = np.stack([np.lexsort((np.arange(len(g)), row))[:k] for row in d])
    np.testing.assert_array_equal(got, want)
    nrm = ticp.estimate_normals(_t(g), k=k, block=block).numpy()
    _same_up_to_sign(nrm, np.asarray(jicp.estimate_normals(jnp.asarray(g), k=k, block=block)))


@pytest.mark.parametrize("seed", SEEDS)
def test_estimate_normals_plane(seed):
    """tests/test_icp.py::test_estimate_normals_plane's fixture."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(0, 2, size=(200, 2)), np.zeros((200, 1))],
                         axis=1).astype(np.float32)
    nrm = ticp.estimate_normals(_t(pts), k=8, block=64).numpy()
    _same_up_to_sign(nrm, np.asarray(jicp.estimate_normals(jnp.asarray(pts), k=8, block=64)))
    assert np.abs(np.abs(nrm[:, 2]) - 1.0).max() < 1e-3


def _three_planes(rng):
    """tests/test_icp.py::test_icp_point_to_plane_recovers_rigid's inputs."""
    a = np.concatenate([rng.uniform(0, 2, size=(200, 2)), np.zeros((200, 1))], 1)
    b = np.concatenate([rng.uniform(0, 2, size=(200, 1)), np.zeros((200, 1)),
                        rng.uniform(0, 1, size=(200, 1))], 1)
    c = np.concatenate([np.zeros((200, 1)), rng.uniform(0, 2, size=(200, 1)),
                        rng.uniform(0, 1, size=(200, 1))], 1)
    g = np.concatenate([a, b, c]).astype(np.float32)
    T_true = _random_similarity(rng, 1.0)
    return g, (g @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32), T_true


@pytest.mark.parametrize("seed", SEEDS)
def test_icp_point_to_plane_matches_jax(seed):
    """Three orthogonal planes under a random rigid motion, 20 iterations.

    The JAX CPU NN scan forms distances by |a|^2+|b|^2-2ab, the port (and
    the kernel) by direct differences. At convergence every distance sits
    within that rounding of zero, so the 0.9-quantile trim threshold is
    rounding too: at seeds 0/1/2 the port keeps 542/541/540 inliers where
    the JAX package keeps 557/572/543, all within the band of points whose
    distance lies within rounding of the threshold; the final RMSEs are both
    ~1e-8 (3.5e-8 vs 3.3e-8 at seed 0), far below the 1e-2 bar, and the
    transforms agree to 1.2e-7."""
    g, dst, T_true = _three_planes(np.random.default_rng(seed))
    res = ticp.icp_point_to_plane(g, dst, iters=20, block=128, device="cpu")
    jres = jicp.icp_point_to_plane(jnp.asarray(g), jnp.asarray(dst), iters=20, block=128)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jres.T), atol=1e-5)
    np.testing.assert_allclose(res.T.numpy(), T_true, atol=5e-2)
    assert float(res.rmse) < 1e-2 and float(jres.rmse) < 1e-2
    assert float(res.scale) == 1.0 and res.n_inliers.dtype == torch.int32
    T_prev = ticp.icp_point_to_plane(g, dst, iters=19, block=128, device="cpu").T
    band, _ = _trim_rounding_band(g, dst, T_prev, 0.9)
    assert abs(int(res.n_inliers) - int(jres.n_inliers)) <= band


def test_icp_point_to_plane_given_normals_and_init():
    """Supplied normals and an initial transform skip the estimation and the
    centroid pre-alignment in both packages."""
    rng = np.random.default_rng(11)
    g, dst, _ = _three_planes(rng)
    nrm = np.asarray(jicp.estimate_normals(jnp.asarray(dst), k=16, block=128))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = dst.mean(0) - g.mean(0)
    res = ticp.icp_point_to_plane(g, dst, dst_normals=nrm, init_T=init, iters=10, block=128,
                                  device="cpu")
    jres = jicp.icp_point_to_plane(jnp.asarray(g), jnp.asarray(dst), dst_normals=jnp.asarray(nrm),
                                   init_T=jnp.asarray(init), iters=10, block=128)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jres.T), atol=1e-5)
    with pytest.raises(ValueError):
        ticp.icp_point_to_plane(g, dst, iters=0, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_so3_exp(seed):
    from tpu3drec.sfm.icp import _so3_exp

    rng = np.random.default_rng(seed)
    for w in (rng.normal(size=3), np.zeros(3), np.full(3, 1e-9), rng.normal(size=3) * 3):
        w = w.astype(np.float32)
        np.testing.assert_allclose(ticp._so3_exp(_t(w)).numpy(),
                                   np.asarray(_so3_exp(jnp.asarray(w))), atol=1e-6)
