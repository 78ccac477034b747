"""Parity of the port's matcher and matching (`tpu3drec_torch/ops/matcher.py`,
`tpu3drec_torch/sfm/matching.py`) with the JAX package on the CPU.

The matcher kernel's plain version is held against the Pallas kernels in
interpret mode: indices equal except where JAX's own top-2 gap is under
1e-5 (a near tie, where XLA's summation order may pick the other one),
scores within 1e-5. The match sets of `match_descriptors`, `match_pairs`
(both routes) and `guided_match_pairs` are identical on the fixtures of
tests/test_features.py and tests/test_guided_matching.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.ops import matcher as jmatcher
from tpu3drec.sfm import matching as jm
from tpu3drec_torch.ops import matcher
from tpu3drec_torch.sfm import matching as tm

SCORE_TOL = 1e-5


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.tensor(np.array(x))


def _assert_top2_close(best_j, top2_j, best_t, top2_t):
    best_j, top2_j = np.asarray(best_j), np.asarray(top2_j)
    best_t, top2_t = best_t.numpy(), top2_t.numpy()
    np.testing.assert_allclose(top2_t, top2_j, rtol=0, atol=SCORE_TOL)
    differ = best_j != best_t
    gap = top2_j[..., 0] - top2_j[..., 1]
    assert (gap[differ] < SCORE_TOL).all(), f"{differ.sum()} indices differ beyond near ties"


CASES = {
    "ragged_ka": (130, 200, 32, 0.0),
    "kb_over_tile": (256, 2 * jmatcher.TILE_B + 300, 32, 0.1),
    "d128": (77, 513, 128, 0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_topk2_plain_matches_pallas(case, rng):
    Ka, Kb, D, frac_invalid = CASES[case]
    a, b = _unit(rng, Ka, D), _unit(rng, Kb, D)
    valid = rng.random(Kb) >= frac_invalid
    bj, tj = jmatcher.topk2_scores(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))
    bt, tt = matcher.topk2_scores(_t(a), _t(b), _t(valid))
    assert bt.dtype == torch.int32 and tuple(tt.shape) == (Ka, 2)
    _assert_top2_close(bj, tj, bt, tt)


def test_topk2_ties_and_all_invalid(rng):
    base = _unit(rng, 40, 16)
    refs = np.concatenate([base, base[::-1], base])  # every best score tied 3x
    q = np.concatenate([base, _unit(rng, 9, 16)])
    bj, tj = jmatcher.topk2_scores(jnp.asarray(q), jnp.asarray(refs), jnp.ones(120, bool))
    bt, tt = matcher.topk2_scores(_t(q), _t(refs), torch.ones(120, dtype=torch.bool))
    np.testing.assert_array_equal(bt.numpy()[:40], np.arange(40))  # first of the ties
    np.testing.assert_array_equal(bt.numpy()[:40], np.asarray(bj)[:40])
    # a duplicated maximum lifts s2 to s1, as the TPU kernel's tile does
    np.testing.assert_array_equal(tt.numpy()[:40, 0], tt.numpy()[:40, 1])
    _assert_top2_close(bj, tj, bt, tt)
    none = np.zeros(120, bool)
    bj, tj = jmatcher.topk2_scores(jnp.asarray(q), jnp.asarray(refs), jnp.asarray(none))
    bt, tt = matcher.topk2_scores(_t(q), _t(refs), _t(none))
    assert (bt.numpy() == 0).all() and (np.asarray(bj) == 0).all()
    assert (tt.numpy() == -3.0).all() and (np.asarray(tj) == -3.0).all()


def test_topk2_batched_plain_matches_pallas(rng):
    P, Ka, Kb, D = 3, 200, jmatcher.TILE_B + 64, 16
    a, b = _unit(rng, P, Ka, D), _unit(rng, P, Kb, D)
    valid = rng.random((P, Kb)) >= 0.1
    valid[1] = False
    bj, tj = jmatcher.topk2_scores_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))
    bt, tt = matcher.topk2_scores_batched(_t(a), _t(b), _t(valid))
    _assert_top2_close(bj, tj, bt, tt)


@pytest.mark.parametrize("tile", [1, 7, 64, 4096])
def test_plain_tiling_does_not_change_the_result(tile, rng):
    """The running top-2 merge gives the same answer for every reference
    tiling, ties included (what lets the kernel tile differently)."""
    base = _unit(rng, 30, 8)
    b = np.concatenate([base, base, _unit(rng, 71, 8)])[None]
    a = np.concatenate([base[:10], _unit(rng, 5, 8)])[None]
    v = rng.random((1, b.shape[1])) >= 0.2
    ref = matcher.topk2_scores_batched_plain(_t(a), _t(b), _t(v), tile_b=b.shape[1])
    out = matcher.topk2_scores_batched_plain(_t(a), _t(b), _t(v), tile_b=tile)
    assert torch.equal(ref[0], out[0]) and torch.equal(ref[1], out[1])


# ---- the kernel's split plan and merge, held here on the CPU --------------


@pytest.mark.parametrize("P,Ka,Kb", [(1, 1, 0), (1, 1, 1), (1, 300, 129), (1, 300, 2049),
                                     (30, 512, 512), (8, 4096, 4096), (2, 65, 300)])
@pytest.mark.parametrize("sms,bps", [(132, 2), (132, 1), (114, 3)])
def test_split_plan_covers_every_reference_once(P, Ka, Kb, sms, bps):
    splits, per = matcher.split_plan(P, Ka, Kb, sms, bps)
    assert splits >= 1 and per % matcher.TILE_R == 0
    ranges = [(s * per, min(Kb, (s + 1) * per)) for s in range(splits)]
    if Kb:
        assert all(lo < hi for lo, hi in ranges)  # no empty split
        covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
        np.testing.assert_array_equal(covered, np.arange(Kb))
    else:
        assert splits == 1


def test_split_plan_at_the_main_path_shapes():
    # two 256-thread blocks per SM on 132 SMs
    assert matcher.split_plan(30, 512, 512, 132, 2) == (2, 256)  # 240 blocks in 264 slots
    assert matcher.split_plan(8, 4096, 4096, 132, 2) == (1, 4096)  # 256 blocks in 264 slots


def _split_merged_plain(a, b, v, per, order):
    """The kernel's merge with the plain version: each split's state, whose
    index is 0 until a score beats the -3 start, folded by `merge_top2`."""
    Kb = b.shape[1]
    ranges = [(lo, min(Kb, lo + per)) for lo in range(0, Kb, per)]
    states = []
    for lo, hi in ranges:
        best, top2 = matcher.topk2_scores_batched_plain(a, b[:, lo:hi], v[:, lo:hi])
        s1, s2 = top2[..., 0], top2[..., 1]
        states.append((torch.where(s1 > matcher.INVALID, best + lo, 0), s1, s2))
    states = states[::-1] if order == "reversed" else states
    i1, s1, s2 = states[0]
    for st in states[1:]:
        i1, s1, s2 = matcher.merge_top2(i1, s1, s2, *st)
    return i1.to(torch.int32), torch.stack([s1, s2], dim=-1)


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("per", [128, 256])
def test_split_merge_equals_unsplit_plain(order, per, rng):
    """Exact ties across a split boundary, a split with no valid reference,
    Kb off the tile: split-and-merge equals one pass, bit for bit."""
    P, Ka, Kb, D = 2, 70, 3 * per + 44, 8
    b = _unit(rng, P, Kb, D)
    b[:, per:per + 20] = b[:, per - 20:per]  # tied scores straddle the boundary
    a = np.concatenate([b[:, per - 20:per], _unit(rng, P, Ka - 20, D)], 1)
    v = rng.random((P, Kb)) >= 0.2
    v[:, per - 20:per + 20] = True
    v[0, 2 * per:3 * per] = False  # a split with no valid reference
    v[1, :] = False
    v[1, per:per + 3] = True  # pair 1: valid references in one split only
    a, b, v = _t(a), _t(b), _t(v)
    best, top2 = _split_merged_plain(a, b, v, per, order)
    pbest, ptop2 = matcher.topk2_scores_batched_plain(a, b, v)
    assert torch.equal(best, pbest) and torch.equal(top2, ptop2)
    np.testing.assert_array_equal(best.numpy()[0, :20], per - 20 + np.arange(20))
    np.testing.assert_array_equal(top2.numpy()[0, :20, 0], top2.numpy()[0, :20, 1])
    # all references invalid: every split's start state, and the answer's
    none = torch.zeros_like(v)
    best, top2 = _split_merged_plain(a, b, none, per, order)
    assert bool((best == 0).all()) and bool((top2 == matcher.INVALID).all())


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    a = _t(_unit(rng, 1, 4, 8))
    with pytest.raises(ValueError):
        matcher.topk2_scores_batched_cuda(a, a, torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(ValueError):
        matcher.topk2_scores_batched(a, a[:, :, :4], torch.ones(1, 4, dtype=torch.bool))


def _same_matches(mj, mt):
    vj, vt = np.asarray(mj.valid), mt.valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(mt.idx_b.numpy()[vt], np.asarray(mj.idx_b)[vj])
    np.testing.assert_array_equal(mt.idx_a.numpy(), np.asarray(mj.idx_a))
    np.testing.assert_allclose(mt.score.numpy(), np.asarray(mj.score), atol=SCORE_TOL)


def _dots_descs(rng):
    """Descriptors of the test_features.py dots fixture, shifted by 6 px."""
    from tpu3drec.sfm.features import detect_and_describe

    from test_features import _dots_image

    img_a, _ = _dots_image(rng, n=15)
    img_b = np.roll(img_a, 6, axis=1)
    ka, da = detect_and_describe(jnp.asarray(img_a), max_keypoints=64)
    kb, db = detect_and_describe(jnp.asarray(img_b), max_keypoints=64)
    return (np.asarray(da), np.asarray(db), np.asarray(ka.valid), np.asarray(kb.valid))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_match_descriptors_matches_jax(use_pallas, rng):
    da, db, va, vb = _dots_descs(rng)
    mj = jm.match_descriptors(jnp.asarray(da), jnp.asarray(db), jnp.asarray(va),
                              jnp.asarray(vb), use_pallas=use_pallas)
    mt = tm.match_descriptors(_t(da), _t(db), _t(va), _t(vb), use_pallas=use_pallas)
    assert mt.valid.sum() >= 8
    _same_matches(mj, mt)
    # the fixture of test_features.py::TestMatcher: permuted noisy copies
    a = _unit(rng, 128, 32)
    b = a[rng.permutation(128)] + 0.01 * rng.normal(size=(128, 32)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    mj = jm.match_descriptors(jnp.asarray(a), jnp.asarray(b), use_pallas=use_pallas)
    mt = tm.match_descriptors(_t(a), _t(b), use_pallas=use_pallas)
    _same_matches(mj, mt)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_match_pairs_matches_jax(use_pallas, rng):
    F, K, D = 4, 128, 32
    descs = _unit(rng, F, K, D)
    descs[1:] = descs[:1] + 0.05 * rng.normal(size=(F - 1, K, D)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    valids = np.ones((F, K), bool)
    valids[:, 100:] = False
    pairs = tm.sequential_pairs(F, overlap=2)
    np.testing.assert_array_equal(pairs, np.asarray(jm.sequential_pairs(F, overlap=2)))
    mj = jm.match_pairs(jnp.asarray(descs), jnp.asarray(valids), jnp.asarray(pairs),
                        use_pallas=use_pallas)
    mt = tm.match_pairs(_t(descs), _t(valids), pairs, use_pallas=use_pallas)
    assert tuple(mt.idx_b.shape) == (5, K)
    assert mt.valid.sum() > 50
    _same_matches(mj, mt)


def test_match_pairs_routes_agree(rng):
    """The kernel route and the dense route give the same match sets (the
    reference's TestBatchedPallasMatcher, in the port)."""
    F, K, D = 4, 128, 32
    descs = _unit(rng, F, K, D)
    valids = np.ones((F, K), bool)
    valids[:, 100:] = False
    pairs = tm.sequential_pairs(F, overlap=2)
    m_x = tm.match_pairs(_t(descs), _t(valids), pairs, use_pallas=False)
    m_p = tm.match_pairs(_t(descs), _t(valids), pairs, use_pallas=True)
    assert torch.equal(m_x.valid, m_p.valid)
    assert torch.equal(m_x.idx_b[m_x.valid], m_p.idx_b[m_p.valid])


def test_guided_match_pairs_matches_jax(rng):
    """The dead-zone fixture of tests/test_guided_matching.py: repetitive
    descriptors that the global ratio test rejects, recovered in the band."""
    from test_guided_matching import K_MAT, _perturb, _two_view, _unit as gunit

    n, D = 48, 32
    uv1, uv2, E = _two_view(rng, n)
    proto = gunit(rng.normal(size=(4, D))).astype(np.float32)
    desc_a = np.stack([_perturb(proto[i % 4], rng, 0.995) for i in range(n)])
    desc_b = np.stack([_perturb(desc_a[i], rng, 0.99) for i in range(n)])
    descs = np.stack([desc_a, desc_b])
    valids = np.ones((2, n), bool)
    xy = np.stack([uv1, uv2])
    pairs = np.array([[0, 1]], np.int32)
    for kw in ({}, {"band_px": 1.0, "ratio": 0.8, "min_sim": 0.9}):
        mj = jm.guided_match_pairs(jnp.asarray(descs), jnp.asarray(valids), jnp.asarray(xy),
                                   jnp.asarray(pairs), jnp.asarray(E[None]),
                                   jnp.asarray(K_MAT), **kw)
        mt = tm.guided_match_pairs(_t(descs), _t(valids), _t(xy), pairs, _t(E[None]),
                                   _t(K_MAT), **kw)
        assert mt.valid.sum() > 10
        _same_matches(mj, mt)
