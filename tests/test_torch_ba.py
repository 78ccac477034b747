"""Parity of the port's bundle adjustment and BA-blocks kernel
(`tpu3drec_torch/sfm/ba.py`, `tpu3drec_torch/ops/ba_blocks.py`) with the JAX
package on the CPU, on the problems of tests/test_ba.py.

Tolerances: residuals and per-observation Jacobians within 1e-5 of each
array's largest magnitude (XLA fuses multiply-adds, PyTorch does not);
``ba_solve``'s initial cost within 1e-6 and final cost within 1e-3 relative
on problems whose optimum lies above float32 noise (1 px / 0.5 px noise);
``ba_blocks_plain`` against the Pallas kernel in interpret mode within 1e-5
of each observation's largest block entry, and against the autodiff
reference within the reference test's own tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.ops.ba_blocks import ba_blocks as jba_blocks
from tpu3drec.sfm import ba as jba
from tpu3drec_torch.ops import ba_blocks
from tpu3drec_torch.sfm import ba

from test_ba import _make_problem


def _port(p):
    return ba.BAProblem.from_numpy(
        *(np.asarray(x) for x in p[:7]), depth=None if p.depth is None else np.asarray(p.depth),
        depth_weight=p.depth_weight, device="cpu")


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _with_depth(p):
    cams = np.asarray(p.cam_params)
    R = np.asarray(jba.axis_angle_to_matrix(jnp.asarray(cams[:, :3])))
    ci, pi = np.asarray(p.cam_idx), np.asarray(p.pt_idx)
    z = np.einsum("oj,oj->o", R[ci][:, 2], np.asarray(p.points)[pi]) + cams[ci, 5]
    z[::7] = 0.0  # rows without depth
    return p._replace(depth=jnp.asarray(z.astype(np.float32)), depth_weight=5.0)


@pytest.mark.parametrize("depth", [False, True])
def test_residuals_and_jacobians_match_jax(depth, rng):
    prob, _, _ = _make_problem(rng, F=4, L=50, noise_px=0.5, perturb=0.01)
    if depth:
        prob = _with_depth(prob)
    tp = _port(prob)
    _close(ba.residuals(tp).numpy(), jba.residuals(prob))
    Jc, Jp = jba._obs_jacobians(prob)
    tJc, tJp = ba._obs_jacobians(tp)
    _close(tJc.numpy(), Jc)
    _close(tJp.numpy(), Jp)
    r = ba.residuals(tp)
    np.testing.assert_allclose(ba.huber_weights(r, 2.0).numpy(),
                               np.asarray(jba.huber_weights(jnp.asarray(r.numpy()), 2.0)),
                               rtol=1e-6)


SOLVES = {
    # name: (problem kwargs, solve kwargs, depth)
    "noise": (dict(noise_px=0.5, perturb=0.005), dict(max_lm_iters=25, cg_iters=30), False),
    "outliers": (dict(noise_px=1.0, perturb=0.005, outlier_frac=0.05),
                 dict(max_lm_iters=30, cg_iters=30), False),
    "depth": (dict(F=4, L=60, noise_px=1.0, perturb=0.005), dict(max_lm_iters=8, cg_iters=15),
              True),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_ba_solve_matches_jax(name, rng):
    pkw, skw, depth = SOLVES[name]
    prob, _, _ = _make_problem(rng, **pkw)
    if depth:
        prob = _with_depth(prob)
    rj = jba.ba_solve(prob, **skw)
    rt = ba.ba_solve(_port(prob), **skw)
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-6)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-3)
    assert float(rt.final_cost) < float(rt.initial_cost)
    # the gauge-fixed camera stays put
    np.testing.assert_array_equal(rt.cam_params[0].numpy(), np.asarray(prob.cam_params)[0])


def test_ba_recovers_from_perturbation(rng):
    """tests/test_ba.py::test_ba_recovers_from_perturbation on the port."""
    prob, gt_cams, _ = _make_problem(rng, perturb=0.01)
    tp = _port(prob)
    assert ba.residuals(tp).abs().mean() > 1.0
    res = ba.ba_solve(tp, max_lm_iters=25, cg_iters=30)
    assert float(res.final_cost) < float(res.initial_cost) * 1e-4
    r1 = ba.residuals(tp._replace(cam_params=res.cam_params, points=res.points))
    assert r1.abs().mean() < 1e-2
    np.testing.assert_allclose(res.cam_params[0].numpy(), gt_cams[0], atol=1e-6)


def test_depth_prior_fixes_scale(rng):
    """tests/test_ba.py::test_depth_prior_fixes_scale on the port."""
    prob, _, _ = _make_problem(rng, F=4, L=80)
    full = _with_depth(prob)
    z = np.asarray(full.depth)
    keep = z > 0
    cams = np.asarray(prob.cam_params)
    s = 0.7
    shrunk = _port(full._replace(
        cam_params=jnp.asarray(np.concatenate([cams[:, :3], cams[:, 3:] * s], axis=1)),
        points=jnp.asarray(np.asarray(prob.points) * s)))
    res = ba.ba_solve(shrunk, max_lm_iters=30, cg_iters=30)
    R = ba.axis_angle_to_matrix(res.cam_params[:, :3])[shrunk.cam_idx]
    Xc = torch.einsum("oij,oj->oi", R, res.points[shrunk.pt_idx]) \
        + res.cam_params[shrunk.cam_idx, 3:]
    z_new = Xc[:, 2].numpy()
    assert np.median(np.abs(z_new[keep] - z[keep]) / z[keep]) < 0.02


def test_lm_early_exit_gates_iterations():
    rng = np.random.default_rng(0)
    prob, _, _ = _make_problem(rng)
    res = ba.ba_solve(_port(prob), max_lm_iters=40, cg_iters=10)
    assert res.n_iters <= 5, res.n_iters
    prob2, _, _ = _make_problem(rng, perturb=0.02)
    res2 = ba.ba_solve(_port(prob2), max_lm_iters=40, cg_iters=15)
    assert float(res2.final_cost) < 1e-2 * float(res2.initial_cost)
    assert res2.n_iters < 40


def test_block_path_converges_like_jacfwd(rng):
    """tests/test_ba.py::test_pallas_blocks_path_converges_like_jacfwd on the
    port: the BA-blocks route (its plain version on the CPU) with the
    manifold update reaches the jacfwd path's quality."""
    prob, _, _ = _make_problem(rng, F=5, L=80, perturb=0.008)
    tp = _port(prob)
    res_ref = ba.ba_solve(tp, max_lm_iters=20, cg_iters=25)
    res_blk = ba.ba_solve(tp, max_lm_iters=20, cg_iters=25, use_pallas_blocks=True)
    r_ref = ba.residuals(tp._replace(cam_params=res_ref.cam_params,
                                     points=res_ref.points)).abs().mean()
    r_blk = ba.residuals(tp._replace(cam_params=res_blk.cam_params,
                                     points=res_blk.points)).abs().mean()
    assert r_blk < 1e-2, r_blk
    assert r_blk < max(10 * r_ref, 1e-3)
    # and against the JAX block path on a problem with noise
    prob, _, _ = _make_problem(rng, F=5, L=80, noise_px=1.0, perturb=0.008)
    rj = jba.ba_solve(prob, max_lm_iters=12, cg_iters=20, use_pallas_blocks=True)
    rt = ba.ba_solve(_port(prob), max_lm_iters=12, cg_iters=20, use_pallas_blocks=True)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-3)
    with pytest.raises(ValueError):
        ba.ba_solve(_port(_with_depth(prob)), use_pallas_blocks=True)


def _blocks_inputs(rng, O):
    from scipy.spatial.transform import Rotation as ScipyR

    K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]], np.float32)
    Rm = ScipyR.from_rotvec(rng.normal(size=(O, 3)) * 0.3).as_matrix().astype(np.float32)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], size=(O, 3)).astype(np.float32)
    t = rng.normal(size=(O, 3)).astype(np.float32) * 0.1
    Xc = np.einsum("oij,oj->oi", Rm, X) + t
    Xc[:, 2] = np.abs(Xc[:, 2]) + 3.0
    Xc[0] = [1e-12, -1e-12, 0.0]  # the z clamp, with finite blocks
    uv = rng.uniform([0, 0], [640, 480], size=(O, 2)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=O).astype(np.float32)
    return K, Rm, Xc.astype(np.float32), uv, w


@pytest.mark.parametrize("O", [1, 100, 513])
def test_ba_blocks_plain_matches_pallas(O, rng):
    K, Rm, Xc, uv, w = _blocks_inputs(rng, O)
    out_j = jba_blocks(*(jnp.asarray(x) for x in (Xc, Rm, uv, w, K)))
    out_t = ba_blocks.ba_blocks(*(torch.tensor(x) for x in (Xc, Rm, uv, w)),
                                ba_blocks.intrinsics_of(K))
    assert sorted(out_t) == sorted(out_j)
    for key in out_t:
        got, want = out_t[key].numpy(), np.asarray(out_j[key])
        assert got.shape == want.shape, key
        # per observation, within 1e-5 of its largest entry in that block
        scale = np.abs(want.reshape(O, -1)).max(1) + 1e-30
        err = np.abs(got - want).reshape(O, -1).max(1)
        assert (err <= 1e-5 * scale).all(), (key, (err / scale).max())


def test_ba_blocks_plain_matches_autodiff(rng):
    K, Rm, Xc, uv, w = _blocks_inputs(rng, 100)
    Xc[0] = [0.5, -0.5, 5.0]  # the clamp has no derivative to compare
    t = [torch.tensor(x) for x in (Xc, Rm, uv, w)]
    out = ba_blocks.ba_blocks_plain(*t, ba_blocks.intrinsics_of(K))
    Jc, Jp = ba_blocks.local_jacobians_reference(t[0], t[1], t[2], torch.tensor(K))
    Jc_j, Jp_j = Jc.numpy(), Jp.numpy()
    np.testing.assert_allclose(out["Jc"].numpy(), Jc_j, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(out["Jp"].numpy(), Jp_j, rtol=1e-5, atol=1e-3)
    U_ref = np.einsum("o,oia,oib->oab", w, Jc_j, Jc_j)
    W_ref = np.einsum("o,oia,oib->oab", w, Jc_j, Jp_j)
    np.testing.assert_allclose(out["U"].numpy(), U_ref, rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(out["W"].numpy(), W_ref, rtol=2e-3, atol=2e-2)
    from tpu3drec.ops.ba_blocks import local_jacobians_reference as jref

    Jc_r, Jp_r = jref(*(jnp.asarray(x) for x in (Xc, Rm, uv, K)))
    np.testing.assert_allclose(Jc_j, np.asarray(Jc_r), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(Jp_j, np.asarray(Jp_r), rtol=1e-5, atol=1e-3)


def test_ba_blocks_cuda_wrapper_refuses_cpu(rng):
    K, Rm, Xc, uv, w = _blocks_inputs(rng, 4)
    with pytest.raises(ValueError):
        ba_blocks.ba_blocks_cuda(*(torch.tensor(x) for x in (Xc, Rm, uv, w)), (1, 1, 0, 0))


@pytest.mark.parametrize("O", [1, 3, 511, 513])
def test_ba_blocks_output_layout(O, rng):
    """The kernel's one output buffer: eight regions in the plain version's
    order and shapes, each on a 16-byte boundary, none overlapping, and no
    more padding between them than the alignment needs."""
    regions, total = ba_blocks.output_layout(O)
    K, Rm, Xc, uv, w = _blocks_inputs(rng, O)
    plain = ba_blocks.ba_blocks_plain(*(torch.tensor(x) for x in (Xc, Rm, uv, w)),
                                      ba_blocks.intrinsics_of(K))
    assert [key for key, *_ in regions] == list(plain)
    end = 0
    for key, off, k, shape in regions:
        assert shape == tuple(plain[key].shape), key
        assert k * O == plain[key].numel(), key
        assert (4 * off) % 16 == 0, key
        assert end <= off < end + ba_blocks.ALIGN, key
        end = off + k * O
    assert total == end
    assert total - sum(k * O for _, _, k, _ in regions) < 8 * ba_blocks.ALIGN


def test_ba_blocks_count_guard():
    """The kernel takes the count as a C int and forms 64-bit offsets: a
    count past that int is refused, and one past the old 32-bit offset
    limit (36 O < 2^31) is taken, though its layout reaches past 2^31."""
    ba_blocks.check_count(ba_blocks.MAX_OBS)
    with pytest.raises(ValueError):
        ba_blocks.check_count(ba_blocks.MAX_OBS + 1)
    O = 60_000_000
    assert 36 * O >= 2**31
    ba_blocks.check_count(O)
    regions, total = ba_blocks.output_layout(O)
    assert max(off + k * O for _, off, k, _ in regions) == total > 2**31


@pytest.mark.parametrize("O", [1, 31, 33, 256, 257, 65_536, 262_144, 10**7])
def test_ba_blocks_grid_covers_every_tile(O):
    """The grid-stride launch: at least one block, at most WAVES waves of
    the card's slots, and fewer blocks than the tiles need only then."""
    sms, per_sm = 132, 6
    cap = ba_blocks.WAVES * sms * per_sm
    blocks = ba_blocks.grid_blocks(O, sms, per_sm)
    tiles = -(-O // ba_blocks.TILE)
    assert 1 <= blocks <= cap
    assert blocks * ba_blocks.WARPS >= tiles or blocks == cap
    assert (blocks - 1) * ba_blocks.WARPS < tiles
