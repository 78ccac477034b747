"""Parity of the port's bundle adjustment and BA-blocks kernel
(`tpu3drec_torch/sfm/ba.py`, `tpu3drec_torch/ops/ba_blocks.py`) with the JAX
package on the CPU, on the problems of tests/test_ba.py; and, on a card
(marker `gpu`), the LM loop replayed from a CUDA graph against the eager
loop on the same card.

Tolerances: residuals and per-observation Jacobians within 1e-5 of each
array's largest magnitude (XLA fuses multiply-adds, PyTorch does not);
``ba_solve``'s initial cost within 1e-6 and final cost within 1e-3 relative
on problems whose optimum lies above float32 noise (1 px / 0.5 px noise);
``ba_blocks_plain`` against the Pallas kernel in interpret mode within 1e-5
of each observation's largest block entry, and against the autodiff
reference within the reference test's own tolerances. Graph against eager
on the card: the same iterations, and costs and parameters bit-equal or
within 1e-6 of each array's largest magnitude, under PyTorch's
deterministic algorithms. Without them the segment sums' atomic adds
order differently from one run to the next, and two eager runs differ by
up to ~2e-5 and may stop after other iteration counts; there the graph's
final cost is held to the eager loop's within the JAX parity's 1e-3.

The card has no JAX: there the `gpu` tests run alone, as
``PYTHONPATH=. python -m pytest --noconftest -m gpu tests/test_torch_ba.py``,
on problems made by `_make_problem_np` (tests/test_ba.py's scenes, drawn
from the generator in the same order, without JAX).
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyR

from tpu3drec_torch.ops import ba_blocks
from tpu3drec_torch.sfm import ba
from tpu3drec_torch.utils import tracing

try:  # on the CPU the port is held against the JAX package; the card has none
    import jax.numpy as jnp

    from tpu3drec.ops.ba_blocks import ba_blocks as jba_blocks
    from tpu3drec.sfm import ba as jba

    from test_ba import _make_problem
except ImportError:
    jnp = jba = jba_blocks = _make_problem = None


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


# --- the LM loop as a replayed CUDA graph (`ba.py::_solve_graphed`) ---------

K_NP = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _make_problem_np(rng, device, F=6, L=120, noise_px=0.0, perturb=0.0, outlier_frac=0.0):
    """tests/test_ba.py::_make_problem without JAX, drawing from ``rng`` in
    the same order, as a port problem on ``device``."""
    X = rng.uniform([-2, -2, 6], [2, 2, 12], size=(L, 3)).astype(np.float32)
    cams = []
    for f in range(F):
        angle = 0.08 * (f - F / 2)
        Rm = ScipyR.from_rotvec([0, angle, 0]).as_matrix()
        t = np.array([-1.5 * angle * 8, 0.02 * f, 0.05 * f])
        cams.append((Rm.astype(np.float32), t.astype(np.float32)))
    uvs = []
    for Rm, t in cams:
        Xc = X @ Rm.T + t
        uv = Xc[:, :2] / Xc[:, 2:3]
        uvs.append(uv * [K_NP[0, 0], K_NP[1, 1]] + [K_NP[0, 2], K_NP[1, 2]])
    cam_idx = np.repeat(np.arange(F), L)
    pt_idx = np.tile(np.arange(L), F)
    uv = np.concatenate(uvs).astype(np.float32)
    if noise_px:
        uv += rng.normal(0, noise_px, size=uv.shape).astype(np.float32)
    O = F * L
    if outlier_frac:
        n_out = int(outlier_frac * O)
        idx = rng.permutation(O)[:n_out]
        uv[idx] += rng.uniform(30, 120, size=(n_out, 2)).astype(np.float32)
    aa = ba.matrix_to_axis_angle(torch.as_tensor(np.stack([Rm for Rm, _ in cams]))).numpy()
    cam_params = np.concatenate([aa, np.stack([t for _, t in cams])], 1).astype(np.float32)
    points = X.copy()
    if perturb:
        cam_params = cam_params + np.concatenate(
            [np.zeros((1, 6)), rng.normal(0, perturb, size=(F - 1, 6))]).astype(np.float32)
        points = X + rng.normal(0, perturb * 10, size=X.shape).astype(np.float32)
    return ba.BAProblem.from_numpy(cam_params, points, cam_idx, pt_idx, uv,
                                   np.ones(O, np.float32), K_NP, device=device)


def _with_depth_t(p):
    """`_with_depth` on a port problem: the true z of each observation,
    every seventh left out."""
    R = ba.axis_angle_to_matrix(p.cam_params[:, :3])[p.cam_idx]
    z = torch.einsum("oj,oj->o", R[:, 2], p.points[p.pt_idx]) + p.cam_params[p.cam_idx, 5]
    z[::7] = 0.0
    return p._replace(depth=z, depth_weight=5.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def deterministic(monkeypatch):
    """PyTorch's deterministic algorithms in scope: `index_add_` on the card
    sums through a sort instead of atomic adds, so that a solve repeats bit
    for bit (cuBLAS takes the workspace setting that mode asks for)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def _fresh_graphs():
    """An empty graph cache for this thread: the next solve captures."""
    ba._graph_state.__dict__.clear()


def _traced_solve(p, **kw):
    """(result, the ``ba.solve`` span's counters)."""
    tracing.drain()
    tracing.enable()
    try:
        res = ba.ba_solve(p, **kw)
    finally:
        tracing.disable()
    (solve,) = [s for s in tracing.drain() if s.name == "ba.solve"]
    return res, solve.counters


def _eager(monkeypatch, p, **kw):
    with monkeypatch.context() as m:
        m.setattr(ba, "_graphed", lambda p, mesh: False)
        return _traced_solve(p, **kw)


def _agreement(got, want) -> str:
    """How a solve agrees with the eager one: "bit-equal", or else "within
    1e-6" (asserted) of each array's largest magnitude, over the parameters
    and both costs, after the same iterations."""
    assert got.n_iters == want.n_iters
    pairs = [(getattr(got, k), getattr(want, k))
             for k in ("cam_params", "points", "initial_cost", "final_cost")]
    if all(torch.equal(a, b) for a, b in pairs):
        return "bit-equal"
    for a, b in pairs:
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale, (a, b)
    return "within 1e-6"


GRAPH_SOLVES = dict(SOLVES, blocks=(dict(noise_px=0.5, perturb=0.005),
                                    dict(max_lm_iters=25, cg_iters=30, use_pallas_blocks=True),
                                    False))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GRAPH_SOLVES))
def test_graph_path_equals_eager_on_the_card(name, monkeypatch, deterministic):
    """A miss (the first iteration eager, then one capture and replays) and
    a hit (every iteration a replay) give the eager loop's answer; the
    profiler's trace holds every run of the BA-blocks kernel, replays
    included (none off the block path), and the module's count agrees."""
    dev = _card()
    pkw, skw, depth = GRAPH_SOLVES[name]
    p = _make_problem_np(np.random.default_rng(0), dev, **pkw)
    if depth:
        p = _with_depth_t(p)
    from torch.profiler import ProfilerActivity, profile

    _fresh_graphs()
    want, c_eager = _eager(monkeypatch, p, **skw)
    assert c_eager["ba.graph_replays"] == c_eager["ba.graph_captures"] == 0
    ba_blocks.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        miss, c_miss = _traced_solve(p, **skw)
        hit, c_hit = _traced_solve(p, **skw)
        torch.cuda.synchronize()
    n = want.n_iters
    assert n > 1 and c_miss["ba.lm_iters"] == c_hit["ba.lm_iters"] == n
    assert (c_miss["ba.graph_captures"], c_miss["ba.graph_replays"]) == (1, n - 1)
    assert (c_hit["ba.graph_captures"], c_hit["ba.graph_replays"]) == (0, n)
    # the kernel's runs on the card, replays included, and the module's count
    runs = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "ba_blocks_kernel" in e.name)
    blocks = 2 * n if skw.get("use_pallas_blocks") else 0
    assert runs == ba_blocks.launches == blocks, (runs, ba_blocks.launches, blocks)
    print(f"graph vs eager, {name}: miss {_agreement(miss, want)}, "
          f"hit {_agreement(hit, want)}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GRAPH_SOLVES))
def test_graph_path_converges_like_eager_on_the_card(name, monkeypatch):
    """With atomic segment sums (the default): the graph's final cost within
    1e-3 of the eager loop's, every iteration after the first replayed."""
    dev = _card()
    pkw, skw, depth = GRAPH_SOLVES[name]
    p = _make_problem_np(np.random.default_rng(0), dev, **pkw)
    if depth:
        p = _with_depth_t(p)
    _fresh_graphs()
    want, _ = _eager(monkeypatch, p, **skw)
    got, c = _traced_solve(p, **skw)
    assert c["ba.graph_replays"] == got.n_iters - 1 and c["ba.graph_captures"] == 1
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-3)
    assert float(got.final_cost) < float(got.initial_cost)


@pytest.mark.gpu
def test_cached_graph_takes_the_new_problem_s_values(monkeypatch, deterministic):
    """A second problem of the same shapes, with its own observations,
    points, mask and damping, replays the first one's graph and gives its
    own eager answer: no static buffer keeps the first problem's values."""
    dev = _card()
    a = _make_problem_np(np.random.default_rng(1), dev, noise_px=0.5, perturb=0.005)
    b = _make_problem_np(np.random.default_rng(2), dev, noise_px=1.0, perturb=0.008,
                         outlier_frac=0.05)
    b = b._replace(weight=torch.where(torch.arange(b.weight.shape[0], device=dev) % 5 == 0,
                                      0.0, 1.0))
    mask_a = torch.ones((6, 6), device=dev)
    mask_a[0] = 0.0
    mask_b = mask_a.clone()
    mask_b[1, 3] = 0.0
    kw = dict(max_lm_iters=12, cg_iters=20)
    _fresh_graphs()
    _, c_a = _traced_solve(a, fix_cam_mask=mask_a, **kw)
    assert c_a["ba.graph_captures"] == 1
    got, c_b = _traced_solve(b, fix_cam_mask=mask_b, init_lambda=1e-2, **kw)
    assert c_b["ba.graph_captures"] == 0 and c_b["ba.graph_replays"] == got.n_iters
    want, _ = _eager(monkeypatch, b, fix_cam_mask=mask_b, init_lambda=1e-2, **kw)
    print(f"cached graph, new values: {_agreement(got, want)}")
    assert torch.equal(got.cam_params[1, 3], b.cam_params[1, 3])


@pytest.mark.gpu
def test_threads_keep_graphs_of_their_own_on_the_card(monkeypatch, deterministic):
    """Twelve threads (more than the card machine's cores) solve problems of
    one shape at once, twice each: every thread captures into its own cache
    and pool, and every answer is its own problem's eager answer."""
    import sys
    import threading

    dev = _card()
    n, kw = 12, dict(max_lm_iters=6, cg_iters=10)
    probs = [_make_problem_np(np.random.default_rng(100 + i), dev, F=5, L=80, noise_px=0.5,
                              perturb=0.005) for i in range(n)]
    with monkeypatch.context() as m:
        m.setattr(ba, "_graphed", lambda p, mesh: False)
        want = [ba.ba_solve(p, **kw) for p in probs]
    got, errors = [None] * n, []

    def work(i):
        try:
            got[i] = [ba.ba_solve(probs[i], **kw) for _ in range(2)]
            got[i].append(len(ba._graph_state.cache))
        except Exception as e:  # reported below, with the thread that raised
            errors.append((i, repr(e)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in range(n):
        miss, hit, cached = got[i]
        assert cached == 1
        assert _agreement(miss, want[i]) == _agreement(hit, want[i]) == "bit-equal", i


@pytest.mark.gpu
def test_evicted_graphs_free_their_memory_on_the_card(monkeypatch, deterministic):
    """A cache of two graphs over four problem sizes, three times round:
    every solve misses, captures into the thread's one pool and evicts the
    least recently used graph; every answer is the eager one. After each
    round the memory in use is the same (an evicted graph's static tensors
    are freed) and so is the memory the allocator reserves from the card
    (what an evicted graph held in the pool is reused, not added to)."""
    dev = _card()
    kw = dict(max_lm_iters=4, cg_iters=10)
    probs = [_make_problem_np(np.random.default_rng(i), dev, F=4, L=L, noise_px=0.5,
                              perturb=0.005) for i, L in enumerate((40, 50, 60, 70))]
    with monkeypatch.context() as m:
        m.setattr(ba, "_graphed", lambda p, mesh: False)
        want = [ba.ba_solve(p, **kw) for p in probs]
    _fresh_graphs()
    ba._graph_state.__dict__.update(cache=ba.GraphCache(size=2), pools={})
    held, reserved = [], []
    for _ in range(3):
        for p, w in zip(probs, want):
            got, c = _traced_solve(p, **kw)
            assert c["ba.graph_captures"] == 1 and _agreement(got, w) == "bit-equal"
            del got
        assert len(ba._graph_state.cache) == 2
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(dev))
        reserved.append(torch.cuda.memory_reserved(dev))
    assert held[0] == held[1] == held[2], held
    assert reserved[0] == reserved[1] == reserved[2], reserved


@pytest.mark.gpu
def test_lm_early_exit_on_the_card():
    """test_lm_early_exit_gates_iterations on the card, through the graph
    path: a problem at its optimum stops within a few iterations, and a
    loop that ends at the first (eager) iteration captures nothing."""
    dev = _card()
    rng = np.random.default_rng(0)
    _fresh_graphs()
    res, c = _traced_solve(_make_problem_np(rng, dev), max_lm_iters=40, cg_iters=10)
    assert res.n_iters <= 5, res.n_iters
    assert c["ba.graph_captures"] == (res.n_iters > 1)
    _fresh_graphs()  # a loop that ends at its cap after the warm-up captures nothing
    _, c = _traced_solve(_make_problem_np(np.random.default_rng(0), dev, perturb=0.02),
                         max_lm_iters=1, cg_iters=10)
    assert (c["ba.lm_iters"], c["ba.graph_captures"], c["ba.graph_replays"]) == (1, 0, 0)
    res2, _ = _traced_solve(_make_problem_np(rng, dev, perturb=0.02), max_lm_iters=40,
                            cg_iters=15)
    assert float(res2.final_cost) < 1e-2 * float(res2.initial_cost)
    assert res2.n_iters < 40


@pytest.mark.gpu
def test_one_host_read_an_iteration_on_the_card():
    """A profiled solve that replays a cached graph copies to the host once
    an iteration, the stop flag, and never from inside a replay."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    p = _make_problem_np(np.random.default_rng(0), dev, noise_px=0.5, perturb=0.005)
    kw = dict(max_lm_iters=8, cg_iters=15)
    _fresh_graphs()
    ba.ba_solve(p, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = ba.ba_solve(p, **kw)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_device = [e for e in events if str(e.device_type()).endswith("CUDA")]
    launcher = {e.correlation_id(): e.name() for e in events
                if not str(e.device_type()).endswith("CUDA") and e.name().startswith("cuda")}
    reads = [e for e in on_device if e.name().startswith("Memcpy DtoH")]
    assert len(reads) == res.n_iters == 8
    assert all(launcher.get(e.correlation_id()) != "cudaGraphLaunch" for e in reads)
    replayed = [e for e in on_device if launcher.get(e.correlation_id()) == "cudaGraphLaunch"]
    assert replayed, "the profiler saw no kernel of a replay"


def test_cpu_solve_takes_the_eager_loop(rng):
    """On the CPU nothing is captured: both graph counters read 0 and this
    thread has no graph cache."""
    _fresh_graphs()
    p = _make_problem_np(rng, "cpu", F=4, L=40, noise_px=0.5, perturb=0.005)
    res, c = _traced_solve(p, max_lm_iters=4, cg_iters=8)
    assert c == {"ba.lm_iters": res.n_iters, "ba.graph_replays": 0, "ba.graph_captures": 0}
    assert "cache" not in ba._graph_state.__dict__


def test_graph_key_fixes_the_captured_work(rng):
    """Values leave the key as it is; each thing that fixes the captured
    work (sizes, depth prior and its weight, Jacobian path and the kernel's
    intrinsics, PCG steps, Huber threshold, mask shape, dtype, device,
    TF32) changes it."""
    p = _make_problem_np(rng, "cpu", F=4, L=40)
    free = torch.ones((4, 6))
    base = dict(cam_free=free, cg_iters=15, huber_px=2.0, use_pallas_blocks=False, intr=None)

    def key(q=p, **kw):
        return ba.graph_key(q, **{**base, **kw})

    other = _make_problem_np(np.random.default_rng(9), "cpu", F=4, L=40, noise_px=1.0,
                             perturb=0.01)
    assert key() == key(other) == key(cam_free=torch.zeros((4, 6)))
    depth = _with_depth_t(p)
    variants = [
        key(_make_problem_np(rng, "cpu", F=4, L=41)),                 # L (and O)
        key(p._replace(cam_params=torch.cat([p.cam_params, p.cam_params[:1]]))),  # F
        key(p._replace(uv=p.uv[:-1])),                                 # O
        key(depth), key(depth._replace(depth_weight=2.0)),
        key(use_pallas_blocks=True, intr=(500.0, 500.0, 320.0, 240.0)),
        key(use_pallas_blocks=True, intr=(510.0, 500.0, 320.0, 240.0)),
        key(cg_iters=30), key(huber_px=3.0), key(cam_free=torch.ones((4, 1))),
        key(p._replace(cam_params=p.cam_params.double())),
        key(p._replace(cam_params=p.cam_params.to("meta"))),
    ]
    assert len({key(), *variants}) == len(variants) + 1
    saved, k0 = torch.backends.cuda.matmul.allow_tf32, key()
    torch.backends.cuda.matmul.allow_tf32 = not saved
    try:
        assert key() != k0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _Entry:
    """A cache entry that holds nothing."""


def test_graph_cache_evicts_the_least_recently_used():
    """The least recently used entry goes first, and nothing keeps it."""
    import gc
    import weakref

    cache = ba.GraphCache(size=3)
    made = {k: _Entry() for k in "abcde"}
    alive = {k: weakref.ref(e) for k, e in made.items()}
    for k in "abc":
        cache.put(k, made.pop(k))
    assert cache.get("a") is alive["a"]()      # a is now the most recent
    assert cache.get("z") is None
    cache.put("d", made.pop("d"))              # evicts b
    gc.collect()
    assert alive["b"]() is None and len(cache) == 3
    cache.put("e", made.pop("e"))              # evicts c
    gc.collect()
    assert alive["c"]() is None
    assert [k for k in "abcde" if cache.get(k) is not None] == ["a", "d", "e"]
    assert ba.GraphCache().size == ba.GRAPH_CACHE_SIZE
