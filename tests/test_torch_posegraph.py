"""The port's pose graph (`tpu3drec_torch/sfm/posegraph.py`): the three
tests of tests/test_posegraph.py on the port, and parity with the JAX
package on seeded graphs, with and without a loop closure.

Tolerances (float32 in both packages):
  * residuals, Jacobian-free quantities and the integrated initial poses:
    within 1e-5 absolute;
  * optimized poses of both optimizers and the switches: within 1e-4
    absolute without a closure, 5e-4 with the two closures. The closures
    make the problem stiff: on these graphs the JAX package's own float32
    poses lie up to 1.5e-4 from a float64 run of the same code, the
    port's up to 0.9e-4 (measured with the switchable optimizer, all four
    seeds), so two float32 runs may differ by their sum;
  * per-iteration costs: within 1e-4 of the first iteration's cost at
    every iteration, and the final cost within 1e-4 relative where it is
    not at the float32 floor (a graph without a closure converges to an
    exact fit, whose cost, ~1e-13, is rounding alone). Both packages
    start from the same poses, the odometry chain perturbed, so that the
    graphs without a closure have a cost to remove too (unperturbed, they
    sit at the float32 floor from the start). Each LM step solves
    a normal system whose condition number reaches ~1e7 here (rotation
    weight 10, damping 1e-6), so the float32 products J^T J, summed in a
    different order by XLA and by PyTorch's BLAS, move an intermediate
    iterate by ~1e-6; near the optimum that is a visible share of the cost
    still to be removed (up to 3% of an intermediate cost measured), but
    not of the cost removed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.sfm import posegraph as jpg
from tpu3drec_torch.sfm import posegraph as tpg
from tpu3drec_torch.sfm.posegraph import (
    PoseGraph, _pose_to_matrix, _se3_log, add_loop_closure, edge_residuals,
    make_sequential_edges, optimize_pose_graph, optimize_pose_graph_switchable)

torch.set_num_threads(2)
SEEDS = [0, 1, 2, 3]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


# ---------------------------------------------- tests/test_posegraph.py, on the port

def test_residual_zero_for_consistent_graph(rng):
    F = 5
    poses = np.zeros((F, 6), np.float32)
    poses[:, 3] = np.arange(F)  # translate along x
    poses[:, 1] = 0.05 * np.arange(F)  # slight yaw
    Ts = [_pose_to_matrix(_t(p)).numpy() for p in poses]
    rels = np.stack([_se3_log(_t(np.linalg.inv(Ts[i]) @ Ts[i + 1])).numpy()
                     for i in range(F - 1)]).astype(np.float32)
    g = PoseGraph(poses=_t(poses), edge_i=torch.arange(F - 1), edge_j=torch.arange(1, F),
                  rel=_t(rels), weight=torch.ones(F - 1))
    r = edge_residuals(g.poses, g).numpy()
    assert np.abs(r).max() < 1e-5


def _square(rng):
    """4 sides of a square with 90 degree turns; odometry has noise."""
    rels = []
    for _ in range(4):
        rels.append([0, 0, 0, 1.0, 0, 0])       # forward 1 m
        rels.append([0, 0, np.pi / 2, 0, 0, 0])  # turn 90 degrees
    rels = np.asarray(rels, np.float32)
    return rels + rng.normal(0, 0.02, size=rels.shape).astype(np.float32)


def test_loop_closure_corrects_drift(rng):
    """A square loop with odometry drift: the closure pulls the end home."""
    g = make_sequential_edges(_square(rng), device="cpu")
    end_open = _pose_to_matrix(g.poses[-1]).numpy()[:3, 3]
    g2 = add_loop_closure(g, 0, 8, torch.zeros(6), weight=10.0)
    opt, costs = optimize_pose_graph(g2, iters=20, device="cpu")
    end_closed = _pose_to_matrix(opt[8]).numpy()[:3, 3]
    assert np.linalg.norm(end_closed) < np.linalg.norm(end_open) * 0.3
    assert float(costs[-1]) < float(costs[0])


def test_fixed_node_stays(rng):
    rels = rng.normal(0, 0.1, size=(4, 6)).astype(np.float32)
    g = make_sequential_edges(rels, device="cpu")
    opt, _ = optimize_pose_graph(g, iters=5, device="cpu")
    np.testing.assert_allclose(opt[0].numpy(), g.poses[0].numpy(), atol=1e-7)


# ------------------------------------------------------------- parity with JAX

N = 11  # nodes of the pentagon


def _pentagon(rng):
    """5 sides of a pentagon with 72 degree turns, odometry with noise.
    Its poses stay >= 36 degrees from a half turn: at a rotation of pi the
    log map is singular, and both packages return an axis made of rounding
    (tests/test_posegraph.py's square passes within 7e-4 rad of pi)."""
    rels = []
    for _ in range(5):
        rels.append([0, 0, 0, 1.0, 0, 0])
        rels.append([0, 0, 2 * np.pi / 5, 0, 0, 0])
    rels = np.asarray(rels, np.float32)
    return rels + rng.normal(0, 0.02, size=rels.shape).astype(np.float32)


def _graphs(seed, closure: bool, perturb: bool = True):
    """The noisy pentagon's odometry graph in both packages; with
    ``perturb``, both start from the same poses, the integrated chain
    moved by 0.05 (node 0 stays), so that there is a cost to remove even
    without a closure."""
    rng = np.random.default_rng(seed)
    rels = _pentagon(rng)
    gj = jpg.make_sequential_edges(jnp.asarray(rels))
    gt = make_sequential_edges(rels, device="cpu")
    if perturb:
        poses = np.asarray(gj.poses) + rng.normal(0, 0.05, (N, 6)).astype(np.float32)
        poses[0] = np.asarray(gj.poses[0])
        gj = gj._replace(poses=jnp.asarray(poses))
        gt = gt._replace(poses=_t(poses))
    if closure:
        gj = jpg.add_loop_closure(gj, 0, N - 1, jnp.zeros(6), weight=10.0)
        gt = add_loop_closure(gt, 0, N - 1, torch.zeros(6), weight=10.0)
        # a second, false closure across the loop
        bad = np.array([0, 0, 0.4, 0.5, 0.0, 0.0], np.float32)
        gj = jpg.add_loop_closure(gj, 2, 7, jnp.asarray(bad))
        gt = add_loop_closure(gt, 2, 7, _t(bad))
    return gj, gt


def _pose_tol(closure: bool) -> float:
    return 5e-4 if closure else 1e-4


def _assert_costs(cj, ct):
    cj, ct = np.asarray(cj, np.float64), ct.numpy().astype(np.float64)
    assert cj.shape == ct.shape
    assert np.abs(cj - ct).max() <= 1e-4 * cj[0], (cj, ct)
    if cj[-1] > 1e-6 * cj[0]:  # a residual cost remains (a closure fights the chain)
        assert abs(cj[-1] - ct[-1]) <= 1e-4 * cj[-1], (cj[-1], ct[-1])


@pytest.mark.parametrize("closure", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_graph_and_residuals_match_jax(seed, closure):
    gj, gt = _graphs(seed, closure, perturb=False)
    np.testing.assert_allclose(gt.poses.numpy(), np.asarray(gj.poses), atol=1e-5)
    np.testing.assert_array_equal(gt.edge_i.numpy(), np.asarray(gj.edge_i))
    np.testing.assert_array_equal(gt.edge_j.numpy(), np.asarray(gj.edge_j))
    np.testing.assert_allclose(edge_residuals(gt.poses, gt).numpy(),
                               np.asarray(jpg.edge_residuals(gj.poses, gj)), atol=1e-5)


@pytest.mark.parametrize("rot_weight", [1.0, 10.0])
@pytest.mark.parametrize("closure", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_optimize_pose_graph_matches_jax(seed, closure, rot_weight):
    gj, gt = _graphs(seed, closure)
    oj, cj = jpg.optimize_pose_graph(gj, iters=15, rot_weight=rot_weight)
    ot, ct = optimize_pose_graph(gt, iters=15, rot_weight=rot_weight, device="cpu")
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=_pose_tol(closure))
    _assert_costs(cj, ct)


@pytest.mark.parametrize("rot_weight", [1.0, 10.0])
@pytest.mark.parametrize("closure", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_switchable_matches_jax(seed, closure, rot_weight):
    gj, gt = _graphs(seed, closure)
    E = gt.edge_i.shape[0]
    switch = np.arange(E) >= N - 1  # the closures carry switches
    free = np.ones(N, np.float32)
    free[0] = 0.0
    free[4] = 0.0  # a second frozen node
    oj, sj, cj = jpg.optimize_pose_graph_switchable(
        gj, jnp.asarray(switch), iters=15, rot_weight=rot_weight,
        fix_node_mask=jnp.asarray(free))
    ot, st, ct = optimize_pose_graph_switchable(
        gt, switch, iters=15, rot_weight=rot_weight, fix_node_mask=free, device="cpu")
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=_pose_tol(closure))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=_pose_tol(closure))
    np.testing.assert_array_equal(ot[4].numpy(), gt.poses[4].numpy())
    _assert_costs(cj, ct)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sequential_edges(np.zeros((2, 6), np.float32))
    g = make_sequential_edges(np.zeros((2, 6), np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize_pose_graph(g, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpg.optimize_pose_graph_switchable(g, np.zeros(2, bool), iters=1)
