"""Pose-graph optimization over keyframe poses (port of
`tpu3drec/sfm/posegraph.py`).

Loop closures become relative-pose edges and the graph is optimized
directly: Levenberg-Marquardt on se(3) with the residual
r_ij = Log(T_ij^-1 T_i^-1 T_j) per edge. All edges are evaluated in one
batched pass, the Jacobian comes from ``torch.func.jacfwd``, and the dense
(6F x 6F) normal system is solved directly: a few hundred keyframes make a
small matrix. The accept/reject test and the damping update stay on the
device (``torch.where``), so an iteration reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from tpu3drec_torch.core.se3 import axis_angle_to_matrix, matrix_to_axis_angle
from tpu3drec_torch.utils.device import FORWARD_AD_LOCK, resolve_device


def _se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twists (..., 6) [rot|trans] -> (..., 4, 4): rotation by
    Rodrigues, translation applied directly (the first-order coupling of
    the reference, exact at convergence)."""
    top = torch.cat([axis_angle_to_matrix(xi[..., :3]), xi[..., 3:, None]], dim=-1)
    bottom = torch.zeros(xi.shape[:-1] + (1, 4), dtype=xi.dtype, device=xi.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _se3_log(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([matrix_to_axis_angle(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def _pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    return _se3_exp(pose)


class PoseGraph(NamedTuple):
    poses: torch.Tensor    # (F, 6) [axis-angle | t]
    edge_i: torch.Tensor   # (E,) int64 source node
    edge_j: torch.Tensor   # (E,) int64 target node
    rel: torch.Tensor      # (E, 6) measured relative pose: T_ij ~ T_i^-1 T_j
    weight: torch.Tensor   # (E,) edge weights (0 = padding)

    def to(self, device) -> "PoseGraph":
        dev = resolve_device(device)
        return PoseGraph(self.poses.to(dev, torch.float32), self.edge_i.to(dev, torch.int64),
                         self.edge_j.to(dev, torch.int64), self.rel.to(dev, torch.float32),
                         self.weight.to(dev, torch.float32))


def edge_residuals(poses: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """(E, 6) residuals Log(T_ij^-1 T_i^-1 T_j)."""
    Ti = _pose_to_matrix(poses[g.edge_i])
    Tj = _pose_to_matrix(poses[g.edge_j])
    Tij = _pose_to_matrix(g.rel)
    M = torch.linalg.inv(Tij) @ torch.linalg.inv(Ti) @ Tj
    return _se3_log(M)


def _lm(r_of, flat0, free, iters: int, damping: float, post=None):
    """Levenberg-Marquardt with adaptive lambda and accept/reject, every
    decision on the device. ``post`` maps a candidate state before it is
    scored. Returns (state, per-iteration cost (iters,))."""
    n = flat0.shape[0]
    eye = torch.eye(n, dtype=flat0.dtype, device=flat0.device)
    flat = flat0
    lam = torch.tensor(1e-4, dtype=flat0.dtype, device=flat0.device)
    cost = torch.sum(r_of(flat) ** 2)
    costs = []
    for _ in range(iters):
        r = r_of(flat)
        with FORWARD_AD_LOCK:
            J = jacfwd(r_of)(flat) * free[None, :]
        H = J.T @ J
        H = H + lam * torch.diag(torch.diagonal(H)) + damping * eye
        delta = -torch.linalg.solve(H, J.T @ r) * free
        cand = flat + delta
        if post is not None:
            cand = post(cand)
        new_cost = torch.sum(r_of(cand) ** 2)
        accept = new_cost < cost
        flat = torch.where(accept, cand, flat)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 10.0, max=1e8))
        cost = torch.where(accept, new_cost, cost)
        costs.append(cost)
    return flat, torch.stack(costs) if costs else flat.new_zeros(0)


def _free_mask(fix_node_mask, F: int, dtype, device):
    if fix_node_mask is None:
        fix_node_mask = torch.cat([torch.zeros(1), torch.ones(F - 1)])
    return torch.repeat_interleave(torch.as_tensor(fix_node_mask, dtype=dtype, device=device), 6)


def optimize_pose_graph(g: PoseGraph, iters: int = 15, damping: float = 1e-6,
                        fix_node_mask=None, rot_weight: float = 1.0, device=None):
    """Pose-graph optimization, node 0 fixed by default, on ``device``
    (None means the card). ``rot_weight`` scales the rotation rows of every
    residual against translation: relative rotations are measured far more
    precisely than translations, and a rotation error acts through lever
    arms. Returns (optimized poses (F, 6), per-iteration cost (iters,))."""
    g = g.to(device)
    F = g.poses.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    free = _free_mask(fix_node_mask, F, dt, dev)
    r_scale = torch.cat([torch.full((3,), rot_weight, dtype=dt, device=dev),
                         torch.ones(3, dtype=dt, device=dev)])
    sw = torch.sqrt(torch.clamp(g.weight, min=0.0))[:, None]

    def r_of(flat):
        return (edge_residuals(flat.reshape(F, 6), g) * sw * r_scale[None, :]).reshape(-1)

    flat, costs = _lm(r_of, g.poses.reshape(-1), free, iters, damping)
    return flat.reshape(F, 6), costs


def optimize_pose_graph_switchable(g: PoseGraph, switch_mask, iters: int = 15,
                                   damping: float = 1e-6, switch_prior: float = 10.0,
                                   rot_weight: float = 1.0, fix_node_mask=None, device=None):
    """Pose-graph optimization with switchable constraints (Sünderhauf &
    Protzel, IROS 2012): each edge of ``switch_mask`` has its residual
    scaled by a variable s in [0, 1], optimized jointly with the poses,
    plus a prior residual sqrt(switch_prior) (1 - s). A true closure's
    drift spreads cheaply over the odometry chain and its switch stays at
    1; a false closure can only be met by bending a short subchain, so its
    switch collapses and the edge pays the bounded prior instead.
    ``fix_node_mask`` (F,): 1 free, 0 frozen (default: node 0 frozen).

    Returns (poses (F, 6), switches (E,) -- 1.0 for unswitched edges,
    per-iteration cost (iters,))."""
    g = g.to(device)
    F = g.poses.shape[0]
    E = g.edge_i.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    switch_mask = torch.as_tensor(switch_mask, device=dev).bool()
    free = _free_mask(fix_node_mask, F, dt, dev)
    sw = switch_mask.to(dt)
    sqrt_lam = torch.sqrt(torch.tensor(switch_prior, dtype=dt, device=dev))
    free_all = torch.cat([free, torch.ones(E, dtype=dt, device=dev)])  # switches always free
    r_scale = torch.cat([torch.full((3,), rot_weight, dtype=dt, device=dev),
                         torch.ones(3, dtype=dt, device=dev)])
    sqw = torch.sqrt(torch.clamp(g.weight, min=0.0))[:, None]

    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    def clip01(s):
        # jnp.clip's derivative: half of it at a bound (a tie of max/min),
        # where every switch starts; torch.clamp would give all of it
        return torch.minimum(torch.maximum(s, zero), one)

    def r_of(flat):
        poses = flat[:6 * F].reshape(F, 6)
        s = flat[6 * F:]
        scale = torch.where(switch_mask, clip01(s), torch.ones_like(s))
        r_edges = (edge_residuals(poses, g) * sqw * scale[:, None]
                   * r_scale[None, :]).reshape(-1)
        r_prior = sqrt_lam * sw * (1.0 - s)
        return torch.cat([r_edges, r_prior])

    def clamp_switches(cand):
        # keep switches in [0, 1]: the residual clips too, but clamping the
        # state keeps the linearization honest
        return torch.cat([cand[:6 * F], torch.clamp(cand[6 * F:], 0.0, 1.0)])

    flat0 = torch.cat([g.poses.reshape(-1), torch.ones(E, dtype=dt, device=dev)])
    flat, costs = _lm(r_of, flat0, free_all, iters, damping, post=clamp_switches)
    poses = flat[:6 * F].reshape(F, 6)
    switches = torch.where(switch_mask, torch.clamp(flat[6 * F:], 0.0, 1.0),
                           torch.ones(E, dtype=dt, device=dev))
    return poses, switches, costs


def make_sequential_edges(rel_poses, device=None) -> PoseGraph:
    """Odometry chain: rel_poses (F-1, 6) measured T_i^-1 T_{i+1}, on
    ``device`` (None means the card)."""
    dev = resolve_device(device)
    rel_poses = torch.as_tensor(rel_poses, dtype=torch.float32, device=dev)
    F = rel_poses.shape[0] + 1
    # integrate for the initial guess
    Ts = [torch.eye(4, device=dev)]
    for k in range(rel_poses.shape[0]):
        Ts.append(Ts[-1] @ _pose_to_matrix(rel_poses[k]))
    poses = _se3_log(torch.stack(Ts))
    return PoseGraph(poses=poses, edge_i=torch.arange(F - 1, device=dev),
                     edge_j=torch.arange(1, F, device=dev), rel=rel_poses,
                     weight=torch.ones(F - 1, device=dev))


def add_loop_closure(g: PoseGraph, i: int, j: int, rel, weight: float = 1.0) -> PoseGraph:
    """Append one closure edge T_ij between nodes i and j."""
    dev = g.poses.device
    rel = torch.as_tensor(rel, dtype=g.rel.dtype, device=dev)
    return PoseGraph(
        poses=g.poses,
        edge_i=torch.cat([g.edge_i, torch.tensor([i], dtype=g.edge_i.dtype, device=dev)]),
        edge_j=torch.cat([g.edge_j, torch.tensor([j], dtype=g.edge_j.dtype, device=dev)]),
        rel=torch.cat([g.rel, rel[None]], dim=0),
        weight=torch.cat([g.weight, torch.tensor([weight], dtype=g.weight.dtype, device=dev)]),
    )
