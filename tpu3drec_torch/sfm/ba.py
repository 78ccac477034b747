"""Bundle adjustment: Levenberg-Marquardt with an iterative Schur
complement (port of `tpu3drec/sfm/ba.py`).

Observations are flat arrays (cam_idx, pt_idx, uv, weight; weight 0 marks
padding). The reduced camera system is solved by preconditioned CG whose
S.v products are segment sums over the observations, never a materialised
S; landmark blocks are 3x3 inverses, camera blocks the 6x6 block-Jacobi
preconditioner. Huber IRLS weights are recomputed every LM iteration, and
optional per-observation metric depth adds a prior row that fixes the
scale gauge.

Two Jacobian paths, as in the reference: forward-mode autodiff of the
single-observation projection in the global axis-angle parameterisation
(``torch.func.jacfwd`` under ``vmap``), and ``use_pallas_blocks=True``,
which takes the closed-form local-se(3) Jacobians from the BA-blocks
kernel (`ops/ba_blocks.py`) and applies the update on the manifold
(R <- exp(w) R). The flag keeps its reference name. The reference's
``while_loop`` is a Python loop that reads ``done`` once per iteration.
The reference's ``salt`` argument guarded a TPU relay's memoisation and
has no counterpart here.

Observation-sharded BA: in the JAX package a placement alone (the segment
sums of sharded observation arrays lower to psums). Here ``ba_solve``
takes a mesh (`parallel/mesh.py`) and an axis; each rank passes its own
observations with the whole of the cameras and landmarks. Every segment
sum, the costs and the weight total are all-reduced over the axis, so the
camera and landmark systems, the CG vectors and their dot products are the
same on every rank, and the stop test is read from an all-reduced flag.

CUDA graphs: on a CUDA device without a mesh, the LM iterations replay
one captured ``torch.cuda.CUDAGraph`` of the step instead of dispatching
its several hundred small operations from Python each time. The graph
reads the problem from static buffers that each call fills with
``copy_``, and reads and overwrites the state (cameras, points, damping,
cost, stop flag) in place; the host reads the stop flag after every
iteration, as the eager loop does, so the iterations and the early exit
are the eager loop's. Graphs are cached by everything that fixes the
captured work (`graph_key`), at most ``GRAPH_CACHE_SIZE`` a thread, the
least recently used evicted. On a miss the first iteration runs eagerly
as the warm-up and, unless the loop ends there (stopped, or at
``max_lm_iters``), the step is captured and replayed for the rest. The
graphs of a thread share one memory pool; captures, one at a time in the
process, go through one side stream a device. The CPU and the mesh path
keep the eager loop.

Tracing (`utils/tracing.py`): the span ``ba.solve`` around the LM loop
and its counters ``ba.lm_iters``, ``ba.graph_replays`` (iterations run as
a replay) and ``ba.graph_captures``. The PCG loop has no early exit, so it
runs ``cg_iters`` times an LM iteration and has no counter of its own.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from tpu3drec_torch.core import fp
from tpu3drec_torch.core.se3 import axis_angle_to_matrix, matrix_to_axis_angle
from tpu3drec_torch.ops import ba_blocks as _blocks
from tpu3drec_torch.ops.ba_blocks import ba_blocks, intrinsics_of
from tpu3drec_torch.parallel.mesh import all_reduce
from tpu3drec_torch.utils.device import FORWARD_AD_LOCK, resolve_device
from tpu3drec_torch.utils.tracing import count, span


class BAProblem(NamedTuple):
    cam_params: torch.Tensor  # (F, 6) [axis-angle | translation], world->cam
    points: torch.Tensor      # (L, 3)
    cam_idx: torch.Tensor     # (O,) int64
    pt_idx: torch.Tensor      # (O,) int64
    uv: torch.Tensor          # (O, 2) pixel observations
    weight: torch.Tensor      # (O,) 0 = padding/invalid
    K: torch.Tensor           # (3, 3) shared intrinsics
    depth: torch.Tensor | None = None   # (O,) metric z per observation, 0 = none
    depth_weight: float = 1.0           # residual weight of the depth row

    @staticmethod
    def from_numpy(cam_params, points, cam_idx, pt_idx, uv, weight, K, depth=None,
                   depth_weight: float = 1.0, device=None) -> "BAProblem":
        """The JAX package's problem arrays (as numpy) -> a port problem on
        ``device`` (None means the card)."""
        dev = resolve_device(device)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        return BAProblem(f32(cam_params), f32(points), i64(cam_idx), i64(pt_idx), f32(uv),
                         f32(weight), f32(K), None if depth is None else f32(depth),
                         float(depth_weight))


class BAResult(NamedTuple):
    cam_params: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    n_iters: int


def _project_one(cam, X, K):
    """One observation: world point -> pixel coordinates."""
    R = axis_angle_to_matrix(cam[:3])
    Xc = R @ X + cam[3:]
    z = torch.where(torch.abs(Xc[2]) < 1e-9, torch.full_like(Xc[2], 1e-9), Xc[2])
    u = Xc[0] / z * K[0, 0] + K[0, 2]
    v = Xc[1] / z * K[1, 1] + K[1, 2]
    return torch.stack([u, v])


def _residual_one_depth(cam, X, K, uv, d, wd):
    """Residual with a metric-depth prior row:
    [u - u_m, v - v_m, wd * has_depth * (z - d)]."""
    R = axis_angle_to_matrix(cam[:3])
    Xc = R @ X + cam[3:]
    z = torch.where(torch.abs(Xc[2]) < 1e-9, torch.full_like(Xc[2], 1e-9), Xc[2])
    u = Xc[0] / z * K[0, 0] + K[0, 2]
    v = Xc[1] / z * K[1, 1] + K[1, 2]
    has = (d > 1e-6).to(cam.dtype)
    return torch.stack([u - uv[0], v - uv[1], wd * has * (Xc[2] - d)])


def _depth_weight(p: BAProblem) -> torch.Tensor:
    return torch.as_tensor(p.depth_weight, dtype=p.uv.dtype, device=p.uv.device)


def residuals(p: BAProblem, wd: torch.Tensor | None = None) -> torch.Tensor:
    """(O, 2) reprojection residuals, or (O, 3) with the depth-prior row
    (``wd``: ``p.depth_weight`` as a tensor on the problem's device, made
    here when not given)."""
    cams = p.cam_params[p.cam_idx]
    pts = p.points[p.pt_idx]
    if p.depth is not None:
        wd = _depth_weight(p) if wd is None else wd
        return vmap(_residual_one_depth, in_dims=(0, 0, None, 0, 0, None))(
            cams, pts, p.K, p.uv, p.depth, wd)
    return vmap(_project_one, in_dims=(0, 0, None))(cams, pts, p.K) - p.uv


def huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights for the Huber loss on the pixel residual norm (O,)."""
    n = torch.linalg.vector_norm(r[..., :2], dim=-1)
    return torch.where(n <= delta, torch.ones_like(n), delta / torch.clamp(n, min=1e-12))


def _obs_jacobians(p: BAProblem, wd: torch.Tensor | None = None):
    """Per-observation Jacobians: (O, i, 6) wrt the camera, (O, i, 3) wrt the
    point, i = 2, or 3 with depth rows (``wd`` as in `residuals`)."""
    cams = p.cam_params[p.cam_idx]
    pts = p.points[p.pt_idx]
    with FORWARD_AD_LOCK:
        if p.depth is not None:
            wd = _depth_weight(p) if wd is None else wd
            jac = jacfwd(_residual_one_depth, argnums=(0, 1))
            return vmap(jac, in_dims=(0, 0, None, 0, 0, None))(cams, pts, p.K, p.uv, p.depth,
                                                               wd)
        return vmap(jacfwd(_project_one, argnums=(0, 1)), in_dims=(0, 0, None))(cams, pts, p.K)


def _seg_sum(vals, idx, num):
    return torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx, vals)


def _huber_cost(n, huber_px):
    return torch.where(n <= huber_px, 0.5 * n ** 2, huber_px * (n - 0.5 * huber_px))


def _lm_functions(p: BAProblem, cam_free, huber_px, cg_iters, use_pallas_blocks, intr, red):
    """(cost_of, lm_step) on problem ``p``. Every tensor they read besides
    their arguments and ``p`` is made here, once, so that an LM step
    neither copies from the host nor reads from the device."""
    F = p.cam_params.shape[0]
    L = p.points.shape[0]
    dev, dt = p.cam_params.device, p.cam_params.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    wd = None if p.depth is None else _depth_weight(p)
    ein = torch.einsum

    def seg(vals, idx, num):
        return red(_seg_sum(vals, idx, num))

    def cost_of(cam_params, points):
        r = residuals(p._replace(cam_params=cam_params, points=points), wd)
        c = _huber_cost(torch.linalg.vector_norm(r[..., :2], dim=-1), huber_px)
        if r.shape[-1] > 2:
            # Huber on the depth-prior row too: depth lookups at occlusion
            # boundaries are gross outliers
            c = c + _huber_cost(torch.abs(r[..., 2]), huber_px)
        return red(torch.sum(c * p.weight))

    def lm_step(cam_params, points, lam, cost):
        prob = p._replace(cam_params=cam_params, points=points)
        r = residuals(prob, wd)
        w = p.weight * huber_weights(r, huber_px)
        if r.shape[-1] > 2:
            # row-wise robustness of the depth prior (IRLS sqrt-weight on
            # the depth row of r and, below, of the Jacobians)
            a = torch.abs(r[..., 2])
            s_d = torch.sqrt(torch.where(a <= huber_px, torch.ones_like(a),
                                         huber_px / torch.clamp(a, min=1e-12)))
            r = torch.cat([r[:, :2], (r[:, 2] * s_d)[:, None]], dim=1)
        if use_pallas_blocks:
            Rmat = axis_angle_to_matrix(cam_params[:, :3])[p.cam_idx]
            Xc = ein("oij,oj->oi", Rmat, points[p.pt_idx]) + cam_params[p.cam_idx, 3:]
            blocks = ba_blocks(Xc.contiguous(), Rmat.contiguous(), p.uv, w.contiguous(), intr)
            Jc, Jp = blocks["Jc"], blocks["Jp"]
        else:
            Jc, Jp = _obs_jacobians(prob, wd)
        if Jc.shape[1] > 2:
            scale = torch.stack([torch.ones_like(s_d), torch.ones_like(s_d), s_d], 1)[..., None]
            Jc = Jc * scale
            Jp = Jp * scale

        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None, None]
        U = seg(ein("oia,oib->oab", wJc, Jc), p.cam_idx, F)
        V = seg(ein("oia,oib->oab", wJp, Jp), p.pt_idx, L)
        b_c = -seg(ein("oia,oi->oa", wJc, r), p.cam_idx, F)
        b_p = -seg(ein("oia,oi->oa", wJp, r), p.pt_idx, L)

        # additive (Levenberg) damping
        U_l = U + lam * eye6
        V_l = V + lam * eye3
        # inv_ex: the kernels of inv without its host-side check of the info
        V_inv = torch.linalg.inv_ex(V_l + 1e-12 * eye3).inverse

        # reduced RHS b~ = b_c - W V^-1 b_p, assembled per observation
        y = ein("lab,lb->la", V_inv, b_p)
        Wy = ein("oia,oib,ob->oa", wJc, Jp, y[p.pt_idx])
        b_tilde = (b_c - seg(Wy, p.cam_idx, F)) * cam_free
        U_inv = torch.linalg.inv_ex(U_l + 1e-12 * eye6).inverse  # block-Jacobi preconditioner

        def S_matvec(v):
            v = v * cam_free
            Uv = ein("fab,fb->fa", U_l, v)
            JcV = ein("oib,ob->oi", Jc, v[p.cam_idx])
            WtV = seg(ein("oia,oi->oa", wJp, JcV), p.pt_idx, L)
            z = ein("lab,lb->la", V_inv, WtV)
            Jpz = ein("oib,ob->oi", Jp, z[p.pt_idx])
            WVWt = seg(ein("oia,oi->oa", wJc, Jpz), p.cam_idx, F)
            return (Uv - WVWt) * cam_free

        def M_inv(v):
            return ein("fab,fb->fa", U_inv, v) * cam_free

        # PCG on S dc = b~
        x = torch.zeros_like(b_tilde)
        rr = b_tilde
        z = M_inv(rr)
        pd = z
        rz = torch.sum(rr * z)
        for _ in range(cg_iters):
            Sp = S_matvec(pd)
            alpha = rz / torch.clamp(torch.sum(pd * Sp), min=1e-20)
            x = x + alpha * pd
            rr = rr - alpha * Sp
            z = M_inv(rr)
            rz_new = torch.sum(rr * z)
            pd = z + rz_new / torch.clamp(rz, min=1e-20) * pd
            rz = rz_new
        dc = x

        # back-substitute the landmarks: dp = V^-1 (b_p - W^T dc)
        Jcdc = ein("oib,ob->oi", Jc, dc[p.cam_idx])
        Wtdc = seg(ein("oia,oi->oa", wJp, Jcdc), p.pt_idx, L)
        dp = ein("lab,lb->la", V_inv, b_p - Wtdc)

        if use_pallas_blocks:
            # manifold update: R <- exp(w) R, t <- exp(w) t + nu
            dcm = dc * cam_free
            dR = axis_angle_to_matrix(dcm[:, :3])
            R_new = dR @ axis_angle_to_matrix(cam_params[:, :3])
            new_cams = torch.cat([matrix_to_axis_angle(R_new),
                                  ein("fij,fj->fi", dR, cam_params[:, 3:]) + dcm[:, 3:]], dim=1)
        else:
            new_cams = cam_params + dc * cam_free
        new_points = points + dp
        new_cost = cost_of(new_cams, new_points)
        accept = new_cost < cost
        cam_params = torch.where(accept, new_cams, cam_params)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e6))
        cost_out = torch.where(accept, new_cost, cost)
        rel = torch.abs(cost - cost_out) / torch.clamp(cost, min=1e-12)
        # converged, at machine-precision cost, or stalled (damping saturated)
        cost_floor = 1e-8 * torch.clamp(red(torch.sum(p.weight)), min=1.0)
        stop = ((accept & (rel < 1e-7)) | (cost_out <= cost_floor)
                | (~accept & (lam >= 1e6)))
        return cam_params, points, lam, cost_out, stop

    return cost_of, lm_step


# CUDA graphs of the LM step, by the padded problem's shapes. LM steps of one
# problem size replay one graph; a bundle adjuster that pads its problems to
# powers of two (`incremental.py::_run_ba`) meets a few sizes again and again.
GRAPH_CACHE_SIZE = 16
_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process
_capture_streams: dict = {}  # the side stream a device that captures go through
_graph_state = threading.local()  # each thread's cache and memory pools


def graph_key(p: BAProblem, cam_free, cg_iters, huber_px, use_pallas_blocks, intr) -> tuple:
    """Everything that fixes the work an LM step's graph captured: the
    problem's sizes O, F and L, its depth prior and that prior's weight, the
    Jacobians' path (and the intrinsics the BA-blocks kernel takes as
    arguments), the PCG steps, the Huber threshold, the camera mask's shape,
    dtypes and device, and the settings that choose kernels."""
    has_depth = p.depth is not None
    return (p.uv.shape[0], p.cam_params.shape[0], p.points.shape[0], has_depth,
            float(p.depth_weight) if has_depth else None, bool(use_pallas_blocks), intr,
            int(cg_iters), float(huber_px), tuple(cam_free.shape), p.cam_params.dtype,
            p.cam_idx.dtype, p.cam_params.device, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())


class GraphCache:
    """At most ``size`` entries, the least recently used evicted first. An
    evicted entry is dropped, and with it its graph and its static tensors."""

    def __init__(self, size: int = GRAPH_CACHE_SIZE):
        self.size = size
        self.entries: OrderedDict = OrderedDict()

    def get(self, key):
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.size:
            self.entries.popitem(last=False)

    def __len__(self):
        return len(self.entries)


class _LMGraph:
    """One problem size's LM step, captured in a CUDA graph, with the static
    tensors it reads and writes: the problem and the camera mask, filled by
    `load`, and the state (cameras, points, damping, cost, stop flag), which
    a step reads and overwrites in place."""

    def __init__(self, p: BAProblem, cam_free, huber_px, cg_iters, use_pallas_blocks, intr):
        like = lambda t: None if t is None else torch.empty_like(  # noqa: E731
            t, memory_format=torch.contiguous_format)
        self.p = BAProblem(*(like(t) for t in p[:8]), p.depth_weight)
        self.cam_free = like(cam_free)
        self.lam = torch.empty((), dtype=p.cam_params.dtype, device=p.cam_params.device)
        self.cost = torch.empty_like(self.lam)
        self.stop = torch.empty((), dtype=torch.bool, device=p.cam_params.device)
        self.cost_of, self._step = _lm_functions(self.p, self.cam_free, huber_px, cg_iters,
                                                 use_pallas_blocks, intr, lambda x, *_: x)
        self.graph = None
        self.kernel_runs = 0  # BA-blocks launches captured, run once a replay

    def load(self, p: BAProblem, cam_free, lam) -> torch.Tensor:
        """Fills the static problem and state from ``p``; returns its cost."""
        for dst, src in zip(self.p[:8], p[:8]):
            if dst is not None:
                dst.copy_(src)
        self.cam_free.copy_(cam_free)
        self.lam.copy_(lam)
        cost = self.cost_of(self.p.cam_params, self.p.points)
        self.cost.copy_(cost)
        return cost

    def step(self) -> None:
        """One LM iteration from the static state into it."""
        out = self._step(self.p.cam_params, self.p.points, self.lam, self.cost)
        for dst, src in zip((self.p.cam_params, self.p.points, self.lam, self.cost, self.stop),
                            out):
            dst.copy_(src)

    def capture(self, stream, pool) -> None:
        """Records one step into a graph on ``stream`` (a capture cannot go
        through the default stream), after the work queued so far on this
        thread's stream, whose state it reads."""
        graph = torch.cuda.CUDAGraph()
        before = _blocks.captured
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.step()
            finally:
                graph.capture_end()
        self.graph = graph
        self.kernel_runs = _blocks.captured - before

    def replay(self) -> None:
        self.graph.replay()
        if self.kernel_runs:
            _blocks.add_launches(self.kernel_runs)


def _thread_graphs(dev: torch.device):
    """This thread's graph cache and its memory pool on ``dev``: the graphs
    of one thread run one at a time, so they share one pool; another
    thread's graphs, which may replay at the same time, keep a pool of their
    own."""
    st = _graph_state.__dict__
    if "cache" not in st:
        st.update(cache=GraphCache(), pools={})
    if dev not in st["pools"]:
        st["pools"][dev] = torch.cuda.graph_pool_handle()
    return st["cache"], st["pools"][dev]


def _capture_stream(dev: torch.device):
    """The side stream that captures on ``dev`` go through (under
    ``_CAPTURE_LOCK``, so one capture at a time uses it)."""
    if dev not in _capture_streams:
        _capture_streams[dev] = torch.cuda.Stream(dev)
    return _capture_streams[dev]


def _graphed(p: BAProblem, mesh) -> bool:
    """Whether the LM loop replays a graph: on a CUDA device, without a mesh
    (whose all-reduces are not captured)."""
    return mesh is None and p.cam_params.device.type == "cuda"


def _solve_graphed(p, cam_free, lam, max_lm_iters, key, make):
    """The LM loop as replays of the cached graph of ``key``; on a miss the
    first iteration runs eagerly and, unless the loop ends there, the step
    is captured. Returns (cams, points, initial cost, cost, iterations,
    replays, captures)."""
    dev = p.cam_params.device
    cache, pool = _thread_graphs(dev)
    entry = cache.get(key)
    if entry is None:
        entry = make()
    init_cost = entry.load(p, cam_free, lam)
    it = replays = captures = 0
    while it < max_lm_iters:
        it += 1
        if entry.graph is None:  # the warm-up, eagerly on this thread's stream
            entry.step()
            stop = bool(entry.stop)
            if not stop and it < max_lm_iters:
                with _CAPTURE_LOCK:
                    entry.capture(_capture_stream(dev), pool)
                captures += 1
                cache.put(key, entry)
        else:
            entry.replay()
            replays += 1
            stop = bool(entry.stop)  # the one host read an iteration
        if stop:
            break
    return (entry.p.cam_params.clone(), entry.p.points.clone(), init_cost, entry.cost.clone(),
            it, replays, captures)


def ba_solve(p: BAProblem, max_lm_iters: int = 20, cg_iters: int = 20, huber_px: float = 2.0,
             init_lambda: float = 1e-3, fix_cam_mask=None,
             use_pallas_blocks: bool = False, mesh=None, axis="space") -> BAResult:
    """Run LM. ``fix_cam_mask`` (F,) or (F, 6): 1.0 free, 0.0 frozen (default:
    camera 0 frozen for the gauge). ``use_pallas_blocks=True`` takes the
    Jacobians from the BA-blocks kernel and updates on the manifold; it
    refuses depth priors, as the reference does. With ``mesh``, ``p``
    holds this rank's observations and the sums reduce over ``axis``.
    On a CUDA device without a mesh the iterations replay a CUDA graph of
    the step, captured once per problem size (module docstring)."""
    if use_pallas_blocks and p.depth is not None:
        raise ValueError("use_pallas_blocks does not support depth priors")
    F = p.cam_params.shape[0]
    dev, dt = p.cam_params.device, p.cam_params.dtype
    if fix_cam_mask is None:
        fix_cam_mask = torch.cat([torch.zeros(1), torch.ones(F - 1)])
    fix_cam_mask = torch.as_tensor(fix_cam_mask, dtype=dt, device=dev)
    cam_free = fix_cam_mask[:, None] if fix_cam_mask.ndim == 1 else fix_cam_mask
    intr = intrinsics_of(p.K) if use_pallas_blocks else None

    def red(x, op="sum"):  # over the ranks' observations
        return x if mesh is None else all_reduce(mesh, x, axis, op)

    with fp.ieee_fp32(), span("ba.solve"):
        lam = torch.as_tensor(init_lambda, dtype=dt, device=dev)
        replays = captures = 0
        if _graphed(p, mesh):
            key = graph_key(p, cam_free, cg_iters, huber_px, use_pallas_blocks, intr)
            cams, pts, init_cost, cost, it, replays, captures = _solve_graphed(
                p, cam_free, lam, max_lm_iters, key,
                lambda: _LMGraph(p, cam_free, huber_px, cg_iters, use_pallas_blocks, intr))
        else:
            cost_of, lm_step = _lm_functions(p, cam_free, huber_px, cg_iters,
                                             use_pallas_blocks, intr, red)
            init_cost = cost_of(p.cam_params, p.points)
            cams, pts, cost = p.cam_params, p.points, init_cost
            it = 0
            # early exit: one host read of the stop flag per iteration
            while it < max_lm_iters:
                cams, pts, lam, cost, stop = lm_step(cams, pts, lam, cost)
                it += 1
                if bool(stop) if mesh is None else bool(red(stop.to(torch.int32).reshape(1),
                                                            "max")):
                    break
        count("ba.lm_iters", it)
        count("ba.graph_replays", replays)
        count("ba.graph_captures", captures)
    return BAResult(cam_params=cams, points=pts, initial_cost=init_cost, final_cost=cost,
                    n_iters=it)
