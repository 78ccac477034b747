"""Multi-process dry run of the PyTorch/CUDA port, the analogue of
`__graft_entry__.py::dryrun_multichip`: on N gloo ranks at tiny shapes, one
data-parallel monocular training step over the (data, space) axes, the
ring nearest-neighbour search, observation-sharded BA, landmark-sharded BA
with depth priors, the x-sharded TSDF and sharded marching tetrahedra.
Each rank checks that its results are finite, and the data-parallel step's
loss equal on every rank.

Usage:
  python tools/dryrun_multichip_torch.py --ranks 4 --device cpu
  python tools/dryrun_multichip_torch.py --ranks 2            # ranks share cuda:0
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def dryrun(n: int, device) -> dict:
    """This rank's part of the dry run (the process group is joined)."""
    import torch

    from tpu3drec_torch.models.training import TrainConfig, init_state, make_train_step
    from tpu3drec_torch.mvs.marching import marching_tetrahedra_sharded_soup
    from tpu3drec_torch.mvs.tsdf import TsdfGrid, integrate_depth_maps, shard_grid
    from tpu3drec_torch.parallel.ba_sharded import ba_solve_landmark_sharded
    from tpu3drec_torch.parallel.mesh import all_reduce, make_mesh, shard_batch
    from tpu3drec_torch.parallel.ring import ring_nearest_neighbors
    from tpu3drec_torch.sfm.ba import BAProblem, ba_solve

    space = 2 if n % 2 == 0 else 1
    axes = ("data", "space")
    mesh = make_mesh(data=n // space, space=space, device=device, axis_groups=[axes])
    out = {}

    H, W = 32, 64
    cfg = TrainConfig(height=H, width=W, batch_size=n)
    model, state = init_state(0, cfg, steps_per_epoch=10, device=mesh.device)
    rng = np.random.default_rng(0)
    batch = {k: shard_batch(mesh, rng.uniform(size=(n, H, W, 3)).astype(np.float32), axes)
             for k in ("target", "prev", "next")}
    gen = torch.Generator(device=mesh.device).manual_seed(1)
    _, loss, _ = make_train_step(cfg, mesh=mesh, axis=axes)(state, batch, rng=gen)
    out["loss"] = float(loss)
    spread = all_reduce(mesh, loss.reshape(1), axes, "max") - all_reduce(
        mesh, loss.reshape(1), axes, "min")
    assert np.isfinite(out["loss"]) and float(spread[0]) == 0.0, (out["loss"], spread)

    q = shard_batch(mesh, rng.normal(size=(8 * n, 3)).astype(np.float32), axes)
    r = shard_batch(mesh, rng.normal(size=(8 * n, 3)).astype(np.float32), axes)
    if space > 1:
        # each data slice searches its own pair of shards around its space ring
        idx, d2 = ring_nearest_neighbors(q, r, mesh, axis="space")
        assert torch.isfinite(d2).all()
        out["ring_d2_max"] = float(d2.max())

    L, O = 16, 64
    cam = np.zeros((2, 6), np.float32)
    cam[1, 3] = 1.0
    full = dict(cam_idx=(np.arange(O) % 2), pt_idx=(np.arange(O) % L),
                uv=rng.uniform(0, 100, size=(O, 2)).astype(np.float32),
                weight=np.ones(O, np.float32))
    points = rng.uniform([-1, -1, 4], [1, 1, 8], size=(L, 3)).astype(np.float32)
    K = np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]], np.float32)
    prob = BAProblem.from_numpy(cam, points, full["cam_idx"], full["pt_idx"], full["uv"],
                                full["weight"], K, device=mesh.device)
    sharded = prob._replace(**{k: shard_batch(mesh, getattr(prob, k), axes)
                               for k in ("cam_idx", "pt_idx", "uv", "weight")})
    res = ba_solve(sharded, max_lm_iters=2, cg_iters=4, mesh=mesh, axis=axes)
    out["ba_cost"] = float(res.final_cost)
    assert np.isfinite(out["ba_cost"])

    if space > 1:
        prob_d = prob._replace(depth=torch.as_tensor(
            rng.uniform(4.0, 8.0, size=O).astype(np.float32), device=mesh.device),
            depth_weight=2.0)
        res2 = ba_solve_landmark_sharded(prob_d, mesh, axis="space", max_lm_iters=2, cg_iters=4)
        out["ba_landmark_cost"] = float(res2.final_cost)
        assert np.isfinite(out["ba_landmark_cost"])

    gdim = 4 * n
    grid = TsdfGrid.allocate((-1.0, -1.0, -1.0), (gdim, 8, 8), 0.1, trunc=0.3, device="cpu")
    dmaps = rng.uniform(1.0, 3.0, size=(2, 12, 16)).astype(np.float32)
    Kd = np.array([[10.0, 0, 8], [0, 10.0, 6], [0, 0, 1]], np.float32)
    eye3 = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
    tz = np.zeros((2, 3), np.float32)
    slab = integrate_depth_maps(shard_grid(grid, mesh, axes), dmaps, Kd, eye3, tz)
    assert slab.tsdf.shape[0] == 4 and torch.isfinite(slab.tsdf).all()
    whole = integrate_depth_maps(grid, dmaps, Kd, eye3, tz)
    soup = marching_tetrahedra_sharded_soup(whole.tsdf.numpy(), whole.weight.numpy(),
                                            grid.origin, grid.res, mesh, axis=axes,
                                            cells_per_shard=256)
    assert np.isfinite(soup).all()
    out["triangles"] = int(soup.shape[0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default=None, help="torch device of every rank (default: cuda)")
    p.add_argument("--rank", type=int, default=None)   # internal
    p.add_argument("--store", default=None)            # internal
    args = p.parse_args(argv)
    if args.ranks < 2:
        p.error("the dry run needs at least 2 ranks")
    if args.rank is None:
        from tpu3drec_torch.parallel.multihost import spawn_local

        with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
            cmd = [sys.executable, os.path.abspath(__file__), "--ranks", str(args.ranks),
                   "--store", os.path.join(tmp, "store")]
            if args.device:
                cmd += ["--device", args.device]
            outs = spawn_local(lambda r: cmd + ["--rank", str(r)], args.ranks, timeout=600)
        print("".join(outs), end="", flush=True)
        return 0

    import torch

    from tpu3drec_torch.parallel.multihost import init_distributed

    torch.set_num_threads(1)
    if not init_distributed("file://" + args.store, args.ranks, args.rank):
        raise RuntimeError("the process group did not start")
    out = dryrun(args.ranks, args.device)
    print(f"[dryrun rank {args.rank}] " + " ".join(f"{k}={v}" for k, v in out.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
