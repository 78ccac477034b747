"""Parity of the port's multi-process runtime (`tpu3drec_torch/parallel/`,
the x-sharded TSDF and marching tetrahedra, observation-sharded BA) with
the JAX package's (`tests/test_parallel.py` mirrored; its tensor-parallel
test, with the data-parallel steps, in
`tests/test_torch_parallel_training.py`).

One world of 4 gloo ranks on the CPU (`tests/torch_world.py`) runs every
rank-side check once for the module and writes its results; each test then
holds them against the JAX function, run here on conftest's 8 CPU devices
with a mesh of the same 4-way layout. The ranks import no JAX.

Tolerances:
- ring search: indices equal (also on a fixture of exact duplicates across
  shards, where ranks > 0 keep their first-visited shard), d2 within 1e-5
  (the JAX package uses the matmul identity, the port direct differences);
- voxel counts exact; `prepare_landmark_shards` arrays exactly equal;
- BA: the JAX tests' tolerances (tests/test_parallel.py:87-94 and after);
- TSDF slabs bit-equal to the single-process grid's slices; sharded
  marching: the same triangles in the same order as the single-process
  path, and the JAX package's sharded soup within 1e-6.
"""

import os
import sys

import numpy as np
import pytest

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import run_world  # noqa: E402

WORLD = 4


# --------------------------------------------------------------- rank side


def _rank_checks(rank, world, inp):
    from tpu3drec_torch.parallel import mesh as pm
    from tpu3drec_torch.parallel.ring import ring_nearest_neighbors, sharded_voxel_count

    out = {}
    mesh = pm.make_mesh(data=1, space=world, device="cpu")
    # ---- mesh
    m2 = pm.make_mesh(data=0, space=2, device="cpu", axis_groups=[("data", "space")])
    out["mesh_shape"] = np.array([m2.shape["data"], m2.shape["space"], m2.shape["model"]])
    try:
        pm.make_mesh(data=0, space=3, device="cpu")
        out["mesh_error"] = np.array(0)
    except ValueError:
        out["mesh_error"] = np.array(1)
    out["shard"] = pm.shard_batch(mesh, inp["shard_x"], "space").numpy()
    out["replicate"] = pm.replicate(mesh, inp["shard_x"]).numpy()
    # ---- ring search: random clouds and exact cross-shard ties
    for name in ("ring", "tie"):
        idx, d2 = ring_nearest_neighbors(pm.shard_batch(mesh, inp[f"{name}_q"], "space"),
                                         pm.shard_batch(mesh, inp[f"{name}_r"], "space"), mesh)
        out[f"{name}_idx"], out[f"{name}_d2"] = idx.numpy(), d2.numpy()
    # ---- sharded voxel count
    for name in ("vox", "dup"):
        out[f"{name}_count"] = sharded_voxel_count(
            pm.shard_batch(mesh, inp[f"{name}_keys"], "space"),
            pm.shard_batch(mesh, inp[f"{name}_valid"], "space"), mesh).numpy()
    # ---- fusion over a (data, space) tuple axis
    from tpu3drec_torch.core.unproject import fuse_depth_maps

    ax = ("data", "space")
    pts, _ = fuse_depth_maps(pm.shard_batch(m2, inp["fuse_depths"], ax),
                             pm.shard_batch(m2, inp["fuse_R"], ax),
                             pm.shard_batch(m2, inp["fuse_t"], ax),
                             100.0, 100.0, 12.0, 8.0, device="cpu")
    out["fuse_pts"] = pm.all_gather(m2, pts, ax).numpy()
    out.update(_rank_ba(mesh, inp))
    out.update(_rank_dense(mesh, inp))
    return out


def _problem(inp, prefix, depth=False):
    from tpu3drec_torch.sfm.ba import BAProblem

    keys = ("cam_params", "points", "cam_idx", "pt_idx", "uv", "weight", "K")
    return BAProblem.from_numpy(*(inp[f"{prefix}_{k}"] for k in keys),
                                depth=inp[f"{prefix}_depth"] if depth else None,
                                depth_weight=5.0 if depth else 1.0, device="cpu")


def _rank_ba(mesh, inp):
    import torch

    from tpu3drec_torch.parallel.ba_sharded import ba_solve_landmark_sharded
    from tpu3drec_torch.parallel.mesh import shard_batch
    from tpu3drec_torch.sfm.ba import ba_solve

    out = {}
    # observation-sharded: this rank's observations, the whole state
    prob = _problem(inp, "obs")
    sharded = prob._replace(**{k: shard_batch(mesh, getattr(prob, k), "space")
                               for k in ("cam_idx", "pt_idx", "uv", "weight")})
    for blocks in (False, True):
        res = ba_solve(sharded, max_lm_iters=5, cg_iters=10, use_pallas_blocks=blocks,
                       mesh=mesh, axis="space")
        single = ba_solve(prob, max_lm_iters=5, cg_iters=10, use_pallas_blocks=blocks)
        tag = "obs_blocks" if blocks else "obs"
        out[f"{tag}_cams"], out[f"{tag}_cost"] = res.cam_params.numpy(), res.final_cost.numpy()
        out[f"{tag}_single_cams"] = single.cam_params.numpy()
        out[f"{tag}_single_cost"] = single.final_cost.numpy()
    for tag, depth, iters in (("lm", False, (6, 12)), ("lmd", True, (15, 20))):
        prob = _problem(inp, tag, depth)
        res = ba_solve_landmark_sharded(prob, mesh, axis="space", max_lm_iters=iters[0],
                                        cg_iters=iters[1])
        single = ba_solve(prob, max_lm_iters=iters[0], cg_iters=iters[1])
        out[f"{tag}_cams"], out[f"{tag}_pts"] = res.cam_params.numpy(), res.points.numpy()
        out[f"{tag}_cost"] = torch.as_tensor(res.final_cost).numpy()
        out[f"{tag}_single_cams"] = single.cam_params.numpy()
        out[f"{tag}_single_pts"] = single.points.numpy()
        out[f"{tag}_single_cost"] = single.final_cost.numpy()
    return out


def _rank_dense(mesh, inp):
    import torch

    from tpu3drec_torch.mvs import marching as tmc
    from tpu3drec_torch.mvs import tsdf as tts
    from tpu3drec_torch.parallel.mesh import all_gather

    out = {}
    args = (inp["tsdf_depths"], inp["tsdf_K"], inp["tsdf_R"], inp["tsdf_t"])
    grid = tts.TsdfGrid.allocate((-1.3, -1.3, -1.3), tuple(inp["tsdf_dims"]), 0.065,
                                 device="cpu")
    slab = tts.integrate_depth_maps(tts.shard_grid(grid, mesh, "space"), *args)
    out["slab_x0"] = np.array(slab.x0)
    out["slab_tsdf"], out["slab_weight"] = slab.tsdf.numpy(), slab.weight.numpy()
    out["tsdf_single"] = tts.integrate_depth_maps(grid, *args).tsdf.numpy()
    sdf, w, origin, res = inp["sdf"], inp["sdf_w"], inp["sdf_origin"], float(inp["sdf_res"])
    for tag, weight, cap in (("mt", w, 1024), ("mt_small", None, 8)):
        out[f"{tag}_soup"] = tmc.marching_tetrahedra_sharded_soup(
            sdf, weight, origin, res, mesh, axis="space", cells_per_shard=cap)
    _, _, n_active = tmc.marching_tetrahedra_sharded(sdf, None, origin, res, mesh,
                                                     axis="space", cells_per_shard=8)
    out["mt_small_n_active"] = all_gather(mesh, torch.tensor([n_active]), "space").numpy()
    return out


def _rank_main(argv):
    from torch_world import join

    rank, world, d = join(argv)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    np.savez(os.path.join(d, f"rank{rank}.npz"), **_rank_checks(rank, world, inp))


# -------------------------------------------------------------- parent side


def _inputs():
    import jax.numpy as jnp

    from test_ba import _make_problem
    from test_mvs import sphere_sdf_grid
    from test_torch_mvs import _sphere_views
    from tpu3drec.core.se3 import axis_angle_to_matrix

    rng = np.random.default_rng(0)
    inp = {"shard_x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3)}
    inp["ring_q"] = rng.normal(size=(64, 3)).astype(np.float32)
    inp["ring_r"] = rng.normal(size=(128, 3)).astype(np.float32)
    # exact ties across shards: every reference shard holds the same points
    base = rng.normal(size=(16, 3)).astype(np.float32)
    inp["tie_r"] = np.tile(base, (WORLD, 1))
    inp["tie_q"] = np.concatenate([base, base + 0.01, base[::-1] - 0.02, base * 1.1]
                                  ).astype(np.float32)
    pts = rng.uniform(-2, 2, size=(400, 3)).astype(np.float32)
    inp["vox_pts"] = pts
    inp["vox_keys"] = np.floor(pts / np.float32(0.2)).astype(np.int32)
    inp["vox_valid"] = np.ones(400, bool)
    inp["dup_keys"] = np.tile(np.array([[1, 2, 3], [4, 5, 6]], np.int32), (WORLD, 1))
    inp["dup_valid"] = np.ones(2 * WORLD, bool)
    F, h, w = 8, 16, 24
    inp["fuse_depths"] = rng.uniform(0.1, 10, size=(F, h, w)).astype(np.float32)
    inp["fuse_R"] = np.broadcast_to(np.eye(3, dtype=np.float32), (F, 3, 3)).copy()
    inp["fuse_t"] = rng.normal(size=(F, 3)).astype(np.float32)

    def put(tag, prob):
        for k in ("cam_params", "points", "cam_idx", "pt_idx", "uv", "weight", "K"):
            inp[f"{tag}_{k}"] = np.asarray(getattr(prob, k))
        if prob.depth is not None:
            inp[f"{tag}_depth"] = np.asarray(prob.depth)

    put("obs", _make_problem(rng, F=4, L=64, perturb=0.005)[0])
    put("lm", _make_problem(rng, F=6, L=256, perturb=0.01, noise_px=0.3)[0])
    prob = _make_problem(rng, F=4, L=128)[0]
    cams, Xs = np.asarray(prob.cam_params), np.asarray(prob.points)
    ci, pi = np.asarray(prob.cam_idx), np.asarray(prob.pt_idx)
    Rs = np.stack([np.asarray(axis_angle_to_matrix(jnp.asarray(c[:3]))) for c in cams])
    z = (np.einsum("oij,oj->oi", Rs[ci], Xs[pi]) + cams[ci, 3:])[:, 2].astype(np.float32)
    keep = np.random.default_rng(3).uniform(size=z.shape) > 0.3
    z = np.where(keep, z, 0.0).astype(np.float32)
    put("lmd", prob._replace(
        cam_params=jnp.asarray(np.concatenate([cams[:, :3], cams[:, 3:] * 0.7], axis=1)),
        points=jnp.asarray(Xs * 0.7), depth=jnp.asarray(z), depth_weight=5.0))

    depths, K, Rv, tv = _sphere_views()
    inp.update(tsdf_depths=depths, tsdf_K=K, tsdf_R=Rv, tsdf_t=tv,
               tsdf_dims=np.array([41, 40, 40]))
    sdf, origin, res = sphere_sdf_grid(n=36)
    sdf_w = np.ones_like(sdf)
    sdf_w[:2] = 0.0
    inp.update(sdf=sdf, sdf_w=sdf_w, sdf_origin=origin, sdf_res=np.array(res))
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    ranks = run_world(os.path.abspath(__file__), d, world=WORLD, timeout=420)
    return inp, ranks


def _jax_mesh(**kw):
    from tpu3drec.parallel.mesh import make_mesh

    return make_mesh(**kw)


def _jax_problem(inp, tag, depth=False):
    import jax.numpy as jnp

    from tpu3drec.sfm.ba import BAProblem

    keys = ("cam_params", "points", "cam_idx", "pt_idx", "uv", "weight", "K")
    return BAProblem(*(jnp.asarray(inp[f"{tag}_{k}"]) for k in keys),
                     depth=jnp.asarray(inp[f"{tag}_depth"]) if depth else None,
                     depth_weight=5.0 if depth else 1.0)


# ------------------------------------------------------------------ mesh


def test_make_mesh_shapes(world):
    _, ranks = world
    for r in ranks:
        np.testing.assert_array_equal(r["mesh_shape"], [2, 2, 1])
        assert int(r["mesh_error"]) == 1  # 4 ranks do not divide by space=3


def test_pad_to_multiple():
    from tpu3drec.parallel.mesh import pad_to_multiple as jpad
    from tpu3drec_torch.parallel.mesh import pad_to_multiple

    x = np.ones((10, 3))
    p, n = pad_to_multiple(x, 8)
    assert p.shape == (16, 3) and n == 10
    q, m = jpad(x, 8)
    np.testing.assert_array_equal(p, q)
    assert m == n


def test_shard_batch_places(world):
    inp, ranks = world
    np.testing.assert_array_equal(np.concatenate([r["shard"] for r in ranks]), inp["shard_x"])
    assert all(r["shard"].shape == (4, 3) for r in ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["replicate"], inp["shard_x"])


# ------------------------------------------------------------------ ring


@pytest.mark.parametrize("name", ["ring", "tie"])
def test_ring_matches_jax(world, name):
    import jax.numpy as jnp

    from tpu3drec.parallel.mesh import shard_batch
    from tpu3drec.parallel.ring import ring_nearest_neighbors

    inp, ranks = world
    q, r = inp[f"{name}_q"], inp[f"{name}_r"]
    mesh = _jax_mesh(data=1, space=WORLD)
    idx, d2 = ring_nearest_neighbors(shard_batch(mesh, jnp.asarray(q), "space"),
                                     shard_batch(mesh, jnp.asarray(r), "space"), mesh)
    got_idx = np.concatenate([x[f"{name}_idx"] for x in ranks])
    got_d2 = np.concatenate([x[f"{name}_d2"] for x in ranks])
    np.testing.assert_array_equal(got_idx, np.asarray(idx))
    np.testing.assert_allclose(got_d2, np.asarray(d2), atol=1e-5)
    ref = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got_d2, ref.min(1), atol=1e-5)
    if name == "ring":
        np.testing.assert_array_equal(got_idx, ref.argmin(1))
    else:
        # every shard ties: rank k's queries keep shard k, visited first
        nq, nr = q.shape[0] // WORLD, r.shape[0] // WORLD
        owner = got_idx // nr
        np.testing.assert_array_equal(owner, np.repeat(np.arange(WORLD), nq))
        assert (owner > 0).any()


# ------------------------------------------------------------------ voxels


def test_count_matches_host_and_jax(world):
    import jax.numpy as jnp

    from baseline.reference_cpu import octree_insert_equiv
    from tpu3drec.mapping.voxel import voxelize
    from tpu3drec.parallel.mesh import shard_batch
    from tpu3drec.parallel.ring import sharded_voxel_count

    inp, ranks = world
    pts = inp["vox_pts"]
    keys = np.asarray(voxelize(jnp.asarray(pts), 0.2))
    np.testing.assert_array_equal(keys, inp["vox_keys"])
    mesh = _jax_mesh(data=1, space=WORLD)
    ref = int(sharded_voxel_count(shard_batch(mesh, keys, "space"),
                                  shard_batch(mesh, inp["vox_valid"], "space"), mesh))
    assert ref == len(octree_insert_equiv(pts.astype(np.float64), 0.2))
    assert all(int(r["vox_count"]) == ref for r in ranks)


def test_count_with_cross_shard_duplicates(world):
    _, ranks = world
    assert all(int(r["dup_count"]) == 2 for r in ranks)


# ------------------------------------------------------------------ BA


def test_sharded_obs_equals_unsharded(world):
    """Observation-sharded BA on both Jacobian paths against the
    single-process solve (the reductions become all-reduces), and the
    jacfwd path against the JAX package's single-device solve."""
    from tpu3drec.sfm.ba import ba_solve

    inp, ranks = world
    jres = ba_solve(_jax_problem(inp, "obs"), max_lm_iters=5, cg_iters=10)
    for r in ranks:
        for tag in ("obs", "obs_blocks"):
            np.testing.assert_allclose(r[f"{tag}_cams"], r[f"{tag}_single_cams"], atol=1e-4)
            np.testing.assert_allclose(float(r[f"{tag}_cost"]), float(r[f"{tag}_single_cost"]),
                                       rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(r["obs_cams"], np.asarray(jres.cam_params), atol=1e-4)
        np.testing.assert_allclose(float(r["obs_cost"]), float(jres.final_cost),
                                   rtol=1e-3, atol=1e-6)
        np.testing.assert_array_equal(r["obs_cams"], ranks[0]["obs_cams"])


@pytest.mark.parametrize("tag", ["lm", "lmd"])
def test_landmark_sharded_equals_jax(world, tag):
    """Landmark state partitioned over 4 ranks (with depth priors for
    "lmd"): the JAX package's landmark-sharded solve on 4 devices, and the
    port's own single-process solve."""
    from tpu3drec.parallel.ba_sharded import ba_solve_landmark_sharded

    inp, ranks = world
    depth = tag == "lmd"
    iters = (15, 20) if depth else (6, 12)
    tol_c, tol_p = (5e-4, 5e-3) if depth else (2e-4, 2e-3)
    jres = ba_solve_landmark_sharded(_jax_problem(inp, tag, depth), _jax_mesh(data=1, space=WORLD),
                                     axis="space", max_lm_iters=iters[0], cg_iters=iters[1])
    for r in ranks:
        for ref_c, ref_p, ref_cost in (
                (np.asarray(jres.cam_params), np.asarray(jres.points), float(jres.final_cost)),
                (r[f"{tag}_single_cams"], r[f"{tag}_single_pts"],
                 float(r[f"{tag}_single_cost"]))):
            np.testing.assert_allclose(r[f"{tag}_cams"], ref_c, atol=tol_c)
            np.testing.assert_allclose(r[f"{tag}_pts"], ref_p, atol=tol_p)
            np.testing.assert_allclose(float(r[f"{tag}_cost"]), ref_cost, rtol=1e-3, atol=1e-6)
    if depth:
        # the depth rows pulled the scale back to the metric priors
        from tpu3drec_torch.core.se3 import axis_angle_to_matrix
        import torch

        c, X = ranks[0]["lmd_cams"], ranks[0]["lmd_pts"]
        ci, pi, z = inp["lmd_cam_idx"], inp["lmd_pt_idx"], inp["lmd_depth"]
        Rn = axis_angle_to_matrix(torch.as_tensor(c[:, :3])).numpy()
        z_new = (np.einsum("oij,oj->oi", Rn[ci], X[pi]) + c[ci, 3:])[:, 2]
        keep = z > 0
        assert np.median(np.abs(z_new[keep] - z[keep]) / z[keep]) < 0.02


def test_landmark_shard_prep_equals_jax(rng):
    """`prepare_landmark_shards` is the reference's numpy: the same arrays."""
    from test_ba import _make_problem
    from tpu3drec.parallel.ba_sharded import prepare_landmark_shards as jprep
    from tpu3drec_torch.parallel.ba_sharded import prepare_landmark_shards
    from tpu3drec_torch.sfm.ba import BAProblem

    for depth in (False, True):
        prob, _, _ = _make_problem(rng, F=4, L=100)
        if depth:
            prob = prob._replace(depth=np.asarray(rng.uniform(0, 9, size=prob.uv.shape[0]),
                                                  np.float32))
        tprob = BAProblem.from_numpy(*(np.asarray(getattr(prob, k)) for k in (
            "cam_params", "points", "cam_idx", "pt_idx", "uv", "weight", "K")),
            depth=None if prob.depth is None else np.asarray(prob.depth), device="cpu")
        ref, got = jprep(prob, 8), prepare_landmark_shards(tprob, 8)
        assert (got.L, got.Ls, got.Oc) == (ref.L, ref.Ls, ref.Oc) and got.Ls == 13
        for k in ("points", "cam_idx", "pt_idx_local", "uv", "weight", "depth"):
            a, b = getattr(got, k), getattr(ref, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)


# ------------------------------------------------------------------ dense


def test_frames_sharded_over_mesh(world):
    from tpu3drec.core.unproject import fuse_depth_maps
    import jax.numpy as jnp

    inp, ranks = world
    pts, _ = fuse_depth_maps(jnp.asarray(inp["fuse_depths"]), jnp.asarray(inp["fuse_R"]),
                             jnp.asarray(inp["fuse_t"]), 100.0, 100.0, 12.0, 8.0)
    for r in ranks:
        got = r["fuse_pts"].reshape(np.asarray(pts).shape)
        np.testing.assert_allclose(got, np.asarray(pts), atol=1e-5)


def test_tsdf_slabs_bit_equal(world):
    """Each rank's x-slab (41 planes over 4 ranks: 11, 11, 11, 8) equals
    the single-process grid's slice bit for bit; the grid itself is the JAX
    package's within tests/test_torch_mvs.py's bound."""
    from tpu3drec.mvs import tsdf as jts

    inp, ranks = world
    single = ranks[0]["tsdf_single"]
    x0s = [int(r["slab_x0"]) for r in ranks]
    assert x0s == [0, 11, 22, 33]
    for r, x0 in zip(ranks, x0s):
        n = r["slab_tsdf"].shape[0]
        np.testing.assert_array_equal(r["slab_tsdf"], single[x0:x0 + n])
    assert sum(r["slab_tsdf"].shape[0] for r in ranks) == 41
    jg = jts.integrate_depth_maps(
        jts.TsdfGrid.allocate((-1.3, -1.3, -1.3), (41, 40, 40), 0.065),
        inp["tsdf_depths"], inp["tsdf_K"], inp["tsdf_R"], inp["tsdf_t"])
    assert np.abs(np.asarray(jg.tsdf) - single).max() <= 1e-5


@pytest.mark.parametrize("tag", ["mt", "mt_small"])
def test_sharded_marching_matches_jax_and_host(world, tag):
    """The sharded soup equals the single-process path's triangles in the
    same order, and the JAX package's sharded soup (4 devices) within 1e-6;
    "mt_small" starts at a capacity of 8 cells and doubles (against the
    single-process path only: the JAX package compiles every capacity)."""
    from tpu3drec.mvs.marching import marching_tetrahedra_sharded_soup
    from tpu3drec_torch.mvs.marching import marching_tetrahedra

    inp, ranks = world
    weight = inp["sdf_w"] if tag == "mt" else None
    args = (inp["sdf"], weight, inp["sdf_origin"], float(inp["sdf_res"]))
    host = marching_tetrahedra(*args, device="cpu")
    for r in ranks:
        np.testing.assert_array_equal(r[f"{tag}_soup"], host)
    if tag == "mt":
        ref = marching_tetrahedra_sharded_soup(*args, _jax_mesh(data=WORLD, space=1),
                                               axis="data", cells_per_shard=1024)
        assert ranks[0]["mt_soup"].shape == ref.shape
        assert np.abs(ranks[0]["mt_soup"] - ref).max() <= 1e-6
    else:
        assert ranks[0]["mt_small_n_active"].max() > 8


# ------------------------------------------------------------------ training


if __name__ == "__main__":
    _rank_main(sys.argv)
