"""Parity of the port's multi-process runtime (`tpu3drec_torch/parallel/
multihost.py`, the CLI's distributed flags, the multi-process branches of
`pipelines/rgbd.py` and `pipelines/kitti.py`) with the JAX package's
(`tests/test_multihost.py` mirrored).

One world of 4 gloo ranks on the CPU (`tests/torch_world.py`): each rank
joins through the CLI (``--coordinator file://... --num-processes 4
--process-id r rgbd ...``), then runs the sharded writers, a capped second
`rgbd` run and the window-pose exchange. The JAX package's single-process
`rgbd` run here is the reference: the merged `.bt` byte-equal, the merged
PLY the same point set. The 2-process windowed SfM and data-parallel
training of the reference's `slow` tests have `slow` analogues here.
"""

import json
import os
import sys

import numpy as np
import pytest

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import run_world  # noqa: E402

WORLD = 4
N_FRAMES = 8
MAX_POINTS = 500


# --------------------------------------------------------------- rank side


def _rank_main(argv):
    import torch

    rank, world, d = int(argv[1]), int(argv[2]), argv[3]
    mode = argv[4] if len(argv) > 4 else "fast"
    torch.set_num_threads(1)
    if mode == "kitti":
        return _rank_kitti(rank, world, d)
    if mode == "train":
        return _rank_train(rank, world, d)
    from tpu3drec_torch.pipelines import cli

    # the CLI joins the process group before the subcommand runs
    cli.main(["--device", "cpu", "--coordinator", "file://" + os.path.join(d, "store"),
              "--num-processes", str(world), "--process-id", str(rank),
              "rgbd", "--config", os.path.join(d, "cfg.json")])
    out = _rank_fast(rank, world, d)
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)


def _rank_fast(rank, world, d):
    from tpu3drec_torch.parallel import multihost as mh
    from tpu3drec_torch.pipelines import rgbd
    from tpu3drec_torch.pipelines.kitti import _allgather_window_locals
    from tpu3drec_torch.utils.config import RGBDPipelineConfig, from_dict

    out = {}
    assert mh.is_distributed() and mh.process_count() == world
    assert mh.init_distributed("file://unused", world, rank) is False  # a second call
    s = mh.process_slice(17)
    out["slice"] = np.array([s.start, s.stop])
    out["allgather"] = mh.process_allgather(np.full(2, rank + 1.0, np.float32))

    # sharded writers: each process writes only its slice
    N = 10
    pts = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    sl = mh.process_slice(N)
    mh.write_ply_sharded(os.path.join(d, "cloud.ply"), pts[sl])
    mh.write_ply_sharded(os.path.join(d, "parts.ply"), pts[sl], binary=True, merge=False)
    keys = np.stack([np.arange(N), np.zeros(N), np.zeros(N)], axis=1).astype(np.int32)
    out["bt_nodes"] = np.array(mh.write_bt_sharded(os.path.join(d, "map.bt"), keys[sl], 0.5))
    # free space: each process sees the others' occupied voxels as free
    free = keys[(np.arange(N) + 3 * (rank + 1)) % N][:4] + np.array([0, 1, 0], np.int32)
    free = np.concatenate([free, keys[:2]])  # occupied elsewhere: occupied wins
    out["bt_free_nodes"] = np.array(mh.write_bt_sharded(
        os.path.join(d, "map_free.bt"), keys[sl], 0.5, free_keys=free))
    out["free"] = free

    # the max_points quirk of the reference: the cap cuts each process's cloud
    with open(os.path.join(d, "cfg.json")) as f:
        cfg = from_dict(RGBDPipelineConfig, json.load(f))
    cfg.map.max_points = MAX_POINTS
    cfg.out_ply, cfg.out_bt = os.path.join(d, "cap.ply"), ""
    res = rgbd.run(cfg, device="cpu")
    out["cap_points"] = np.array(res.n_points)

    # window poses: float64 in, exchanged as float32, global window order
    n_windows, size = 7, 5
    my = range(*mh.process_slice(n_windows).indices(n_windows))
    rng = np.random.default_rng(100 + rank)
    locals_ = [None] * n_windows
    for w in my:
        if w == 3:
            continue  # a window that failed
        locals_[w] = {2 * w + f: rng.normal(size=(4, 4)) for f in range(size - w % 2)}
        out[f"win{w}"] = np.stack([locals_[w][f] for f in sorted(locals_[w])])
    got = _allgather_window_locals(locals_, list(my), size)
    out["win_none"] = np.array([g is None for g in got])
    for w, g in enumerate(got):
        if g is not None:
            out[f"got{w}_frames"] = np.array(sorted(g))
            out[f"got{w}"] = np.stack([g[f] for f in sorted(g)])
    return out


def _rank_kitti(rank, world, d):
    from tpu3drec_torch.parallel.multihost import init_distributed
    from tpu3drec_torch.pipelines.kitti import KittiRunConfig, run_windowed_sfm

    assert init_distributed("file://" + os.path.join(d, "store"), world, rank)
    images, K = np.load(os.path.join(d, "images.npy")), np.load(os.path.join(d, "K.npy"))
    cfg = KittiRunConfig(window=6, stride=3, max_keypoints=192, loop_closure=False)
    Ts, recs = run_windowed_sfm(images, K, cfg, device="cpu")
    out = {f"T{i}": T for i, T in enumerate(Ts) if T is not None}
    out["owned"] = np.array(len(recs))
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)


def _train_batch(it, B, H, W):
    batch = {}
    for ki, k in enumerate(("target", "prev", "next")):
        batch[k] = np.random.default_rng(1000 * it + ki).uniform(
            size=(B, H, W, 3)).astype(np.float32)
    return batch


def _rank_train(rank, world, d):
    """Data-parallel training, 3 steps: each rank feeds its slice of a
    deterministic global batch; every rank ends with the same parameters."""
    import torch

    from tpu3drec_torch.models import training as tt
    from tpu3drec_torch.parallel.mesh import make_mesh
    from tpu3drec_torch.parallel.multihost import init_distributed

    assert init_distributed("file://" + os.path.join(d, "store"), world, rank)
    H, W, B = 64, 96, 4
    cfg = tt.TrainConfig(height=H, width=W, batch_size=B)
    mesh = make_mesh(data=world, device="cpu") if world > 1 else None
    model, state = tt.init_state(0, cfg, 10, device="cpu")
    step = tt.make_train_step(cfg, mesh=mesh)
    b = B // world
    for it in range(3):
        full = _train_batch(it, B, H, W)
        batch = {k: v[rank * b:(rank + 1) * b] for k, v in full.items()}
        noise = np.random.default_rng(7 + it).normal(size=(2, B, H, W)).astype(np.float32)
        state, loss, _ = step(state, batch, noise=torch.as_tensor(noise))
    norm = float(sum(np.linalg.norm(p.detach().numpy().astype(np.float64))
                     for p in model.parameters()))
    np.savez(os.path.join(d, f"rank{rank}.npz"), norm=np.array(norm), loss=loss.numpy())


# -------------------------------------------------------------- parent side


def _dataset(tmp):
    from tpu3drec.data.capture_sim import CaptureSim, SimScene
    from tpu3drec.utils.config import CameraConfig

    rng = np.random.default_rng(3)
    scene = SimScene.clustered(rng, n_landmarks=120, sats=3)
    cam = CameraConfig(fx=110.0, fy=110.0, cx=64.0, cy=48.0, width=128, height=96)
    sim = CaptureSim(scene, cam=cam)
    ds = tmp / "ds"
    sim.capture(str(ds), sim.fly(N_FRAMES, step=np.array([0.4, 0.0, 0.25]), yaw_rate=0.01))
    cfg = {
        "camera": {"fx": 110.0, "fy": 110.0, "cx": 64.0, "cy": 48.0, "width": 128, "height": 96},
        "depth": {"mode": "uint16_mm"},
        "map": {"voxel_res": 0.5, "min_depth": 0.1, "max_depth": 55.0},
        "pose_file": str(ds / "poses.txt"),
        "depth_dir": str(ds / "depth"),
        "out_ply": str(tmp / "mh.ply"),
        "out_bt": str(tmp / "mh.bt"),
    }
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    cfg = _dataset(d)
    ranks = run_world(os.path.abspath(__file__), d, world=WORLD, timeout=300)
    return d, cfg, ranks


def _jax_rgbd(d, cfg, **changes):
    from tpu3drec.pipelines import rgbd
    from tpu3drec.utils.config import RGBDPipelineConfig, from_dict

    c = from_dict(RGBDPipelineConfig, json.loads(json.dumps(cfg)))
    for k, v in changes.items():
        if k == "max_points":
            c.map.max_points = v
        else:
            setattr(c, k, v)
    return rgbd.run(c)


def test_process_slice_partitions_exactly():
    from tpu3drec_torch.parallel.multihost import process_slice

    s = process_slice(17)
    assert (s.start, s.stop) == (0, 17)


def test_init_distributed_noop_single_process(monkeypatch):
    from tpu3drec_torch.parallel import multihost as mh

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert mh.init_distributed() is False  # no coordinator, no torchrun environment
    assert not mh.is_distributed() and mh.process_count() == 1
    mh.barrier("nothing to wait for")
    np.testing.assert_array_equal(mh.process_allgather(np.arange(3)), [[0, 1, 2]])
    with pytest.raises(ValueError):
        mh.init_distributed("localhost:1", 2)  # the process id is missing


def test_process_slice_balance_and_allgather(world):
    _, _, ranks = world
    slices = [tuple(r["slice"]) for r in ranks]
    assert slices == [(0, 5), (5, 9), (9, 13), (13, 17)]  # the first 17 % 4 take one more
    for r in ranks:
        np.testing.assert_array_equal(r["allgather"], [[1, 1], [2, 2], [3, 3], [4, 4]])


def test_sharded_writers(world):
    from tpu3drec.mapping.btio import write_bt as jwrite_bt
    from tpu3drec_torch.mapping.btio import read_bt
    from tpu3drec_torch.utils.plyio import read_ply

    d, _, ranks = world
    pts, _ = read_ply(str(d / "cloud.ply"))
    np.testing.assert_array_equal(pts, np.arange(30, dtype=np.float32).reshape(10, 3))
    manifest = (d / "parts.ply.manifest").read_text().split()
    assert manifest == [f"parts.part{i:04d}-of-0004.ply" for i in range(WORLD)]
    parts = np.concatenate([read_ply(str(d / m))[0] for m in manifest])
    np.testing.assert_array_equal(parts, pts)
    assert not [p for p in os.listdir(d) if ".part" in p and not p.startswith("parts.")]
    keys, _ = read_bt(str(d / "map.bt"))
    assert len(np.unique(keys, axis=0)) == 10
    assert int(ranks[0]["bt_nodes"]) > 0 and all(int(r["bt_nodes"]) == -1 for r in ranks[1:])
    # the union, occupied winning over free, is what the JAX package writes
    occ = np.stack([np.arange(10), np.zeros(10), np.zeros(10)], 1).astype(np.int32)
    free = np.unique(np.concatenate([r["free"] for r in ranks]), axis=0)
    free = np.asarray([k for k in free if tuple(k) not in {tuple(o) for o in occ}], np.int32)
    ref = d / "ref_free.bt"
    assert int(ranks[0]["bt_free_nodes"]) == jwrite_bt(str(ref), occ, 0.5, free_keys=free)
    assert (d / "map_free.bt").read_bytes() == ref.read_bytes()


def test_rgbd_pipeline_matches_single(world):
    """The frame-sharded pipeline through the CLI on 4 processes: the
    merged `.bt` byte-equal to the JAX package's single-process run, the
    merged PLY the same point set."""
    from tpu3drec_torch.utils.plyio import read_ply

    d, cfg, _ = world
    ref = _jax_rgbd(d, cfg, out_ply=str(d / "sp.ply"), out_bt=str(d / "sp.bt"))
    assert ref.n_frames == N_FRAMES
    assert (d / "mh.bt").read_bytes() == (d / "sp.bt").read_bytes()
    got, _ = read_ply(str(d / "mh.ply"))
    want, _ = read_ply(str(d / "sp.ply"))
    assert got.shape == want.shape
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(want, axis=0), atol=2e-3)


def test_max_points_cuts_each_process(world):
    """The reference's quirk, mirrored: ``map.max_points`` cuts each
    process's own cloud, so the 4-process PLY holds more than the cap."""
    from tpu3drec_torch.utils.plyio import read_ply

    d, cfg, ranks = world
    counts = [int(r["cap_points"]) for r in ranks]
    assert all(c == MAX_POINTS for c in counts)
    got, _ = read_ply(str(d / "cap.ply"))
    assert got.shape[0] == sum(counts) == WORLD * MAX_POINTS
    ref = _jax_rgbd(d, cfg, out_ply=str(d / "sp_cap.ply"), out_bt="", max_points=MAX_POINTS)
    assert ref.n_points == MAX_POINTS


def test_window_poses_exchanged_as_float32(world):
    _, _, ranks = world
    sent = {}
    for r in ranks:
        for k in r:
            if k.startswith("win") and k != "win_none":
                sent[int(k[3:])] = r[k]
    assert sorted(sent) == [0, 1, 2, 4, 5, 6]
    for r in ranks:
        assert list(r["win_none"]) == [w not in sent for w in range(7)]
        for w, mats in sent.items():
            np.testing.assert_array_equal(r[f"got{w}_frames"], 2 * w + np.arange(len(mats)))
            got = r[f"got{w}"]
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, mats.astype(np.float32).astype(np.float64))


def test_dryrun_multichip_tool():
    """`tools/dryrun_multichip_torch.py`, the analogue of
    `__graft_entry__.py::dryrun_multichip`, on 4 CPU ranks: every rank
    finishes with finite results and the same data-parallel loss."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, os.path.join(root, "tools", "dryrun_multichip_torch.py"),
                        "--ranks", "4", "--device", "cpu"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[dryrun rank")]
    assert len(lines) == 4
    losses = {ln.split("loss=")[1].split()[0] for ln in lines}
    assert len(losses) == 1 and np.isfinite(float(losses.pop()))
    assert all("ring_d2_max=" in ln and "ba_landmark_cost=" in ln for ln in lines)


# ------------------------------------------------------------------ slow


@pytest.mark.slow
def test_two_process_windowed_sfm_matches_single(tmp_path):
    """Window-sharded SfM: 2 processes each reconstruct half the windows;
    the gathered and stitched trajectory matches the single-process run
    (float32 pose exchange: within 1e-4)."""
    from tpu3drec.data.capture_sim import CaptureSim, SimScene, render_frame
    from tpu3drec.utils.config import CameraConfig
    from tpu3drec_torch.pipelines.kitti import KittiRunConfig, run_windowed_sfm

    rng = np.random.default_rng(11)
    scene = SimScene.clustered(rng, n_landmarks=420, sats=4,
                               extent=((-25, -6, 8), (40, 6, 60)))
    cam = CameraConfig(fx=220.0, fy=220.0, cx=128.0, cy=96.0, width=256, height=192)
    sim = CaptureSim(scene, cam=cam)
    poses = sim.fly(12, step=np.array([0.55, 0.0, 0.35]), yaw_rate=0.01)
    frames = [render_frame(scene, R, t, cam) for R, t in poses]
    images = np.stack([f[0].mean(-1).astype(np.float32) / 255.0 for f in frames])
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    np.save(tmp_path / "images.npy", images)
    np.save(tmp_path / "K.npy", K)
    ranks = run_world(os.path.abspath(__file__), tmp_path, world=2, timeout=900,
                      extra_args=("kitti",))
    owned = [int(r["owned"]) for r in ranks]
    assert all(n >= 1 for n in owned) and sum(owned) >= 2
    cfg = KittiRunConfig(window=6, stride=3, max_keypoints=192, loop_closure=False)
    Ts_sp, _ = run_windowed_sfm(images, K, cfg, device="cpu")
    for r in ranks:
        for i, T in enumerate(Ts_sp):
            if T is None:
                assert f"T{i}" not in r
            else:
                np.testing.assert_allclose(r[f"T{i}"], T, atol=1e-4)


@pytest.mark.slow
def test_two_process_data_parallel_training(tmp_path):
    """2 processes each feed their half of the batch; both end with the
    same parameters, those of a single-process run on the global batch."""
    runs = {}
    for name, world in (("mp", 2), ("sp", 1)):
        (tmp_path / name).mkdir()
        runs[name] = run_world(os.path.abspath(__file__), tmp_path / name, world=world,
                               timeout=900, extra_args=("train",))
    ranks, single = runs["mp"], runs["sp"]
    assert float(ranks[0]["norm"]) == float(ranks[1]["norm"])
    n_sp, n_mp = float(single[0]["norm"]), float(ranks[0]["norm"])
    assert abs(n_sp - n_mp) / max(abs(n_sp), 1e-9) < 1e-4, (n_sp, n_mp)


if __name__ == "__main__":
    _rank_main(sys.argv)
