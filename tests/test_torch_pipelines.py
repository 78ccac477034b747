"""End-to-end parity of the port's pipelines (`tpu3drec_torch/pipelines/`)
with the JAX package on a 4-frame 48x64 case: the same inputs give
identical PLY and `.bt` files, from arrays, from disk and through the CLI.

The fused points agree bit for bit on the CPU (the port forms the same
fused multiply-adds XLA does), so ASCII PLY, binary PLY and the voxel keys
of the `.bt` are byte-identical. Estimated transforms (the `icp`
subcommand) agree to 1e-4, as in tests/test_torch_icp.py.

The copies back to the host (`pipelines/rgbd.py::_to_host`): an array a job
returns is not overwritten by the next job, on the CPU and on a card, and
``bytes_to_host_pinned`` counts what landed in page-locked memory (none on
the CPU). On a card (marker `gpu`) the files and points equal those of a
pageable ``x.cpu().numpy()`` copy, and a repeated job pins no new host
memory. The card has neither JAX nor PIL: there the `gpu` tests run alone,
as ``PYTHONPATH=. python -m pytest --noconftest -m gpu
tests/test_torch_pipelines.py``.
"""

import os

import numpy as np
import pytest
import torch

from tpu3drec_torch.pipelines import cli as tcli
from tpu3drec_torch.pipelines import icp_fusion as tfusion
from tpu3drec_torch.pipelines import rgbd as trgbd
from tpu3drec_torch.utils import config as tconfig
from tpu3drec_torch.utils import tracing
from tpu3drec_torch.utils.plyio import read_ply, write_ply
from tpu3drec_torch.utils.poseio import PoseRecord, read_T_txt, write_pose_txt, write_T_txt

try:  # on the CPU the port is held against the JAX package; the card has none
    from PIL import Image

    from tpu3drec.pipelines import cli as jcli
    from tpu3drec.pipelines import icp_fusion as jfusion
    from tpu3drec.pipelines import rgbd as jrgbd
    from tpu3drec.utils import config as jconfig
except ImportError:
    Image = jcli = jfusion = jrgbd = jconfig = None

torch.set_num_threads(2)
F, H, W = 4, 48, 64
SEEDS = [0, 1, 2]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _inputs(rng):
    depths = rng.uniform(0.5, 50.0, size=(F, H, W)).astype(np.float32)
    depths[rng.random((F, H, W)) < 0.05] = 0.0
    q = rng.normal(size=(F, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    t = (rng.normal(size=(F, 3)) * 3).astype(np.float32)
    colors = rng.integers(0, 256, size=(F, H, W, 3)).astype(np.uint8)
    return depths, q, t, colors


def _cfgs(tmp_path, binary, **map_kw):
    d = {"camera": {"fx": 60.0, "fy": 61.5, "cx": W / 2, "cy": H / 2, "width": W, "height": H},
         "map": {"voxel_res": 0.25, "ply_binary": binary, **map_kw}}
    t = tconfig.from_dict(tconfig.RGBDPipelineConfig, d)
    j = jconfig.from_dict(jconfig.RGBDPipelineConfig, d)
    t.out_ply, t.out_bt = str(tmp_path / "t.ply"), str(tmp_path / "t.bt")
    j.out_ply, j.out_bt = str(tmp_path / "j.ply"), str(tmp_path / "j.bt")
    return t, j


def _same_outputs(t, j):
    assert _bytes(t.out_ply) == _bytes(j.out_ply)
    if t.out_bt:
        assert _bytes(t.out_bt) == _bytes(j.out_bt)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("rgb", [False, True])
def test_run_arrays_identical_files(tmp_path, seed, binary, rgb):
    depths, q, t, colors = _inputs(np.random.default_rng(seed))
    colors = colors if rgb else None
    tcfg, jcfg = _cfgs(tmp_path, binary, min_depth=1e-3, max_depth=40.0)
    res = trgbd.run_arrays(depths, q, t, tcfg, keep_points=True, colors=colors, device="cpu")
    jres = jrgbd.run_arrays(depths, q, t, jcfg, keep_points=True, colors=colors)
    assert (res.n_frames, res.n_points, res.n_voxels) == (jres.n_frames, jres.n_points, jres.n_voxels)
    np.testing.assert_array_equal(res.points, jres.points)
    _same_outputs(tcfg, jcfg)


def test_run_arrays_max_points_and_masking(tmp_path):
    depths, q, t, _ = _inputs(np.random.default_rng(3))
    tcfg, jcfg = _cfgs(tmp_path, False, min_depth=5.0, max_points=1000)
    tcfg.out_bt = jcfg.out_bt = ""
    res = trgbd.run_arrays(depths, q, t, tcfg, device="cpu")
    jres = jrgbd.run_arrays(depths, q, t, jcfg)
    assert res.n_points == jres.n_points == 1000 and res.n_voxels == 0
    _same_outputs(tcfg, jcfg)


def _dataset(tmp_path, rng, rgb):
    depth_dir, rgb_dir = tmp_path / "depth", tmp_path / "front"
    os.makedirs(depth_dir)
    os.makedirs(rgb_dir)
    records = []
    for f in range(F):
        Image.fromarray(rng.integers(1, 255, size=(H, W)).astype(np.uint8), mode="L").save(
            depth_dir / f"{f}.png")
        if rgb:
            Image.fromarray(rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)).save(
                rgb_dir / f"{f}.png")
        q = rng.normal(size=4)
        records.append(PoseRecord(f, rng.normal(size=3), q / np.linalg.norm(q), f"{f}.png"))
    pose_file = str(tmp_path / "poses.txt")
    write_pose_txt(pose_file, records)
    return pose_file, str(depth_dir), str(rgb_dir) if rgb else ""


@pytest.mark.parametrize("rgb", [False, True])
def test_run_from_disk_identical_files(tmp_path, rgb):
    pose_file, depth_dir, rgb_dir = _dataset(tmp_path, np.random.default_rng(4), rgb)
    tcfg, jcfg = _cfgs(tmp_path, False, min_depth=0.0)
    for cfg in (tcfg, jcfg):
        cfg.pose_file, cfg.depth_dir, cfg.rgb_dir = pose_file, depth_dir, rgb_dir
    res = trgbd.run(tcfg, device="cpu")
    jres = jrgbd.run(jcfg)
    assert res.n_points == jres.n_points == F * H * W
    _same_outputs(tcfg, jcfg)


def test_run_missing_rgb_frame(tmp_path):
    pose_file, depth_dir, _ = _dataset(tmp_path, np.random.default_rng(5), False)
    tcfg, _ = _cfgs(tmp_path, False)
    tcfg.pose_file, tcfg.depth_dir, tcfg.rgb_dir = pose_file, depth_dir, str(tmp_path)
    with pytest.raises(FileNotFoundError):
        trgbd.run(tcfg, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_icp_fusion_identical_files(tmp_path, seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(400, 3)) * 10).astype(np.float32)
    b = (rng.normal(size=(300, 3)) * 10).astype(np.float32)
    T = np.eye(4)
    T[:3, :3] = 1.3 * np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T[:3, 3] = rng.normal(size=3)
    t_path = str(tmp_path / "T_data.txt")
    write_T_txt(t_path, T)
    n = tfusion.run(a, b, t_path, str(tmp_path / "t.ply"), device="cpu")
    assert n == jfusion.run(a, b, t_path, str(tmp_path / "j.ply")) == 700
    assert _bytes(str(tmp_path / "t.ply")) == _bytes(str(tmp_path / "j.ply"))


def test_cli_rgbd_identical_files(tmp_path):
    pose_file, depth_dir, _ = _dataset(tmp_path, np.random.default_rng(6), False)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        f.write('{"camera": {"fx": 60.0, "fy": 61.5, "cx": 32.0, "cy": 24.0, "width": 64, '
                '"height": 48}, "map": {"voxel_res": 0.5, "min_depth": 0.0}}')
    out = {}
    for name, main, extra in (("t", tcli.main, ["--device", "cpu"]), ("j", jcli.main, [])):
        out[name] = (str(tmp_path / f"{name}.ply"), str(tmp_path / f"{name}.bt"))
        main(extra + ["rgbd", "--config", cfg, "--poses", pose_file, "--depth-dir", depth_dir,
                      "--out-ply", out[name][0], "--out-bt", out[name][1]])
    assert _bytes(out["t"][0]) == _bytes(out["j"][0])
    assert _bytes(out["t"][1]) == _bytes(out["j"][1])


def test_cli_icp_chain(tmp_path):
    """icp -> icp-fuse -> ply2bt through both CLIs."""
    rng = np.random.default_rng(8)
    a = rng.uniform([0, 0, 0], [3, 2, 1], size=(500, 3)).astype(np.float32)
    c, s = np.cos(0.08), np.sin(0.08)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    b = (1.25 * a @ R.T + [0.3, -0.2, 0.1]).astype(np.float32)
    pa, pb = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    write_ply(pa, a, binary=True)
    write_ply(pb, b, binary=True)
    paths = {}
    for name, main, extra in (("t", tcli.main, ["--device", "cpu"]), ("j", jcli.main, [])):
        T_path, merged, bt = (str(tmp_path / f"{name}{s}") for s in ("_T.txt", ".ply", ".bt"))
        main(extra + ["icp", pa, pb, "--iters", "30", "--out", T_path])
        main(extra + ["icp-fuse", pa, pb, "--T", T_path, "--out", merged])
        main(extra + ["ply2bt", merged, "--res", "0.25", "--out", bt])
        paths[name] = (T_path, merged, bt)
    T, jT = read_T_txt(paths["t"][0]), read_T_txt(paths["j"][0])
    np.testing.assert_allclose(T, jT, atol=1e-4)
    np.testing.assert_allclose(T[:3, :3], R.T / 1.25, atol=1e-3)
    merged, _ = read_ply(paths["t"][1])
    jmerged, _ = read_ply(paths["j"][1])
    assert merged.shape == jmerged.shape == (1000, 3)
    np.testing.assert_allclose(merged, jmerged, atol=2e-4)
    # ply2bt on the same input gives the same octree
    tcli.main(["--device", "cpu", "ply2bt", paths["j"][1], "--res", "0.25",
               "--out", str(tmp_path / "same.bt")])
    assert _bytes(str(tmp_path / "same.bt")) == _bytes(paths["j"][2])


def test_cli_ply2bt_max_points(tmp_path):
    pts = np.random.default_rng(9).uniform(-3, 3, size=(500, 3)).astype(np.float32)
    ply = str(tmp_path / "in.ply")
    write_ply(ply, pts)
    tcli.main(["--device", "cpu", "ply2bt", ply, "--res", "0.25", "--max-points", "200",
               "--out", str(tmp_path / "t.bt")])
    jcli.main(["ply2bt", ply, "--res", "0.25", "--max-points", "200", "--out", str(tmp_path / "j.bt")])
    assert _bytes(str(tmp_path / "t.bt")) == _bytes(str(tmp_path / "j.bt"))


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


def _port_cfg(tmp_path, tag, binary=False, out_ply=True):
    d = {"camera": {"fx": 60.0, "fy": 61.5, "cx": W / 2, "cy": H / 2, "width": W, "height": H},
         "map": {"voxel_res": 0.25, "ply_binary": binary, "min_depth": 1e-3, "max_depth": 40.0}}
    cfg = tconfig.from_dict(tconfig.RGBDPipelineConfig, d)
    cfg.out_ply = str(tmp_path / f"{tag}.ply") if out_ply else ""
    cfg.out_bt = str(tmp_path / f"{tag}.bt")
    return cfg


@pytest.mark.parametrize("device", DEVICES)
def test_kept_points_outlive_the_next_job(tmp_path, device):
    """A job's kept points are its own: the next job, on other depths of the
    same size, leaves them as they were."""
    dev = _device(device)
    first, second = _inputs(np.random.default_rng(6)), _inputs(np.random.default_rng(7))
    cfg = _port_cfg(tmp_path, "t", out_ply=False)
    res = trgbd.run_arrays(*first[:3], cfg, keep_points=True, device=dev)
    before = res.points.copy()
    nxt = trgbd.run_arrays(*second[:3], cfg, keep_points=True, device=dev)
    np.testing.assert_array_equal(res.points, before)
    assert not np.shares_memory(res.points, nxt.points)
    assert not np.array_equal(res.points, nxt.points)


@pytest.mark.parametrize("device", DEVICES)
def test_map_copies_count_their_pinned_bytes(tmp_path, device):
    """Every ``map.to_host`` span counts as pinned all its bytes on a card
    and none on the CPU."""
    dev = _device(device)
    cfg = _port_cfg(tmp_path, "t")
    tracing.drain()
    tracing.enable()
    try:
        trgbd.run_arrays(*_inputs(np.random.default_rng(8))[:3], cfg, device=dev)
    finally:
        tracing.disable()
    spans = [s for s in tracing.drain() if s.name == "map.to_host"]
    assert len(spans) == 2
    for s in spans:
        assert s.counters["bytes_to_host"] > 0
        want = s.counters["bytes_to_host"] if dev.type == "cuda" else 0
        assert s.counters["bytes_to_host_pinned"] == want


@pytest.mark.gpu
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("rgb", [False, True])
def test_card_files_equal_pageable_copies(tmp_path, monkeypatch, binary, rgb):
    """The points, PLY and `.bt` of a card's job equal those of the same job
    whose copies back are plain pageable ``x.cpu().numpy()``."""
    dev = _device("cuda")
    depths, q, t, colors = _inputs(np.random.default_rng(9))
    colors = colors if rgb else None
    cfg = _port_cfg(tmp_path, "pinned", binary)
    res = trgbd.run_arrays(depths, q, t, cfg, keep_points=True, colors=colors, device=dev)
    ref_cfg = _port_cfg(tmp_path, "pageable", binary)
    monkeypatch.setattr(trgbd, "_to_host", lambda x: x.cpu().numpy())
    ref = trgbd.run_arrays(depths, q, t, ref_cfg, keep_points=True, colors=colors, device=dev)
    assert (res.n_points, res.n_voxels) == (ref.n_points, ref.n_voxels)
    np.testing.assert_array_equal(res.points, ref.points)
    assert _bytes(cfg.out_ply) == _bytes(ref_cfg.out_ply)
    assert _bytes(cfg.out_bt) == _bytes(ref_cfg.out_bt)


@pytest.mark.gpu
def test_repeated_job_pins_no_new_host_memory(tmp_path):
    """After a first job, the same job again takes every page-locked block
    from the caching host allocator's cache: no new host allocation. Jobs
    whose kept points hold their blocks make the allocator pin new ones
    once its cache of that size runs dry (which shows that the count moves
    when a block is new), and no two of those points share memory."""
    dev = _device("cuda")
    depths, q, t, _ = _inputs(np.random.default_rng(10))
    cfg = _port_cfg(tmp_path, "t")

    def allocs():
        return torch.cuda.host_memory_stats()["num_host_alloc"]

    trgbd.run_arrays(depths, q, t, cfg, device=dev)
    before = allocs()
    res = trgbd.run_arrays(depths, q, t, cfg, device=dev)
    assert res.n_points > 0 and allocs() == before
    kept = []
    while allocs() == before and len(kept) < 8:
        kept.append(trgbd.run_arrays(depths, q, t, cfg, keep_points=True, device=dev).points)
    assert allocs() > before
    assert len({p.ctypes.data for p in kept}) == len(kept)
    assert all(np.array_equal(p, kept[0]) for p in kept)
