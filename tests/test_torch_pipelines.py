"""End-to-end parity of the port's pipelines (`tpu3drec_torch/pipelines/`)
with the JAX package on a 4-frame 48x64 case: the same inputs give
identical PLY and `.bt` files, from arrays, from disk and through the CLI.

The fused points agree bit for bit on the CPU (the port forms the same
fused multiply-adds XLA does), so ASCII PLY, binary PLY and the voxel keys
of the `.bt` are byte-identical. Estimated transforms (the `icp`
subcommand) agree to 1e-4, as in tests/test_torch_icp.py.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from tpu3drec.pipelines import cli as jcli
from tpu3drec.pipelines import icp_fusion as jfusion
from tpu3drec.pipelines import rgbd as jrgbd
from tpu3drec.utils import config as jconfig
from tpu3drec_torch.pipelines import cli as tcli
from tpu3drec_torch.pipelines import icp_fusion as tfusion
from tpu3drec_torch.pipelines import rgbd as trgbd
from tpu3drec_torch.utils import config as tconfig
from tpu3drec_torch.utils.plyio import read_ply, write_ply
from tpu3drec_torch.utils.poseio import PoseRecord, read_T_txt, write_pose_txt, write_T_txt

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
