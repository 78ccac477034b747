"""Parity of the port's host IO (`tpu3drec_torch/utils/`) with the JAX
package: PLY, pose txt and T_data.txt output is byte-identical, readers
return equal arrays, depth decoding gives equal stacks, and the config tree
reads the same JSON."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tpu3drec.utils import config as jconfig
from tpu3drec.utils import depthio as jdepth
from tpu3drec.utils import plyio as jply
from tpu3drec.utils import poseio as jpose
from tpu3drec_torch.utils import config as tconfig
from tpu3drec_torch.utils import depthio as tdepth
from tpu3drec_torch.utils import plyio as tply
from tpu3drec_torch.utils import poseio as tpose

torch.set_num_threads(2)
SEEDS = [0, 1, 2]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _cloud(rng, n):
    pts = (rng.normal(size=(n, 3)) * rng.choice([0.01, 1.0, 80.0], size=(n, 1))).astype(np.float32)
    # values at and around the %.4f rounding boundaries and signed zeros
    pts[:4] = [[0.00005, -0.00005, 0.0], [-0.0, 1.23455, -2.99995],
               [1e6, -1e-9, 0.5], [12.34565, -0.00015, 7.0]]
    return pts


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("rgb", [False, True])
def test_write_ply_bytes(tmp_path, seed, binary, rgb):
    rng = np.random.default_rng(seed)
    pts = _cloud(rng, 500)
    colors = rng.integers(0, 256, size=(500, 3)).astype(np.uint8) if rgb else None
    a, b = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tply.write_ply(a, pts, colors=colors, binary=binary)
    jply.write_ply(b, pts, colors=colors, binary=binary, backend="python")
    assert _bytes(a) == _bytes(b)
    got, got_c = tply.read_ply(a)
    want, want_c = jply.read_ply(b)
    np.testing.assert_array_equal(got, want)
    if rgb:
        np.testing.assert_array_equal(got_c, want_c)
    else:
        assert got_c is None and want_c is None


def test_write_ply_rejects_color_count(tmp_path):
    with pytest.raises(ValueError):
        tply.write_ply(str(tmp_path / "x.ply"), np.zeros((3, 3)), colors=np.zeros((2, 3)))


def _records(rng, n, mod):
    out = []
    for f in range(n):
        q = rng.normal(size=4)
        out.append(mod.PoseRecord(f, rng.normal(size=3) * 10, q / np.linalg.norm(q), f"{f:04d}.png"))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_pose_txt_bytes(tmp_path, seed):
    recs = _records(np.random.default_rng(seed), 7, tpose)
    a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tpose.write_pose_txt(a, recs)
    jpose.write_pose_txt(b, [jpose.PoseRecord(r.frame_id, r.t, r.q_xyzw, r.image_name) for r in recs])
    assert _bytes(a) == _bytes(b)
    got, want = tpose.read_pose_txt(b), jpose.read_pose_txt(b)
    assert [(r.frame_id, r.image_name) for r in got] == [(r.frame_id, r.image_name) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.t, w.t)
        np.testing.assert_array_equal(g.q_xyzw, w.q_xyzw)
    for g, w in zip(tpose.poses_to_arrays(got), jpose.poses_to_arrays(want)):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_T_txt_bytes(tmp_path, seed):
    T = np.random.default_rng(seed).normal(size=(4, 4))
    a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tpose.write_T_txt(a, T)
    jpose.write_T_txt(b, T)
    assert _bytes(a) == _bytes(b)
    np.testing.assert_array_equal(tpose.read_T_txt(a), jpose.read_T_txt(b))
    with open(a, "w") as f:
        f.write("1 2 3\n4 5 6\n")
    with pytest.raises(ValueError):
        tpose.read_T_txt(a)


def _write_depth(path, arr, mode):
    if mode == "npy":
        np.save(path, arr)
    elif mode == "float":
        Image.fromarray(arr.astype(np.float32), mode="F").save(path)
    elif mode == "green8":
        rgb = np.zeros(arr.shape + (3,), np.uint8)
        rgb[..., 1] = arr
        Image.fromarray(rgb).save(path)
    elif mode in ("uint16", "uint16_mm"):
        Image.fromarray(arr.astype(np.uint16)).save(path)
    else:
        Image.fromarray(arr.astype(np.uint8), mode="L").save(path)


@pytest.mark.parametrize("mode", ["gray8", "green8", "uint16", "uint16_mm", "npy", "float"])
@pytest.mark.parametrize("size", [None, (16, 12)])
def test_load_depth_stack(tmp_path, mode, size):
    rng = np.random.default_rng(3)
    hi = 60000 if mode.startswith("uint16") else 255
    paths = []
    for f in range(3):
        arr = rng.integers(0, hi, size=(24, 32))
        if mode == "npy":
            arr = arr.astype(np.float32)
        ext = {"npy": ".npy", "float": ".tif"}.get(mode, ".png")
        p = str(tmp_path / f"{f}{ext}")
        _write_depth(p, arr, mode)
        paths.append(p)
    got = tdepth.load_depth_stack(paths, mode=mode, scale=0.5, size=size)
    want = jdepth.load_depth_stack(paths, mode=mode, scale=0.5, size=size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_image_rgb(tmp_path):
    arr = np.random.default_rng(4).integers(0, 256, size=(24, 32, 3)).astype(np.uint8)
    p = str(tmp_path / "c.png")
    Image.fromarray(arr).save(p)
    for size in (None, (16, 12)):
        np.testing.assert_array_equal(tdepth.load_image_rgb(p, size), jdepth.load_image_rgb(p, size))


def test_unknown_depth_mode():
    with pytest.raises(ValueError):
        tdepth.load_depth("x.png", mode="bogus")


def test_config_reads_the_same_json(tmp_path):
    d = {"camera": {"fx": 220.0, "fy": 221.0, "cx": 128.0, "cy": 96.0, "width": 256, "height": 192},
         "depth": {"mode": "uint16_mm", "scale": 2.0},
         "map": {"voxel_res": 0.5, "min_depth": 0.1, "max_depth": 55.0, "ply_binary": True},
         "mesh": {"data": 2}, "pose_file": "p.txt", "out_bt": "m.bt"}
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(d, f)
    got = tconfig.load_json(tconfig.RGBDPipelineConfig, path)
    want = jconfig.load_json(jconfig.RGBDPipelineConfig, path)
    assert tconfig.to_dict(got) == jconfig.to_dict(want)
    assert tconfig.to_dict(tconfig.RGBDPipelineConfig()) == jconfig.to_dict(jconfig.RGBDPipelineConfig())
    a, b = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tconfig.save_json(got, a)
    jconfig.save_json(want, b)
    assert _bytes(a) == _bytes(b)
    cam = got.camera.to_camera(device="cpu")
    assert (float(cam.fx), cam.width, cam.height) == (220.0, 256, 192)
    assert os.path.exists(a)
