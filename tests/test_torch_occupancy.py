"""Parity of the port's occupancy mapping (`tpu3drec_torch/mapping/occupancy.py`
and the `occupancy` subcommand) with the JAX package, on
tests/test_occupancy.py's cases and on a voxel-edge fixture.

Tolerance: none. Keys, masks and log-odds are equal, and `.bt` files are
byte-equal: the port rounds its float32 ray sampling as XLA's CPU compiler
does (fused multiply-adds, a correctly rounded norm, a division by the
static resolution as a multiplication by its reciprocal).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.mapping import btio as jbt
from tpu3drec.mapping import occupancy as jocc
from tpu3drec_torch.mapping import btio as tbt
from tpu3drec_torch.mapping import occupancy as tocc

torch.set_num_threads(2)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rays(origin, points, res, max_samples):
    valid = np.ones(len(points), bool)
    k, ok = tocc.ray_free_voxels(_t(origin), _t(points), _t(valid, torch.bool), res, max_samples)
    jk, jok = jocc.ray_free_voxels(jnp.asarray(origin, jnp.float32), jnp.asarray(points, jnp.float32),
                                   jnp.asarray(valid), res, max_samples=max_samples)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    return k.numpy()[ok.numpy()]


def _scan(origin, points, valid, res, max_samples):
    got = tocc.scan_update(_t(origin), _t(points), _t(valid, torch.bool), res, max_samples)
    want = jocc.scan_update(jnp.asarray(origin, jnp.float32), jnp.asarray(points, jnp.float32),
                            jnp.asarray(valid), res, max_samples=max_samples)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


def _same_map(m, jm):
    np.testing.assert_array_equal(m.keys, jm.keys)
    np.testing.assert_array_equal(m.logodds, jm.logodds)
    assert m.logodds.dtype == np.float32 and m.keys.dtype == np.int32


def test_straight_ray_marks_cells():
    k = _rays(np.zeros(3), [[0.0, 0.0, 1.0]], 0.1, 32)
    zs = sorted(set(k[:, 2]))
    assert zs[0] == 0 and zs[-1] <= 9 and len(zs) >= 8
    assert (k[:, :2] == 0).all()


def test_endpoint_voxel_not_free():
    k = _rays(np.zeros(3), [[0.0, 0.0, 0.55]], 0.1, 32)
    assert 5 not in set(k[:, 2])


def test_occupied_wins_within_scan():
    skeys, m_occ, m_free = _scan(np.array([0.0, 0.0, -1.0]),
                                 np.array([[0.0, 0.0, 0.05], [0.0, 0.0, 1.0]]),
                                 np.ones(2, bool), 0.1, 64)
    occ = {tuple(r) for r in skeys[m_occ]}
    free = {tuple(r) for r in skeys[m_free]}
    assert (0, 0, 0) in occ and (0, 0, 0) not in free and not occ & free
    assert len(free) > 5


def _sample_keys(origin, pts, res, max_samples, fused=True, reciprocal=True, floor=True):
    """Sample keys (N, S, 3) of the port's ray arithmetic, or of a variant:
    the sum ``origin + u * s`` rounded twice (``fused=False``), or a true
    division by res (``reciprocal=False``); positions over res unfloored
    with ``floor=False``."""
    from tpu3drec_torch.core import fp

    d = _t(pts) - _t(origin)
    length = fp.sqrt(fp.sum_squares(d))[:, None]
    u = d / torch.clamp(length, min=1e-9)
    s = (torch.arange(max_samples, dtype=torch.float32) + 0.5) * torch.tensor(0.7 * res)
    if fused:
        pos = fp.fma(u[:, None, :], s[None, :, None], _t(origin))
    else:
        pos = _t(origin) + u[:, None, :] * s[None, :, None]
    pos = pos.reshape(len(pts), -1, 3)
    res32 = torch.tensor(res)
    q = pos * (1 / res32) if reciprocal else pos / res32
    return torch.floor(q).to(torch.int32).numpy() if floor else q.numpy()


def _edge_rays(res, max_samples=32, seed=1):
    """Rays with a sample within an ulp of a key boundary: among many random
    rays, those with a sample position over res within 2 ulps of an integer,
    and those where the two roundings of the sum or a true division pick
    another key for some sample."""
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-3, 3, 3).astype(np.float32)
    pts = (origin + rng.normal(size=(40_000, 3)) * rng.uniform(0.5, 8, (40_000, 1))).astype(np.float32)
    keys = _sample_keys(origin, pts, res, max_samples)
    q = _sample_keys(origin, pts, res, max_samples, floor=False)
    edge = (np.abs(q - np.round(q)) <= 2 * np.spacing(np.abs(q))).any(axis=(1, 2))
    for kw in (dict(fused=False), dict(reciprocal=False)):
        edge |= (_sample_keys(origin, pts, res, max_samples, **kw) != keys).any(axis=(1, 2))
    return origin, np.concatenate([pts[edge], pts[:32]])


@pytest.mark.parametrize("res", [0.1, 0.05, 0.3])
def test_voxel_edge_rays(res, tmp_path):
    """Rays whose samples land within an ulp of a key boundary give the same
    keys, scan and `.bt` bytes. The fixture is sharp: a sum rounded twice or
    a true division by res picks another key on it than the JAX package
    does (both do at 0.05 and 0.3, the division at 0.1)."""
    origin, pts = _edge_rays(res)
    _rays(origin, pts, res, 32)
    want = np.asarray(jocc.ray_free_voxels(jnp.asarray(origin), jnp.asarray(pts),
                                           jnp.ones(len(pts), bool), res, max_samples=32)[0])
    assert any((_sample_keys(origin, pts, res, 32, **kw).reshape(-1, 3) != want).any()
               for kw in (dict(fused=False), dict(reciprocal=False)))
    _scan(origin, pts, np.ones(len(pts), bool), res, 32)
    m, jm = tocc.OccupancyMap(res=res, max_samples=32, device="cpu"), \
        jocc.OccupancyMap(res=res, max_samples=32)
    m.insert_scan(origin, pts)
    jm.insert_scan(origin, pts)
    _same_map(m, jm)
    a, b = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    assert m.write_bt(a) == jm.write_bt(b)
    assert _bytes(a) == _bytes(b)


def test_logodds_accumulate_and_flip():
    m, jm = tocc.OccupancyMap(res=0.1, device="cpu"), jocc.OccupancyMap(res=0.1)
    pts = np.array([[0.0, 0.0, 1.0]], np.float32)
    for mm in (m, jm):
        mm.insert_scan(np.zeros(3), pts)
    _same_map(m, jm)
    occ = {tuple(k) for k in m.occupied_keys()}
    assert (0, 0, 9) in occ or (0, 0, 10) in occ
    assert (0, 0, 0) in {tuple(k) for k in m.free_keys()}
    hit = np.array([[0.05, 0.05, 0.05]], np.float32)
    for _ in range(3):
        for mm in (m, jm):
            mm.insert_scan(np.zeros(3), hit, with_freespace=False)
        _same_map(m, jm)
    assert (0, 0, 0) in {tuple(k) for k in m.occupied_keys()}
    np.testing.assert_array_equal(m.occupied_keys(), jm.occupied_keys())
    np.testing.assert_array_equal(m.free_keys(), jm.free_keys())


def test_clamping():
    m, jm = tocc.OccupancyMap(res=0.1, device="cpu"), jocc.OccupancyMap(res=0.1)
    hit = np.array([[0.05, 0.05, 0.05]], np.float32)
    for _ in range(50):
        m.insert_scan(np.zeros(3), hit, with_freespace=False)
        jm.insert_scan(np.zeros(3), hit, with_freespace=False)
    _same_map(m, jm)
    assert m.logodds.max() <= 3.6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scans_merge_like_the_reference(seed, tmp_path):
    """Three random scans from moving origins, some rays invalid: equal scan
    outputs (invalid rows included), map and `.bt` bytes after each."""
    rng = np.random.default_rng(seed)
    m, jm = tocc.OccupancyMap(res=0.1, max_samples=48, device="cpu"), \
        jocc.OccupancyMap(res=0.1, max_samples=48)
    for f in range(3):
        origin = rng.uniform(-1, 1, 3).astype(np.float32)
        pts = (origin + rng.normal(size=(300, 3)) * 2.0).astype(np.float32)
        valid = rng.random(300) > 0.2
        _scan(origin, pts, valid, 0.1, 48)
        m.insert_scan(origin, pts, valid)
        jm.insert_scan(origin, pts, valid)
        _same_map(m, jm)
    assert m.counts() == (len(jm.keys), len(jm.occupied_keys()), len(jm.free_keys()))
    a, b = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    assert m.write_bt(a) == jm.write_bt(b)
    assert _bytes(a) == _bytes(b)


def test_bt_roundtrip_with_free(tmp_path):
    m, jm = tocc.OccupancyMap(res=0.1, device="cpu"), jocc.OccupancyMap(res=0.1)
    m.insert_scan(np.zeros(3), np.array([[0.0, 0.0, 1.0]], np.float32))
    jm.insert_scan(np.zeros(3), np.array([[0.0, 0.0, 1.0]], np.float32))
    p, jp = str(tmp_path / "occ.bt"), str(tmp_path / "jocc.bt")
    n = m.write_bt(p)
    assert n > 0 and n == jm.write_bt(jp)
    assert _bytes(p) == _bytes(jp)
    occ, free, res = tbt.read_bt(p, with_free=True)
    assert res == 0.1
    assert {tuple(k) for k in occ} == {tuple(k) for k in m.occupied_keys()}
    assert {tuple(k) for k in free} == {tuple(k) for k in m.free_keys()}


def test_mixed_write_read_pruning(tmp_path):
    free = np.array([[x, y, z] for x in range(2) for y in range(2) for z in range(2)], np.int32)
    occ = np.array([[5, 5, 5]], np.int32)
    p, jp = str(tmp_path / "mix.bt"), str(tmp_path / "jmix.bt")
    tbt.write_bt(p, occ, 0.1, free_keys=free)
    jbt.write_bt(jp, occ, 0.1, free_keys=free)
    assert _bytes(p) == _bytes(jp)
    o2, f2, _ = tbt.read_bt(p, with_free=True)
    assert {tuple(k) for k in o2} == {(5, 5, 5)}
    assert {tuple(k) for k in f2} == {tuple(k) for k in free}


@pytest.mark.parametrize("depth_format", ["uint16_mm", "npy"])
def test_occupancy_cli_end_to_end(tmp_path, depth_format):
    """`occupancy` on capture-layout inputs through both CLIs: the `.bt`
    files are byte-equal, with PNG depth (the reference's test) and with
    `.npy` depth (what the card's machine reads, having no PIL)."""
    from tpu3drec.data.capture_sim import CaptureSim, SimScene
    from tpu3drec.pipelines.cli import main as jmain
    from tpu3drec.utils.config import CameraConfig
    from tpu3drec.utils.depthio import load_depth
    from tpu3drec_torch.pipelines.cli import main as tmain

    rng = np.random.default_rng(0)
    scene = SimScene.clustered(rng, n_landmarks=120, sats=3)
    cam = CameraConfig(fx=110.0, fy=110.0, cx=64.0, cy=48.0, width=128, height=96)
    sim = CaptureSim(scene, cam=cam)
    sim.capture(str(tmp_path), sim.fly(2, step=np.array([0.5, 0, 0.3])))
    poses = tmp_path / "poses.txt"
    if depth_format == "npy":
        (tmp_path / "depth_npy").mkdir()
        lines = poses.read_text().splitlines()
        out = [lines[0]]
        for line in lines[1:]:
            cols = line.split(",")
            name = cols[8].strip()
            d = load_depth(str(tmp_path / "depth" / name), mode="uint16_mm")
            np.save(tmp_path / "depth_npy" / (name[:-4] + ".npy"), d)
            out.append(",".join(cols[:8] + [name[:-4] + ".npy"]))
        poses = tmp_path / "poses_npy.txt"
        poses.write_text("\n".join(out) + "\n")
    cfg = {"camera": {"fx": 110.0, "fy": 110.0, "cx": 64.0, "cy": 48.0,
                      "width": 128, "height": 96},
           "depth": {"mode": depth_format}, "map": {"min_depth": 0.1}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    depth_dir = str(tmp_path / ("depth_npy" if depth_format == "npy" else "depth"))
    args = ["occupancy", "--config", str(cfg_path), "--poses", str(poses),
            "--depth-dir", depth_dir, "--res", "1.0", "--max-range", "55"]
    a, b = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    tmain(["--device", "cpu"] + args + ["--out", a])
    jmain(args + ["--out", b])
    assert _bytes(a) == _bytes(b)
    occ, free, res = tbt.read_bt(a, with_free=True)
    assert res == 1.0 and len(occ) > 50 and len(free) > len(occ)
    # the CLI's defaults: 0.1 m, 128 samples
    args = args[:-4] + ["--max-range", "55"]
    tmain(["--device", "cpu"] + args + ["--out", a])
    jmain(args + ["--out", b])
    assert _bytes(a) == _bytes(b)
