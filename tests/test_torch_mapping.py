"""Parity of the port's map building (`tpu3drec_torch/mapping/`) with the
JAX package: voxel keys equal (unique sets compared as sets, counts
equal), Morton codes equal, and `.bt` files byte-identical to the JAX
package's Python writer and to the hand-derived golden bytes of
`tests/test_bt_golden.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.mapping import btio as jbt
from tpu3drec.mapping import voxel as jvox
from tpu3drec_torch.mapping import btio as tbt
from tpu3drec_torch.mapping import voxel as tvox

torch.set_num_threads(2)
SEEDS = [0, 1, 2]

# The golden streams of tests/test_bt_golden.py, derived by hand from
# octomap's writeBinaryNode semantics (that module is not imported: its
# import builds the native library).
HEADER = (
    b"# Octomap OcTree binary file\n"
    b"# (feel free to add / change comments, but leave the first line as it"
    b" is!)\n#\n"
    b"id OcTree\nsize %d\nres 0.5\ndata\n"
)
ROOT = bytes([0x00, 0xC0])
CHAIN = bytes([0x03, 0x00])
OCC_LEAF0 = bytes([0x01, 0x00])
GOLDEN_SINGLE = (17, ROOT + 14 * CHAIN + OCC_LEAF0)
GOLDEN_CUBE = (16, ROOT + 13 * CHAIN + OCC_LEAF0)
GOLDEN_FREE = (18, ROOT + 14 * CHAIN + bytes([0x09, 0x00]))


def _expect(n_nodes, payload):
    return HEADER % n_nodes + payload


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _points(rng, n, spread):
    return (rng.normal(size=(n, 3)) * spread).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("res", [0.1, 0.25, 1.0])
def test_voxelize_equal(seed, res):
    pts = _points(np.random.default_rng(seed), 2000, 20.0)
    got = tvox.voxelize(torch.from_numpy(pts), res)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvox.voxelize(jnp.asarray(pts), res)))


def _key_set(keys, mask):
    return {tuple(k) for k in np.asarray(keys)[np.asarray(mask)]}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,spread", [(1, 1.0), (500, 3.0), (4000, 40.0)])
def test_unique_voxels_sets(seed, n, spread):
    rng = np.random.default_rng(seed)
    keys = np.floor(_points(rng, n, spread)).astype(np.int32)
    keys = np.concatenate([keys, keys[: n // 2]])  # duplicates
    valid = rng.random(keys.shape[0]) < 0.8
    skeys, mask, count = tvox.unique_voxels(torch.from_numpy(keys), torch.from_numpy(valid))
    jskeys, jmask, jcount = jvox.unique_voxels(jnp.asarray(keys), jnp.asarray(valid))
    got = _key_set(skeys.numpy(), mask.numpy())
    assert got == _key_set(jskeys, jmask) == {tuple(k) for k in keys[valid]}
    assert int(count) == int(jcount) == len(got) == int(mask.sum())
    # valid unique keys come first, in sorted (z, y, x) order
    first = skeys.numpy()[mask.numpy()]
    np.testing.assert_array_equal(first, np.asarray(jskeys)[np.asarray(jmask)])


@pytest.mark.parametrize("seed", SEEDS)
def test_dedup_voxels_host(seed):
    pts = _points(np.random.default_rng(seed), 3000, 10.0)
    got = tvox.dedup_voxels_host(pts, 0.5, device="cpu")
    want = jvox.dedup_voxels_host(pts, 0.5)
    np.testing.assert_array_equal(got, want)
    c = tvox.voxel_centers(torch.from_numpy(got), 0.5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jvox.voxel_centers(jnp.asarray(got), 0.5)))


@pytest.mark.parametrize("seed", SEEDS)
def test_morton_equal(seed):
    keys = np.random.default_rng(seed).integers(0, 1 << 16, size=(1000, 3)).astype(np.uint64)
    m = tbt.morton_encode(keys)
    np.testing.assert_array_equal(m, jbt.morton_encode(keys))
    np.testing.assert_array_equal(tbt.morton_decode(m), jbt.morton_decode(m))
    np.testing.assert_array_equal(tbt.morton_decode(m), keys.astype(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spread", [2.0, 30.0])
def test_write_bt_bytes(tmp_path, seed, spread):
    rng = np.random.default_rng(seed)
    keys = np.floor(_points(rng, 3000, spread)).astype(np.int32)
    # a full 2x2x2 block, which prunes to one leaf
    cube = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"), -1).reshape(-1, 3) + 100
    keys = np.concatenate([keys, cube.astype(np.int32)])
    a, b = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    n = tbt.write_bt(a, keys, 0.25)
    assert n == jbt.write_bt(b, keys, 0.25, backend="python")
    assert _bytes(a) == _bytes(b)
    got, res = tbt.read_bt(a)
    want, jres = jbt.read_bt(b)
    assert res == jres == 0.25
    np.testing.assert_array_equal(got, want)
    assert {tuple(k) for k in got} == {tuple(k) for k in keys}


def test_write_bt_free_leaves(tmp_path):
    rng = np.random.default_rng(5)
    occ = rng.integers(-50, 50, size=(300, 3)).astype(np.int32)
    free = rng.integers(-50, 50, size=(300, 3)).astype(np.int32)
    a, b = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    tbt.write_bt(a, occ, 0.5, free_keys=free)
    jbt.write_bt(b, occ, 0.5, backend="python", free_keys=free)
    assert _bytes(a) == _bytes(b)
    for g, w in zip(tbt.read_bt(a, with_free=True), jbt.read_bt(b, with_free=True)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("case", ["single", "cube", "free"])
def test_bt_golden_bytes(tmp_path, case):
    p = str(tmp_path / f"{case}.bt")
    zero = np.zeros((1, 3), np.int32)
    if case == "single":
        n, golden = tbt.write_bt(p, zero, 0.5), GOLDEN_SINGLE
    elif case == "cube":
        keys = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"), -1).reshape(-1, 3)
        n, golden = tbt.write_bt(p, keys.astype(np.int32), 0.5), GOLDEN_CUBE
    else:
        n = tbt.write_bt(p, zero, 0.5, free_keys=np.asarray([[1, 0, 0]], np.int32))
        golden = GOLDEN_FREE
    assert n == golden[0]
    assert _bytes(p) == _expect(*golden)


def test_bt_empty_and_range(tmp_path):
    a, b = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    assert tbt.write_bt(a, np.zeros((0, 3), np.int32), 0.1) == 0
    jbt.write_bt(b, np.zeros((0, 3), np.int32), 0.1, backend="python")
    assert _bytes(a) == _bytes(b)
    keys, res = tbt.read_bt(a)
    assert keys.shape == (0, 3) and res == 0.1
    with pytest.raises(ValueError):
        tbt.write_bt(a, np.asarray([[1 << 15, 0, 0]], np.int32), 0.1)
    with open(a, "wb") as f:
        f.write(b"not a bt\n")
    with pytest.raises(ValueError):
        tbt.read_bt(a)
