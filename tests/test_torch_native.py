"""The port's native map-export library (`tpu3drec_torch/utils/native.py`
over `utils/csrc/native_io.cpp`) against the port's Python path and the
JAX package's ``backend="python"`` writers: byte-equal `.bt` (from keys,
keys with carved free space, and points) and ASCII PLY (with and without
colours).

The JAX package is used only through its Python path, which never builds
or loads `native/` (xdist workers would race its ``make``); the port builds
its own copy of the source into ``build/tpu3drec_torch/``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu3drec.mapping import btio as jbt
from tpu3drec.utils import plyio as jply
from tpu3drec_torch.mapping import btio as tbt
from tpu3drec_torch.ops import build
from tpu3drec_torch.utils import native
from tpu3drec_torch.utils import plyio as tply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _key_sets():
    rng = np.random.default_rng(3)
    cube = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return {
        "random": rng.integers(-300, 300, size=(4000, 3)),
        "dense_block": rng.integers(-6, 6, size=(3000, 3)),  # pruned subtrees
        "full_cube": cube,                                    # prunes to one leaf
        "single": np.zeros((1, 3)),
        "empty": np.zeros((0, 3)),
        "range_edges": np.array([[-(1 << 15), 0, 5], [(1 << 15) - 1, -7, 0]]),
    }


@pytest.mark.parametrize("case", list(_key_sets()))
def test_bt_from_keys_byte_equal(case, tmp_path):
    keys = _key_sets()[case].astype(np.int32)
    nat, py, jx = (str(tmp_path / f"{n}.bt") for n in ("native", "python", "jax"))
    n_nat = native.bt_write_keys(nat, keys, 0.1)
    n_auto = tbt.write_bt(str(tmp_path / "auto.bt"), keys, 0.1)
    n_py = tbt.write_bt(py, keys, 0.1, backend="python")
    n_jx = jbt.write_bt(jx, keys, 0.1, backend="python")
    assert n_nat == n_auto == n_py == n_jx
    assert _bytes(nat) == _bytes(py) == _bytes(jx) == _bytes(tmp_path / "auto.bt")


@pytest.mark.parametrize("res", [0.1, 0.25, 0.05])
def test_bt_with_free_keys_byte_equal(res, tmp_path):
    rng = np.random.default_rng(5)
    occ = rng.integers(-40, 40, size=(1500, 3)).astype(np.int32)
    free = np.concatenate([rng.integers(-40, 40, size=(3000, 3)),
                           np.stack(np.meshgrid(*[np.arange(8, 16)] * 3, indexing="ij"),
                                    -1).reshape(-1, 3)]).astype(np.int32)
    # the writers take callers' deduplicated sets: no key both occupied and free
    occ_set = {tuple(k) for k in occ}
    free = np.array([k for k in free if tuple(k) not in occ_set], np.int32)
    nat, py, jx = (str(tmp_path / f"{n}.bt") for n in ("native", "python", "jax"))
    n_nat = native.bt_write_keys(nat, occ, res, free_keys=free)
    n_py = tbt.write_bt(py, occ, res, free_keys=free)  # "auto" with free keys: Python
    n_jx = jbt.write_bt(jx, occ, res, backend="python", free_keys=free)
    assert n_nat == n_py == n_jx
    assert _bytes(nat) == _bytes(py) == _bytes(jx)
    got_occ, got_free, _ = tbt.read_bt(nat, with_free=True)
    assert {tuple(k) for k in got_occ} == occ_set
    assert {tuple(k) for k in got_free} == {tuple(k) for k in free}


@pytest.mark.parametrize("res", [0.1, 0.25])
def test_bt_from_points_byte_equal(res, tmp_path):
    """The points entry voxelizes with floor(p * (1 / res)) in float64."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-20, 20, size=(20_000, 3)).astype(np.float32)
    keys = np.floor(pts.astype(np.float64) * (1.0 / res)).astype(np.int32)
    nat, py, jx = (str(tmp_path / f"{n}.bt") for n in ("native", "python", "jax"))
    assert (native.bt_write_points(nat, pts, res) == tbt.write_bt(py, keys, res, backend="python")
            == jbt.write_bt(jx, keys, res, backend="python"))
    assert _bytes(nat) == _bytes(py) == _bytes(jx)


def test_bt_out_of_range_raises(tmp_path):
    with pytest.raises(ValueError, match="key range"):
        native.bt_write_keys(str(tmp_path / "a.bt"), np.array([[1 << 15, 0, 0]], np.int32), 0.1)
    with pytest.raises(ValueError, match="key range"):
        native.bt_write_points(str(tmp_path / "b.bt"), np.array([[1e6, 0, 0]], np.float32), 0.1)


@pytest.mark.parametrize("with_colors", [False, True])
@pytest.mark.parametrize("n", [0, 1, 5000])
def test_ascii_ply_byte_equal(with_colors, n, tmp_path):
    rng = np.random.default_rng(n)
    pts = (rng.normal(size=(n, 3)) * 30).astype(np.float32)
    if n:
        pts[0] = [-0.00001, 0.00005, -1234.56785]  # -0.0000 and rounding at the 4th digit
    rgb = rng.integers(0, 256, size=(n, 3)).astype(np.uint8) if with_colors else None
    nat, py, jx = (str(tmp_path / f"{k}.ply") for k in ("native", "python", "jax"))
    native.ply_write_ascii(nat, pts, rgb)
    tply.write_ply(str(tmp_path / "auto.ply"), pts, colors=rgb)
    tply.write_ply(py, pts, colors=rgb, backend="python")
    jply.write_ply(jx, pts, colors=rgb, backend="python")
    assert _bytes(nat) == _bytes(py) == _bytes(jx) == _bytes(tmp_path / "auto.ply")
    if n:
        got, colors = tply.read_ply(nat)
        np.testing.assert_allclose(got, pts, atol=6e-5)
        assert (colors is None) == (rgb is None)


def test_auto_takes_the_native_path(tmp_path, monkeypatch):
    """"auto" writes ASCII PLY and keys-only `.bt` through the library, and
    binary PLY in Python, as the JAX package's "auto" does."""
    calls = []
    for name in ("bt_write_keys", "ply_write_ascii"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _fn=fn, _n=name, **k:
                            (calls.append(_n), _fn(*a, **k))[1])
    keys = np.arange(30, dtype=np.int32).reshape(10, 3)
    tbt.write_bt(str(tmp_path / "a.bt"), keys, 0.1)
    tply.write_ply(str(tmp_path / "a.ply"), keys.astype(np.float32))
    tply.write_ply(str(tmp_path / "b.ply"), keys.astype(np.float32), binary=True)
    tbt.write_bt(str(tmp_path / "f.bt"), keys, 0.1, free_keys=keys + 100)
    tbt.write_bt(str(tmp_path / "p.bt"), keys, 0.1, backend="python")
    tply.write_ply(str(tmp_path / "p.ply"), keys.astype(np.float32), backend="python")
    assert calls == ["bt_write_keys", "ply_write_ascii"]


def test_unknown_backend_raises(tmp_path):
    with pytest.raises(ValueError, match="backend"):
        tbt.write_bt(str(tmp_path / "a.bt"), np.zeros((1, 3), np.int32), 0.1, backend="cpp")
    with pytest.raises(ValueError, match="backend"):
        tply.write_ply(str(tmp_path / "a.ply"), np.zeros((1, 3), np.float32), backend="native")


def test_library_builds_into_the_port_build_dir():
    lib = build.build_host(native.SOURCE)
    assert os.path.dirname(lib) == build.BUILD_DIR
    assert os.path.basename(lib).startswith("libnative_io_") and os.path.exists(lib)
    assert build.BUILD_DIR == os.path.join(ROOT, "build", "tpu3drec_torch")


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken_io.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="broken_io.cpp"):
        build.build_host(str(bad))


def test_jax_python_path_never_loads_native(tmp_path):
    """The JAX package's ``backend="python"`` writers, used as the reference
    above, neither import `tpu3drec/utils/native.py` nor build `native/`."""
    code = (
        "import sys, numpy as np\n"
        "from tpu3drec.mapping.btio import write_bt\n"
        "from tpu3drec.utils.plyio import write_ply\n"
        f"write_bt({str(tmp_path / 'a.bt')!r}, np.zeros((3, 3), np.int32), 0.1, backend='python')\n"
        f"write_ply({str(tmp_path / 'a.ply')!r}, np.zeros((3, 3), np.float32), backend='python')\n"
        "assert 'tpu3drec.utils.native' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
