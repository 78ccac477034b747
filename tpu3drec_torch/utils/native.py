"""ctypes binding of the host map-export library (port of
`tpu3drec/utils/native.py`): `.bt` from points or voxel keys (with or
without carved free keys) and ASCII PLY, from `utils/csrc/native_io.cpp`.

The library is built at the first call, never at import, by one host C++
compiler call into ``build/tpu3drec_torch/`` (`ops/build.py::build_host`).
Where the JAX package's binding returns None and its writers fall back to
Python when the library is missing, here a missing compiler or a failed
build raises with the compiler's output; only ``backend="python"`` of
`utils/plyio.py::write_ply` and `mapping/btio.py::write_bt` selects the
Python path. The files are byte-identical to that path's.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "native_io.cpp")

_lock = threading.Lock()
_lib = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_ubyte)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            from tpu3drec_torch.ops.build import build_host

            lib = ctypes.CDLL(build_host(SOURCE))
            for name, restype, argtypes in (
                    ("tpu3drec_bt_write_points", ctypes.c_int64,
                     [ctypes.c_char_p, _F32P, ctypes.c_int64, ctypes.c_double]),
                    ("tpu3drec_bt_write_keys", ctypes.c_int64,
                     [ctypes.c_char_p, _I32P, ctypes.c_int64, ctypes.c_double]),
                    ("tpu3drec_bt_write_keys_free", ctypes.c_int64,
                     [ctypes.c_char_p, _I32P, ctypes.c_int64, _I32P, ctypes.c_int64,
                      ctypes.c_double]),
                    ("tpu3drec_ply_write_ascii", ctypes.c_int,
                     [ctypes.c_char_p, _F32P, ctypes.c_int64, _U8P])):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _rows(a: np.ndarray, dtype, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{name} must be (N, 3), got {a.shape}")
    return a


def _bt_result(n: int, path: str) -> int:
    if n == -2:
        raise ValueError("voxel keys exceed octomap depth-16 key range")
    if n < 0:
        raise IOError(f"native bt write failed for {path}")
    return int(n)


def bt_write_points(path: str, points: np.ndarray, res: float) -> int:
    """Voxelize (floor(p / res) in float64), dedup, build and write a `.bt`
    in one call. Returns the node count."""
    pts = _rows(points, np.float32, "points")
    n = load().tpu3drec_bt_write_points(path.encode(), pts.ctypes.data_as(_F32P),
                                        pts.shape[0], float(res))
    return _bt_result(n, path)


def bt_write_keys(path: str, keys: np.ndarray, res: float,
                  free_keys: np.ndarray | None = None) -> int:
    """Signed voxel keys (floor(p / res) convention), and optionally carved
    free keys (occupied wins where a key is in both), -> `.bt`. Returns the
    node count."""
    k = _rows(keys, np.int32, "keys")
    lib = load()
    if free_keys is None:
        n = lib.tpu3drec_bt_write_keys(path.encode(), k.ctypes.data_as(_I32P), k.shape[0],
                                       float(res))
    else:
        fk = _rows(free_keys, np.int32, "free_keys")
        n = lib.tpu3drec_bt_write_keys_free(path.encode(), k.ctypes.data_as(_I32P), k.shape[0],
                                            fk.ctypes.data_as(_I32P), fk.shape[0], float(res))
    return _bt_result(n, path)


def ply_write_ascii(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """ASCII PLY, coordinates ``%.4f``, optional uint8 RGB."""
    pts = _rows(points, np.float32, "points")
    if colors is not None:
        rgb = _rows(colors, np.uint8, "colors")
        if rgb.shape[0] != pts.shape[0]:
            raise ValueError(f"{pts.shape[0]} points but {rgb.shape[0]} colors")
        cptr = rgb.ctypes.data_as(_U8P)
    else:
        cptr = _U8P()
    if load().tpu3drec_ply_write_ascii(path.encode(), pts.ctypes.data_as(_F32P), pts.shape[0],
                                       cptr) != 0:
        raise IOError(f"native ply write failed for {path}")
