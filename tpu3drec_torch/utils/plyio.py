"""ASCII/binary PLY point-cloud and mesh writers and readers (port of
`tpu3drec/utils/plyio.py`).

Output is byte-identical to the JAX package's: the same header, ``%.4f``
ASCII coordinates, or binary_little_endian records. ASCII point clouds go
through the native library (`utils/native.py`) unless
``backend="python"``; both give the same bytes. Writers are host-side: map
export is the one place the engine touches disk, fed from device buffers in
a single transfer.
"""

from __future__ import annotations

import io
import os

import numpy as np

_ASCII_HEADER = """ply
format ascii 1.0
comment generated by tpu3drec
element vertex {n}
property float x
property float y
property float z
{rgb_props}end_header
"""

_BINARY_HEADER = """ply
format binary_little_endian 1.0
comment generated by tpu3drec
element vertex {n}
property float x
property float y
property float z
{rgb_props}end_header
"""

_RGB_PROPS = "property uchar red\nproperty uchar green\nproperty uchar blue\n"


def write_ply(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = False,
    backend: str = "auto",
) -> None:
    """Write an (N, 3) float point cloud, optionally with (N, 3) uint8
    colors. ASCII coordinates are formatted %.4f, as the reference did.

    ``backend``: "auto" writes ASCII through the native library (and raises
    if it cannot be built), binary in Python; "python" writes both in
    Python."""
    if backend not in ("auto", "python"):
        raise ValueError(f"backend must be 'auto' or 'python', not {backend!r}")
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8).reshape(-1, 3)
        if colors.shape[0] != n:
            raise ValueError(f"{n} points but {colors.shape[0]} colors")
    rgb_props = _RGB_PROPS if colors is not None else ""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    if not binary and backend == "auto":
        from tpu3drec_torch.utils import native

        native.ply_write_ascii(path, points, colors)
        return

    if binary:
        with open(path, "wb") as f:
            f.write(_BINARY_HEADER.format(n=n, rgb_props=rgb_props).encode("ascii"))
            if colors is None:
                f.write(points.astype("<f4").tobytes())
            else:
                rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"] = points
                rec["rgb"] = colors
                f.write(rec.tobytes())
        return

    buf = io.StringIO()
    buf.write(_ASCII_HEADER.format(n=n, rgb_props=rgb_props))
    if colors is None:
        np.savetxt(buf, points, fmt="%.4f %.4f %.4f")
    else:
        merged = np.concatenate([points, colors.astype(np.float32)], axis=1)
        np.savetxt(buf, merged, fmt="%.4f %.4f %.4f %d %d %d")
    with open(path, "w") as f:
        f.write(buf.getvalue())


def write_ply_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
                   binary: bool = False) -> None:
    """Write an indexed triangle mesh (MeshLab-compatible), the mesh
    counterpart of `write_ply` for the MVS pipeline (`mvs/`)."""
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        f"ply\nformat {fmt} 1.0\ncomment generated by tpu3drec\n"
        f"element vertex {verts.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {faces.shape[0]}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(verts.astype("<f4").tobytes())
            rec = np.zeros(faces.shape[0], dtype=[("n", "u1"), ("idx", "<i4", 3)])
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())
        return
    buf = io.StringIO()
    buf.write(header)
    np.savetxt(buf, verts, fmt="%.4f %.4f %.4f")
    np.savetxt(buf, np.concatenate([np.full((faces.shape[0], 1), 3, np.int32), faces], axis=1),
               fmt="%d")
    with open(path, "w") as f:
        f.write(buf.getvalue())


def read_ply_mesh(path: str):
    """Read a mesh written by `write_ply_mesh`. Returns (verts (V, 3)
    float32, faces (T, 3) int32)."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
            if len(header_lines) > 100:
                raise ValueError("PLY header not terminated")
        fmt, nv, nf = "ascii", 0, 0
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element" and parts[1] == "vertex":
                nv = int(parts[2])
            elif parts[0] == "element" and parts[1] == "face":
                nf = int(parts[2])
        if fmt == "ascii":
            text = f.read().decode("ascii").splitlines()
            verts = np.loadtxt(io.StringIO("\n".join(text[:nv])), ndmin=2,
                               dtype=np.float32)[:, :3]
            faces = np.loadtxt(io.StringIO("\n".join(text[nv:nv + nf])), ndmin=2,
                               dtype=np.int64)[:, 1:4]
            return verts, faces.astype(np.int32)
        if fmt == "binary_little_endian":
            verts = np.frombuffer(f.read(nv * 12), dtype="<f4").reshape(nv, 3).copy()
            rec = np.frombuffer(f.read(nf * 13), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            return verts, rec["idx"].copy()
        raise ValueError(f"unsupported PLY format {fmt}")


def read_ply(path: str):
    """Read an ASCII or binary_little_endian PLY. Returns
    (points float32 (N,3), colors uint8 (N,3) | None)."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
            if len(header_lines) > 100:
                raise ValueError("PLY header not terminated")
        fmt = "ascii"
        n = 0
        props = []
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element" and parts[1] == "vertex":
                n = int(parts[2])
            elif parts[0] == "property":
                props.append((parts[1], parts[2]))
        has_rgb = any(name in ("red", "r") for _, name in props)

        if fmt == "ascii":
            data = np.loadtxt(io.BytesIO(f.read()), dtype=np.float64, max_rows=n, ndmin=2)
            pts = data[:, :3].astype(np.float32)
            colors = data[:, 3:6].astype(np.uint8) if has_rgb and data.shape[1] >= 6 else None
            return pts, colors
        if fmt == "binary_little_endian":
            if has_rgb:
                rec = np.frombuffer(f.read(n * 15), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                return rec["xyz"].copy(), rec["rgb"].copy()
            pts = np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3)
            return pts.copy(), None
        raise ValueError(f"unsupported PLY format {fmt}")
