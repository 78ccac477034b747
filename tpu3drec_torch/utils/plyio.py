"""ASCII/binary PLY point-cloud writer and reader (port of
`tpu3drec/utils/plyio.py`, Python path).

Output is byte-identical to the JAX package's ``backend="python"`` writer:
the same header, ``%.4f`` ASCII coordinates, or binary_little_endian
records. Writers are host-side: map export is the one place the engine
touches disk, fed from device buffers in a single transfer.
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
) -> None:
    """Write an (N, 3) float point cloud, optionally with (N, 3) uint8
    colors. ASCII coordinates are formatted %.4f, as the reference did."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8).reshape(-1, 3)
        if colors.shape[0] != n:
            raise ValueError(f"{n} points but {colors.shape[0]} colors")
    rgb_props = _RGB_PROPS if colors is not None else ""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

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
