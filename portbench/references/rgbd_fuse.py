"""Plain given-pose fusion and an octomap `.bt` reader.

`world_points` is the reference's unprojection (ref/transfer/
pixel_to_camera.py: X = (u - cx) / fx Z, Y = (v - cy) / fy Z) and world
transform (the COLMAP world->camera rows inverted), in float64 with NumPy,
or in a lower precision with PyTorch for the control. `read_bt` decodes
octomap's binary tree (AbstractOcTree::writeBinary: a header, then a
preorder stream of 2-byte nodes, 2 bits per child: 01 occupied leaf, 10
free leaf, 11 inner) into the set of depth-16 voxel keys it covers.
Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

KEY_OFFSET = 1 << 15


def quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    """(F, 4) unit quaternions x, y, z, w -> (F, 3, 3) rotations, float64."""
    x, y, z, w = (np.asarray(q, np.float64)[:, i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def valid_mask(depths: np.ndarray, min_depth: float, max_depth: float) -> np.ndarray:
    """Pixels with a return: depth strictly inside (min, max), as float32."""
    d = np.asarray(depths, np.float32)
    return (d > np.float32(min_depth)) & (d < np.float32(max_depth))


def world_points(depths, q_xyzw, t, cam: dict, min_depth: float, max_depth: float,
                 dtype=None, device="cpu"):
    """World points of every valid pixel, frame by frame in row-major order.
    ``dtype=None``: NumPy float64; else PyTorch in ``dtype`` on ``device``
    (every input rounded to it first), returned as float64."""
    F, H, W = depths.shape
    R_w2c = quat_xyzw_to_matrix(q_xyzw)
    R = np.swapaxes(R_w2c, 1, 2)                       # camera -> world
    c = -np.einsum("fij,fj->fi", R, np.asarray(t, np.float64))
    valid = valid_mask(depths, min_depth, max_depth)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    if dtype is None:
        z = np.asarray(depths, np.float64)
        X = (u - cam["cx"]) / cam["fx"] * z
        Y = (v - cam["cy"]) / cam["fy"] * z
        P = np.stack([X, Y, z], -1)                    # (F, H, W, 3)
        out = np.einsum("fij,fhwj->fhwi", R, P) + c[:, None, None, :]
        return out[valid]

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device=device, dtype=dtype)

    z = T(depths)
    X = (T(u) - T(cam["cx"])) / T(cam["fx"]) * z
    Y = (T(v) - T(cam["cy"])) / T(cam["fy"]) * z
    Rt, ct = T(R), T(c)
    rows = [Rt[:, i, 0, None, None] * X + Rt[:, i, 1, None, None] * Y
            + Rt[:, i, 2, None, None] * z + ct[:, i, None, None] for i in range(3)]
    out = torch.stack(rows, -1).double().cpu().numpy()
    return out[valid]


def voxel_keys(points: np.ndarray, res: float) -> np.ndarray:
    """Sorted unique int64 codes of the voxels of float32 points, each key
    floor(p / res) with the division in float32 as the configuration states
    it (the signed key of each axis offset by 2^15 into 16 bits, packed z,
    y, x)."""
    p = np.asarray(points, np.float32)
    k = np.floor(p / np.float32(res)).astype(np.int64) + KEY_OFFSET
    return np.unique((k[:, 2] << 32) | (k[:, 1] << 16) | k[:, 0])


def read_bt(path: str):
    """(res, sorted unique int64 codes of the occupied voxels, in
    `voxel_keys`' packing). Raises ValueError on a malformed file, or where
    the header's node count differs from the stream's."""
    with open(path, "rb") as f:
        data = f.read()
    head, sep, payload = data.partition(b"\ndata\n")
    if not sep:
        raise ValueError("no data line")
    lines = head.decode("ascii").split("\n")
    if lines[0] != "# Octomap OcTree binary file":
        raise ValueError(f"first line {lines[0]!r}")
    fields = dict(line.split(" ", 1) for line in lines[1:] if line and not line.startswith("#"))
    if fields.get("id") != "OcTree":
        raise ValueError(f"tree id {fields.get('id')!r}")
    res, size = float(fields["res"]), int(fields["size"])
    codes, pos, nodes = [], 0, 1
    stack = [(0, 0, 0, 16)]  # (x, y, z) of the node's lowest key, its level
    while stack:
        x0, y0, z0, level = stack.pop()
        bits = payload[pos] | (payload[pos + 1] << 8)
        pos += 2
        half = 1 << (level - 1)
        inner = []
        for i in range(8):
            code = (bits >> (2 * i)) & 3
            if not code:
                continue
            nodes += 1
            x, y, z = x0 + (i & 1) * half, y0 + ((i >> 1) & 1) * half, z0 + ((i >> 2) & 1) * half
            if code == 3:
                inner.append((x, y, z, level - 1))
            elif code == 1:
                r = np.arange(half, dtype=np.int64)
                gz, gy, gx = np.meshgrid(z + r, y + r, x + r, indexing="ij")
                codes.append(((gz << 32) | (gy << 16) | gx).ravel())
        stack.extend(reversed(inner))
    if pos != len(payload) or nodes != size:
        raise ValueError(f"{nodes} nodes and {len(payload) - pos} bytes left; header size {size}")
    return res, np.unique(np.concatenate(codes)) if codes else np.zeros(0, np.int64)


def voxels_off(bt_path: str, points: np.ndarray, res: float) -> float:
    """Voxels in the file or among the voxels of ``points`` but not both;
    infinite for a malformed file or another resolution."""
    try:
        file_res, codes = read_bt(bt_path)
    except (ValueError, KeyError, IndexError, OSError):
        return float("inf")
    if file_res != res:
        return float("inf")
    return float(np.setxor1d(codes, voxel_keys(points, res), assume_unique=True).size)


def points_error(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest distance of a point from the reference's, as a share of the
    scene's extent; infinite where the counts differ."""
    if got is None or got.shape != ref.shape:
        return float("inf")
    return float(np.abs(got.astype(np.float64) - ref).max() / np.abs(ref).max())
