"""Fused pixel->camera->world unprojection (port of `tpu3drec/core/unproject.py`).

A (F, H, W) depth stack plus (F,) camera->world poses map to an
(F*H*W, 3) world-point buffer in one pass of elementwise tensor ops, with
no host round-trips. The work is elementwise and bound by memory traffic,
so it stays plain PyTorch: the JAX package left it to XLA too.
"""

from __future__ import annotations

import torch

from tpu3drec_torch.core.camera import PinholeCamera
from tpu3drec_torch.core.fp import fma
from tpu3drec_torch.core.se3 import SE3
from tpu3drec_torch.utils.device import as_f32, resolve_device
from tpu3drec_torch.utils.tracing import count, span


def _pixel_grid(height: int, width: int, dtype, device):
    """(H, W) u and v coordinate planes."""
    u = torch.arange(width, dtype=dtype, device=device).expand(height, width)
    v = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    return u, v


def depth_to_camera_points(depth: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """Depth map (H, W) -> camera-frame points (H, W, 3):
    X=(u-cx)/fx*Z, Y=(v-cy)/fy*Z, Z=depth."""
    h, w = depth.shape[-2], depth.shape[-1]
    u, v = _pixel_grid(h, w, depth.dtype, depth.device)
    X = (u - cam.cx) / cam.fx * depth
    Y = (v - cam.cy) / cam.fy * depth
    return torch.stack([X, Y, depth], dim=-1)


def camera_to_world_points(pts_cam: torch.Tensor, cam_to_world: SE3) -> torch.Tensor:
    """Camera-frame points (..., 3) -> world frame with a cam->world SE3."""
    return (
        torch.einsum("...ij,...j->...i", cam_to_world.R, pts_cam)
        + cam_to_world.t.expand(pts_cam.shape)
    )


def _rotate_translate(R, t, X, Y, Z):
    """R @ [X, Y, Z] + t expanded per axis, one elementwise pass per output
    axis. Each row is fma(R[i,2], Z, fma(R[i,0], X, R[i,1]*Y)) + t[i]: the
    fused multiply-adds XLA forms from the same expression on the CPU, so
    the float32 points agree with the JAX package's bit for bit there."""
    return torch.stack(
        [fma(R[i][2], Z, fma(R[i][0], X, R[i][1] * Y)) + t[i] for i in range(3)],
        dim=-1,
    )


def depth_to_world_points(
    depth: torch.Tensor, cam: PinholeCamera, cam_to_world: SE3
) -> torch.Tensor:
    """Fused unproject + world transform for one frame: (H, W) -> (H, W, 3),
    with no (HW, 3) x (3, 3) matmul."""
    h, w = depth.shape[-2], depth.shape[-1]
    u, v = _pixel_grid(h, w, depth.dtype, depth.device)
    X = (u - cam.cx) / cam.fx * depth
    Y = (v - cam.cy) / cam.fy * depth
    R, t = cam_to_world.R, cam_to_world.t
    return _rotate_translate(
        [[R[i, j] for j in range(3)] for i in range(3)], [t[i] for i in range(3)],
        X, Y, depth)


def depth_to_world_points_unfused(
    depth: torch.Tensor, cam: PinholeCamera, cam_to_world: SE3
) -> torch.Tensor:
    """`depth_to_world_points` with every product and sum rounded on its
    own: (H, W) -> (H, W, 3). The two differ only in rounding. The JAX
    package fuses the expression into fmas where it compiles it (its
    fusion path: `depth_to_world_points` and `fuse_depth_maps` here), but
    its `occupancy` CLI calls it eagerly, one op at a time, with no fma;
    the port's `occupancy` calls this one so that its voxel keys, and its
    `.bt`, equal the JAX CLI's bit for bit."""
    h, w = depth.shape[-2], depth.shape[-1]
    u, v = _pixel_grid(h, w, depth.dtype, depth.device)
    X = (u - cam.cx) / cam.fx * depth
    Y = (v - cam.cy) / cam.fy * depth
    R, t = cam_to_world.R, cam_to_world.t
    return torch.stack([R[i, 0] * X + R[i, 1] * Y + R[i, 2] * depth + t[i] for i in range(3)],
                       dim=-1)


def fuse_depth_maps(
    depths,  # (F, H, W)
    Rs,      # (F, 3, 3) camera->world rotations
    ts,      # (F, 3) camera->world translations
    fx, fy, cx, cy,
    min_depth: float = 0.0,
    max_depth: float = float("inf"),
    device=None,
):
    """Whole-sequence fusion: (F, H, W) depths + per-frame cam->world poses
    -> (F*H*W, 3) world points + (F*H*W,) validity mask, on ``device``.

    Points with depth outside the open interval (min_depth, max_depth) are
    masked; the defaults keep every point, as the reference did. Spans
    ``map.to_device`` (the inputs' copies, counter ``bytes_to_device``) and
    ``map.fuse`` (`utils/tracing.py`)."""
    dev = resolve_device(device)
    with span("map.to_device"):
        depths, Rs, ts, fx, fy, cx, cy = (_to_device(x, dev)
                                          for x in (depths, Rs, ts, fx, fy, cx, cy))
    with span("map.fuse"):
        F, H, W = depths.shape
        u, v = _pixel_grid(H, W, torch.float32, dev)
        X = (u - cx) / fx * depths
        Y = (v - cy) / fy * depths
        # per-frame pose entries broadcast over (H, W)
        R = [[Rs[:, i, j, None, None] for j in range(3)] for i in range(3)]
        t = [ts[:, i, None, None] for i in range(3)]
        pts = _rotate_translate(R, t, X, Y, depths)  # (F, H, W, 3)
        valid = (depths > min_depth) & (depths < max_depth)
        return pts.reshape(-1, 3), valid.reshape(-1)


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """`as_f32`, counting the bytes of what came from the host (an array,
    a number or a tensor on another kind of device; counted on the CPU
    too, so that the count does not depend on the device)."""
    out = as_f32(x, dev)
    if not isinstance(x, torch.Tensor) or x.device.type != dev.type:
        count("bytes_to_device", out.nbytes)
    return out
