"""Voxel-centric TSDF fusion of depth maps, the scene2pset analogue (port
of `tpu3drec/mvs/tsdf.py`, single device).

Every voxel centre projects into the camera and gathers the depth it
lands on: one elementwise pass and one point gather per voxel and frame,
no scatter, so the result does not depend on the order of atomic adds.
Weights are KinectFusion-style running averages with the signed distance
truncated at +-trunc; voxels more than ``trunc`` behind the observed
surface are occluded and take no update. The surface is the zero crossing,
extracted by `mvs/marching.py`.

Voxel centres are origin + i * res with one rounding (`core/fp.py::fma`),
as XLA's CPU compiler contracts it, so that a voxel projects to the same
pixel as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.utils.device import as_f32, resolve_device


@dataclass
class TsdfGrid:
    """Regular TSDF grid: ``tsdf`` in [-1, 1] (units of ``trunc``),
    ``weight`` the accumulated observation count, both (X, Y, Z) float32
    tensors on one device."""

    origin: np.ndarray          # (3,) world coords of voxel (0, 0, 0)'s centre
    res: float                  # voxel edge length [m]
    trunc: float                # truncation band [m]
    tsdf: torch.Tensor          # init +1 (empty)
    weight: torch.Tensor        # init 0

    @staticmethod
    def allocate(origin, dims, res: float, trunc: float | None = None, device=None):
        dev = resolve_device(device)
        trunc = trunc if trunc is not None else 3.0 * res
        return TsdfGrid(origin=np.asarray(origin, np.float32), res=float(res),
                        trunc=float(trunc),
                        tsdf=torch.ones(tuple(dims), dtype=torch.float32, device=dev),
                        weight=torch.zeros(tuple(dims), dtype=torch.float32, device=dev))

    @staticmethod
    def around_points(points: np.ndarray, res: float, pad: float = 0.5, max_dim: int = 512,
                      device=None):
        """A grid bounding ``points`` (N, 3) with ``pad`` metres of slack,
        at most ``max_dim`` voxels along each axis."""
        lo = np.asarray(points).min(0) - pad
        hi = np.asarray(points).max(0) + pad
        dims = np.minimum(np.ceil((hi - lo) / res).astype(int) + 1, max_dim)
        return TsdfGrid.allocate(lo, tuple(int(d) for d in dims), res, device=device)


def _axes(grid: TsdfGrid):
    """Voxel-centre coordinates along x, y, z, shaped to broadcast over the
    grid: origin[k] + i * res, rounded once."""
    X, Y, Z = grid.tsdf.shape
    dev = grid.tsdf.device
    res = torch.tensor(grid.res, dtype=torch.float32, device=dev)
    out = []
    for k, n in enumerate((X, Y, Z)):
        i = torch.arange(n, dtype=torch.float32, device=dev)
        c = fp.fma(i, res.expand(n), torch.tensor(float(grid.origin[k]), dtype=torch.float32,
                                                  device=dev).expand(n))
        shape = [1, 1, 1]
        shape[k] = n
        out.append(c.view(shape))
    return out


def voxel_centers(grid: TsdfGrid) -> torch.Tensor:
    """(X, Y, Z, 3) world coordinates of the voxel centres."""
    cx, cy, cz = _axes(grid)
    shape = grid.tsdf.shape
    return torch.stack([cx.expand(shape), cy.expand(shape), cz.expand(shape)], dim=-1)


def _integrate(tsdf, weight, centers, depth, K, R, t, trunc: float,
               max_weight: float = 64.0):
    """One depth map into the grid. ``centers``: the three broadcastable
    coordinate axes of `_axes`. Returns (tsdf, weight)."""
    H, W = depth.shape
    cx, cy, cz = centers
    p = [fp.fma(R[i, 2], cz, fp.fma(R[i, 0], cx, R[i, 1] * cy)) + t[i] for i in range(3)]
    z = p[2]
    uv = [fp.fma(K[i, 2], p[2], fp.fma(K[i, 0], p[0], K[i, 1] * p[1])) for i in range(3)]
    den = torch.where(torch.abs(uv[2]) < 1e-9, uv[2].new_full((), 1e-9), uv[2])
    x, y = uv[0] / den, uv[1] / den
    xi = torch.clamp(torch.round(x).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(y).to(torch.int64), 0, H - 1)
    d_obs = depth.reshape(-1)[yi * W + xi]  # one point gather
    inb = (z > 1e-6) & (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1) & (d_obs > 0)
    sdf = d_obs - z  # + in front of the surface
    upd = inb & (sdf > -trunc)  # skip occluded voxels
    s = fp.clip(sdf / trunc, -1.0, 1.0)
    w_new = upd.to(torch.float32)
    w_tot = weight + w_new
    fused = torch.where(w_tot > 0, (tsdf * weight + s * w_new) / torch.clamp_min(w_tot, 1e-9),
                        tsdf)
    return fused, torch.clamp_max(w_tot, max_weight)


def integrate_depth_maps(grid: TsdfGrid, depths, K, Rs, ts, masks=None) -> TsdfGrid:
    """Fuse (F, H, W) depth maps (world->cam poses ``Rs`` / ``ts``) into the
    grid, frame by frame, on the grid's device. ``masks`` (F, H, W) bool
    optionally zeroes unvalidated pixels (`geometric_consistency`'s
    output). Returns a new grid."""
    dev = grid.tsdf.device
    depths = as_f32(depths, dev)
    if masks is not None:
        depths = torch.where(torch.as_tensor(masks, device=dev), depths, 0.0)
    K, Rs, ts = (as_f32(a, dev) for a in (K, Rs, ts))
    centers = _axes(grid)
    tsdf, weight = grid.tsdf, grid.weight
    for f in range(depths.shape[0]):
        tsdf, weight = _integrate(tsdf, weight, centers, depths[f], K, Rs[f], ts[f], grid.trunc)
    return TsdfGrid(grid.origin, grid.res, grid.trunc, tsdf, weight)
