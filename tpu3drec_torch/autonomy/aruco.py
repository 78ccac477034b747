"""Fiducial markers (ArUco original): generation, detection and decode
(port of `tpu3drec/autonomy/aruco.py`).

Largest dark quad -> principal-axis corner extraction -> exact 4-point
homography -> grid sampling -> per-row codeword decode under 4 rotations.

DICT_ARUCO_ORIGINAL: a 5x5 inner grid, each row encoding 2 id bits (row 0
most significant) with the codewords 00->10000, 01->10111, 10->01001,
11->01110, so decoding is 20 codeword comparisons and any bit flip shows
as a nonzero Hamming error.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tpu3drec_torch.autonomy.detect import _largest_component, label_components
from tpu3drec_torch.core.fp import clip, ieee_fp32
from tpu3drec_torch.utils.device import as_f32, resolve_device

_CODEWORDS = np.array(
    [[1, 0, 0, 0, 0],
     [1, 0, 1, 1, 1],
     [0, 1, 0, 0, 1],
     [0, 1, 1, 1, 0]], np.float32)


def aruco_original_dictionary(n: int = 1024) -> np.ndarray:
    """First n DICT_ARUCO_ORIGINAL 5x5 bit grids, (n, 5, 5) uint8."""
    ids = np.arange(n)
    rows = np.stack([(ids >> (2 * (4 - r))) & 3 for r in range(5)], axis=1)  # (n, 5)
    return _CODEWORDS[rows].astype(np.uint8)


def render_marker(marker_id: int, cell_px: int = 8, border_px: int = 0) -> np.ndarray:
    """Marker image in [0, 1]: 7x7 cells (a 1-cell black border around the
    5x5 code), optionally padded with a white quiet zone."""
    bits = aruco_original_dictionary(marker_id + 1)[marker_id]
    grid = np.zeros((7, 7), np.float32)
    grid[1:6, 1:6] = bits
    img = np.kron(grid, np.ones((cell_px, cell_px), np.float32))
    if border_px:
        img = np.pad(img, border_px, constant_values=1.0)
    return img


class MarkerDetection(NamedTuple):
    marker_id: torch.Tensor  # int32, -1 when no acceptable decode
    hamming: torch.Tensor    # codeword bit errors at the best rotation
    corners: torch.Tensor    # (4, 2) xy, principal-axis order
    found: torch.Tensor      # bool


def _quad_corners(sel: torch.Tensor) -> torch.Tensor:
    """Corners of a quad component: its extreme pixels along the principal
    diagonals (second-moment orientation + 45 degrees)."""
    H, W = sel.shape
    dev = sel.device
    ys = torch.arange(H, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, device=dev).expand(H, W)
    n = torch.clamp(sel.sum(), min=1).to(torch.float32)
    cx = torch.where(sel, xs, 0).sum().to(torch.float32) / n
    cy = torch.where(sel, ys, 0).sum().to(torch.float32) / n
    zero = torch.zeros((), device=dev)
    dx = torch.where(sel, xs - cx, zero)
    dy = torch.where(sel, ys - cy, zero)
    sxx = torch.sum(dx * dx) / n
    syy = torch.sum(dy * dy) / n
    sxy = torch.sum(dx * dy) / n
    theta = 0.5 * torch.atan2(2 * sxy, sxx - syy)
    angles = theta + math.pi / 4 + torch.arange(4, device=dev) * (math.pi / 2)
    c, s = torch.cos(angles), torch.sin(angles)
    proj = c[:, None, None] * (xs - cx) + s[:, None, None] * (ys - cy)
    proj = torch.where(sel[None], proj, torch.tensor(-float("inf"), device=dev))
    idx = torch.argmax(proj.reshape(4, -1), dim=1)
    return torch.stack([idx % W, idx // W], dim=1).to(torch.float32)


def _homography_from_unit_square(corners: torch.Tensor) -> torch.Tensor:
    """3x3 H mapping unit-square (u, v) -> image (x, y); corners ordered
    (0,0), (1,0), (1,1), (0,1)."""
    x, y = corners[:, 0], corners[:, 1]
    u = torch.tensor([0.0, 1.0, 1.0, 0.0], device=corners.device)
    v = torch.tensor([0.0, 0.0, 1.0, 1.0], device=corners.device)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    rows_x = torch.stack([u, v, one, zero, zero, zero, -u * x, -v * x], dim=1)
    rows_y = torch.stack([zero, zero, zero, u, v, one, -u * y, -v * y], dim=1)
    A = torch.stack([rows_x, rows_y], dim=1).reshape(8, 8)
    h = torch.linalg.solve(A, corners.reshape(-1))
    return torch.cat([h, torch.ones(1, device=corners.device)]).reshape(3, 3)


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    x0 = clip(torch.floor(x), 0, W - 2).to(torch.int64)
    y0 = clip(torch.floor(y), 0, H - 2).to(torch.int64)
    fx = clip(x - x0, 0.0, 1.0)
    fy = clip(y - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _sample_grid(gray: torch.Tensor, corners: torch.Tensor, cells: int = 7) -> torch.Tensor:
    """Mean intensity of each of cells x cells marker cells (the corners
    bound the outer black border), from a 3x3 subsample per cell."""
    dev = gray.device
    Hm = _homography_from_unit_square(corners)
    sub = (torch.arange(3, dtype=torch.float32, device=dev) + 1.0) / 4.0
    u = ((torch.arange(cells, dtype=torch.float32, device=dev)[:, None] + sub[None])
         / cells).reshape(-1)
    uu, vv = torch.meshgrid(u, u, indexing="xy")
    with ieee_fp32():
        p = Hm @ torch.stack([uu.reshape(-1), vv.reshape(-1), torch.ones_like(uu).reshape(-1)])
    vals = _bilinear(gray, p[0] / p[2], p[1] / p[2]).reshape(cells * 3, cells * 3)
    return vals.reshape(cells, 3, cells, 3).mean(dim=(1, 3))


def _decode_bits(bits: torch.Tensor):
    """(5, 5) hard bits -> (id, hamming), minimized over the 4 rotations
    (the first rotation and the first codeword on ties)."""
    cw = torch.as_tensor(_CODEWORDS, device=bits.device)
    rots = torch.stack([torch.rot90(bits, k, dims=(0, 1)) for k in range(4)])  # (4, 5, 5)
    d = torch.abs(rots[:, :, None, :] - cw[None, None]).sum(dim=3)              # (4, 5, 4)
    pair = torch.argmin(d, dim=2)                                               # (4, 5)
    errs = d.min(dim=2).values.sum(dim=1)                                       # (4,)
    weights = 4 ** torch.arange(4, -1, -1, device=bits.device)
    ids = (pair * weights).sum(dim=1).to(torch.int32)
    k = torch.argmin(errs)
    return ids[k], errs[k]


def decode_marker(gray, thresh: float = 0.5, min_area: int = 64, max_hamming: int = 0,
                  device=None) -> MarkerDetection:
    """Detect and decode the most prominent marker in each (H, W) image of
    a (B, H, W) batch: the marker's black border makes it the dominant dark
    component, and its quad corners give the rectifying homography."""
    gray = as_f32(gray, resolve_device(device))
    mask = gray < thresh
    _, areas, sels = _largest_component(label_components(mask, device=gray.device), mask)
    out = []
    for img, area, sel in zip(gray, areas, sels):
        corners = _quad_corners(sel)
        cm = _sample_grid(img, corners, cells=7)
        border_ok = torch.all(torch.cat([cm[0], cm[-1], cm[1:-1, 0], cm[1:-1, -1]]) < thresh)
        bits = (cm[1:6, 1:6] > thresh).to(torch.float32)
        mid, err = _decode_bits(bits)
        ok = (area >= min_area) & border_ok & (err <= max_hamming)
        out.append(MarkerDetection(torch.where(ok, mid, -1), err.to(torch.int32), corners, ok))
    return MarkerDetection(*(torch.stack(v) for v in zip(*out)))


def match_task_list(detections: MarkerDetection, task_ids) -> torch.Tensor:
    """Which of the wanted ids (the task list) this batch saw: a bool mask
    aligned with ``task_ids``."""
    task_ids = torch.as_tensor(task_ids, device=detections.marker_id.device)
    seen = torch.where(detections.found, detections.marker_id, -1)
    return (task_ids[:, None] == seen[None, :]).any(dim=1)
