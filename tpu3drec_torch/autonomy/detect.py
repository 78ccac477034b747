"""Batched target detection for autonomous flight (port of
`tpu3drec/autonomy/detect.py`).

* `largest_blob`: threshold -> connected components -> the largest
  component's centroid and shape, the flight client's square-target
  detector (threshold 195, area priority), with a circularity gate in
  place of a polygon-vertex count.
* `detect_rings`: the ring-gate detector: Sobel edge magnitude correlated
  with a bank of annulus kernels; the argmax over (radius, y, x) gives the
  centre and radius.
* `match_templates`: normalized cross-correlation against a bank of
  templates (the number boards) as convolutions.

Components are labelled by iterating a masked 3x3 min-pool to its fixed
point, reading one "changed" flag a round. Every convolution runs in IEEE
float32 (the reference pins HIGHEST precision); every argmax takes the
first index among equal values, as the reference's does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu3drec_torch.core import fp
from tpu3drec_torch.utils.device import as_f32, resolve_device


def _min_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 min-pool with +inf edges over trailing (H, W): max_pool2d's
    implicit -inf padding, negated."""
    shape = x.shape
    y = -F.max_pool2d(-x.reshape(-1, 1, shape[-2], shape[-1]), 3, 1, 1)
    return y.reshape(shape)


def label_components(mask, device=None) -> torch.Tensor:
    """Connected components (8-neighbourhood) of a boolean mask (..., H, W).

    Returns int32 labels: the minimum linear index inside each component,
    H*W where mask is False. Labels iterate as float32 linear indices
    (exact up to 2^24) until no label changes."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=resolve_device(device))
    H, W = mask.shape[-2], mask.shape[-1]
    inf = torch.tensor(float("inf"), device=mask.device)
    idx = torch.arange(H * W, dtype=torch.float32, device=mask.device).reshape(H, W)
    labels = torch.where(mask, idx, inf)
    while True:
        new = torch.where(mask, _min_pool3(labels), inf)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return torch.where(mask, labels, torch.tensor(float(H * W), device=mask.device)).to(torch.int32)


class Blob(NamedTuple):
    cx: torch.Tensor           # centroid x (pixels)
    cy: torch.Tensor           # centroid y
    area: torch.Tensor         # pixel count
    circularity: torch.Tensor  # 4*pi*A / P^2 (1 = disk, ~0.785 = square)
    found: torch.Tensor        # bool


def _largest_component(labels: torch.Tensor, mask: torch.Tensor):
    """(B, H, W) labels -> each image's largest component (first label on
    ties): its label, area (int32) and selection mask."""
    B, H, W = labels.shape
    n = H * W + 1
    flat = labels.reshape(B, -1).long() + n * torch.arange(B, device=labels.device)[:, None]
    areas = torch.bincount(flat.reshape(-1), minlength=B * n).reshape(B, n)
    areas[:, H * W] = 0
    best = torch.argmax(areas, dim=1)
    area = areas.gather(1, best[:, None])[:, 0].to(torch.int32)
    sel = (labels == best[:, None, None]) & mask
    return best, area, sel


def _centroid(sel: torch.Tensor, area: torch.Tensor):
    """Centroid of (B, H, W) selections: integer sums over float32 counts."""
    B, H, W = sel.shape
    ys = torch.arange(H, device=sel.device)[:, None].expand(H, W)
    xs = torch.arange(W, device=sel.device).expand(H, W)
    n = torch.clamp(area, min=1).to(torch.float32)
    cx = torch.where(sel, xs, 0).sum(dim=(1, 2)).to(torch.float32) / n
    cy = torch.where(sel, ys, 0).sum(dim=(1, 2)).to(torch.float32) / n
    return cx, cy


def _blobs(mask: torch.Tensor, min_area: int) -> Blob:
    """Largest blob of each (B, H, W) mask."""
    labels = label_components(mask, device=mask.device)
    _, area, sel = _largest_component(labels, mask)
    cx, cy = _centroid(sel, area)
    # perimeter = component pixels with a non-component 4-neighbour
    pad = F.pad(sel, (1, 1, 1, 1))
    interior = pad[:, :-2, 1:-1] & pad[:, 2:, 1:-1] & pad[:, 1:-1, :-2] & pad[:, 1:-1, 2:]
    perim = (sel & ~interior).sum(dim=(1, 2)).to(torch.float32)
    circ = 4.0 * math.pi * area.to(torch.float32) / torch.clamp(perim * perim, min=1.0)
    return Blob(cx, cy, area, circ, area >= min_area)


def largest_blob_from_mask(mask, min_area: int = 16, device=None) -> Blob:
    """Largest connected component's centroid and shape stats (one (H, W)
    image)."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=resolve_device(device))
    return Blob(*(v[0] for v in _blobs(mask[None], min_area)))


def _conv_same(x: torch.Tensor, k: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``conv_general_dilated(..., "SAME")``: cross-correlation of (B, C, H, W)
    with (O, C, kh, kw), zero padding split as XLA splits it (the odd pixel
    after), in IEEE float32."""
    pads = []
    for size, ksize in ((x.shape[-1], k.shape[-1]), (x.shape[-2], k.shape[-2])):
        out = -(-size // stride)
        total = max((out - 1) * stride + ksize - size, 0)
        pads += [total // 2, total - total // 2]
    with fp.ieee_fp32():
        return F.conv2d(F.pad(x, pads), k, stride=stride)


def largest_blob(gray, thresh: float = 195.0 / 255.0, min_area: int = 16,
                 invert: bool = False, device=None) -> Blob:
    """Over a (B, H, W) gray batch in [0, 1]: 3x3 blur, binary threshold,
    largest-area blob centroid. ``invert`` for dark-on-light targets."""
    gray = as_f32(gray, resolve_device(device))
    k = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=gray.dtype, device=gray.device)
    blurred = _conv_same(gray[:, None], k)[:, 0]
    mask = blurred < thresh if invert else blurred > thresh
    return _blobs(mask, min_area)


class Ring(NamedTuple):
    cx: torch.Tensor
    cy: torch.Tensor
    radius: torch.Tensor
    score: torch.Tensor  # mean edge magnitude on the best annulus over the mean


def _sobel_mag(gray: torch.Tensor) -> torch.Tensor:
    gx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=gray.dtype, device=gray.device)
    k = torch.stack([gx, gx.T])[:, None]  # (2, 1, 3, 3)
    g = _conv_same(gray[:, None], k)
    return fp.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])


def _annulus_bank(radii: tuple, width: float, dtype) -> np.ndarray:
    rmax = int(max(radii))
    size = 2 * rmax + 1
    ys, xs = np.mgrid[-rmax:rmax + 1, -rmax:rmax + 1].astype(np.float32)
    d = np.sqrt(ys ** 2 + xs ** 2)
    bank = np.stack([(np.abs(d - r) <= width).astype(np.float32) for r in radii])
    bank /= np.maximum(bank.sum(axis=(1, 2), keepdims=True), 1.0)
    return bank.reshape(len(radii), 1, size, size).astype(dtype)


def _argmax_cell(scores: torch.Tensor):
    """First argmax over (C, H', W') per batch row: (channel, y, x, value)."""
    B, _, h, w = scores.shape
    flat = scores.reshape(B, -1)
    best = torch.argmax(flat, dim=1)
    c, rem = best // (h * w), best % (h * w)
    return c, rem // w, rem % w, flat.gather(1, best[:, None])[:, 0]


def detect_rings(gray, radii: tuple = (12, 16, 20, 26, 32, 40, 50, 60), width: float = 1.5,
                 stride: int = 2, device=None) -> Ring:
    """Ring-gate detection over a (B, H, W) gray batch: edge magnitude
    correlated with normalized annulus templates, global argmax over
    (radius, y, x). ``stride`` trades sub-pixel centre accuracy for less
    convolution work.

    ``score`` is the contrast ratio mean-edge-on-annulus / mean-edge-global:
    ~1 on structureless noise, >>1 when edges concentrate on a circle."""
    gray = as_f32(gray, resolve_device(device))
    edges = _sobel_mag(gray)
    mean_edge = torch.clamp(edges.mean(dim=(1, 2), keepdim=True), min=1e-6)
    edges = edges / mean_edge
    bank = torch.as_tensor(_annulus_bank(radii, width, np.float32), device=gray.device)
    scores = _conv_same(edges[:, None], bank, stride)  # (B, R, H/s, W/s)
    r_idx, cy, cx, score = _argmax_cell(scores)
    radii_t = torch.tensor(radii, dtype=torch.float32, device=gray.device)
    return Ring(cx.to(torch.float32) * stride, cy.to(torch.float32) * stride, radii_t[r_idx],
                score)


class TemplateMatch(NamedTuple):
    index: torch.Tensor  # best template id per image
    cx: torch.Tensor
    cy: torch.Tensor
    score: torch.Tensor  # NCC in [-1, 1]


def match_templates(gray, templates, device=None) -> TemplateMatch:
    """Normalized cross-correlation of T templates (T, h, w) against a
    (B, H, W) batch, as convolutions."""
    dev = resolve_device(device)
    gray = as_f32(gray, dev)
    templates = as_f32(templates, dev)
    _, h, w = templates.shape
    t = templates - templates.mean(dim=(1, 2), keepdim=True)
    t_norm = torch.sqrt(torch.clamp((t ** 2).sum(dim=(1, 2)), min=1e-12))
    x = gray[:, None]
    with fp.ieee_fp32():
        corr = F.conv2d(x, (t / t_norm[:, None, None])[:, None])  # (B, T, H', W')
        ones = torch.ones((1, 1, h, w), dtype=gray.dtype, device=dev)
        s1 = F.conv2d(x, ones)
        s2 = F.conv2d(x ** 2, ones)
    n = float(h * w)
    # floor the window energy at (0.01 intensity units)^2 a pixel: in flat
    # windows the variance and the correlation are both rounding
    local_var = torch.clamp(s2 - s1 ** 2 / n, min=1e-4 * n)
    ncc = corr / torch.sqrt(local_var)
    ti, cy, cx, score = _argmax_cell(ncc)
    return TemplateMatch(ti.to(torch.int32), cx.to(torch.float32) + (w - 1) / 2.0,
                         cy.to(torch.float32) + (h - 1) / 2.0, score)


class ColorBlob(NamedTuple):
    cx: torch.Tensor
    cy: torch.Tensor
    area: torch.Tensor
    found: torch.Tensor


def detect_color_blob(rgb, channel: int = 1, dominance: float = 1.25, min_area: int = 32,
                      device=None) -> ColorBlob:
    """Dominant-channel blob (the tree detector): pixels where one channel
    exceeds ``dominance`` x both others, largest component's centroid. rgb
    is (B, H, W, 3) in [0, 1]."""
    rgb = as_f32(rgb, resolve_device(device))
    c = rgb[..., channel]
    others = [rgb[..., i] for i in range(3) if i != channel]
    mask = (c > dominance * others[0]) & (c > dominance * others[1])
    blob = _blobs(mask, min_area)
    return ColorBlob(blob.cx, blob.cy, blob.area, blob.found)
