"""Feature detection and description, batched over frames (port of
`tpu3drec/sfm/features.py`).

Multi-octave DoG extrema with edge suppression, sub-pixel refinement,
optional dominant orientation, and SIFT-style 4x4x8 descriptors with
trilinear soft binning and RootSIFT normalisation. Shapes are static: each
frame gives a fixed top-K keypoint set with a validity mask. Where the JAX
package vmaps one image over frames, the port takes an (F, H, W) batch
(a single (H, W) image works too).

Differences of form, not of result:
* ``jnp.convolve`` is a true convolution; the port sums shifted copies in
  tap order, which is a correlation. The Gaussian is symmetric, so the two
  agree. (Not ``F.conv2d``: its rounding depends on the position in the
  image and on the batch, see `_conv_valid`.)
* ``lax.approx_max_k`` and ``lax.top_k`` are exact on the CPU and put lower
  indices first on equal scores; the port uses a stable descending sort,
  which does the same (``torch.topk`` promises no order among ties, and the
  cross-octave NMS depends on it).
* Sums (blur, histograms, norms) run in PyTorch's order, not XLA's; the
  results agree to float32 rounding (tests/test_torch_features.py states
  the tolerances).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu3drec_torch.core import fp
from tpu3drec_torch.ops.quadpack import gather_corners


# ------------------------------------------------------------ scale pyramid

def gaussian_kernel1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _conv_valid(x: torch.Tensor, taps: list[float], dim: int) -> torch.Tensor:
    """'valid' 1-D filter along ``dim``, as a sum of shifted copies in tap
    order. Every output element takes the same sequence of roundings, so
    equal neighbourhoods give equal results wherever they sit (a library
    convolution's vectorised body and edge loops round differently, which
    breaks exact DoG plateaus apart)."""
    n = x.shape[dim] - len(taps) + 1
    acc = taps[0] * x.narrow(dim, 0, n)
    for i in range(1, len(taps)):
        acc = acc + taps[i] * x.narrow(dim, i, n)
    return acc


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian on (..., H, W), reflect-padded."""
    radius = max(1, int(3.0 * sigma + 0.5))
    taps = gaussian_kernel1d(sigma, radius).tolist()
    shape = img.shape
    x = img.reshape((-1, 1) + tuple(shape[-2:]))
    x = _conv_valid(F.pad(x, (0, 0, radius, radius), mode="reflect"), taps, 2)
    x = _conv_valid(F.pad(x, (radius, radius, 0, 0), mode="reflect"), taps, 3)
    return x.reshape(shape)


def dog_stack(img: torch.Tensor, num_scales: int = 4, sigma0: float = 1.6):
    """Single-octave Gaussian stack + DoG slices of (..., H, W): G
    (..., S+1, H, W), D (..., S, H, W), sigmas (S+1,)."""
    k = 2.0 ** (1.0 / max(num_scales - 1, 1))
    sigmas = [sigma0 * (k ** i) for i in range(num_scales + 1)]
    G = torch.stack([gaussian_blur(img, s) for s in sigmas], dim=-3)
    D = G[..., 1:, :, :] - G[..., :-1, :, :]
    return G, D, torch.tensor(sigmas, dtype=torch.float32, device=img.device)


def dog_stack_from_base(base: torch.Tensor, num_scales: int = 5, sigma0: float = 1.6):
    """Gaussian stack of one pyramid octave whose ``base`` already carries
    sigma0 blur (Lowe's s+3 construction: scale step 2^(1/(S-2)), blurs
    applied from the base). Returns G (..., S+1, H, W), D, sigmas."""
    k = 2.0 ** (1.0 / max(num_scales - 2, 1))
    sigmas = [sigma0 * (k ** i) for i in range(num_scales + 1)]
    gs = [base]
    for i in range(1, num_scales + 1):
        delta = sigma0 * (k ** (2 * i) - 1.0) ** 0.5
        gs.append(gaussian_blur(base, delta))
    G = torch.stack(gs, dim=-3)
    D = G[..., 1:, :, :] - G[..., :-1, :, :]
    return G, D, torch.tensor(sigmas, dtype=torch.float32, device=base.device)


# ---------------------------------------------------------------- detection

class Keypoints(NamedTuple):
    xy: torch.Tensor      # (..., K, 2) pixel coords (x, y)
    scale: torch.Tensor   # (..., K) detection sigma
    angle: torch.Tensor   # (..., K) orientation in radians (0 if upright)
    score: torch.Tensor   # (..., K) detection response
    valid: torch.Tensor   # (..., K) bool

    @staticmethod
    def from_numpy(xy, scale, angle, score, valid, device=None) -> "Keypoints":
        """The JAX package's keypoint arrays (as numpy) -> a port tuple."""
        from tpu3drec_torch.utils.device import resolve_device

        dev = resolve_device(device)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        return Keypoints(f32(xy), f32(scale), f32(angle), f32(score),
                         torch.tensor(np.asarray(valid, bool), device=dev))


def _local_extrema(D: torch.Tensor, threshold: float) -> torch.Tensor:
    """(..., S, H, W) DoG -> bool: 26-neighbourhood extrema above threshold;
    borders (scale and space) excluded."""
    S, H, W = D.shape[-3:]
    pad = F.pad(D, (1, 1, 1, 1, 1, 1))
    is_max = torch.ones_like(D, dtype=torch.bool)
    is_min = torch.ones_like(D, dtype=torch.bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == dy == dx == 0:
                    continue
                nb = pad[..., 1 + ds:1 + ds + S, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                is_max &= D >= nb
                is_min &= D <= nb
    ext = (is_max | is_min) & (torch.abs(D) > threshold)
    ext[..., 0, :, :] = False
    ext[..., -1, :, :] = False
    border = 8
    mask = torch.zeros((H, W), dtype=torch.bool, device=D.device)
    mask[border:-border, border:-border] = True
    return ext & mask


def _edge_response_ok(D: torch.Tensor, edge_ratio: float = 10.0) -> torch.Tensor:
    """Reject edge-like extrema by the 2x2 spatial Hessian trace/det test."""
    roll = torch.roll
    dxx = roll(D, -1, -1) + roll(D, 1, -1) - 2 * D
    dyy = roll(D, -1, -2) + roll(D, 1, -2) - 2 * D
    dxy = (
        roll(roll(D, -1, -2), -1, -1)
        - roll(roll(D, -1, -2), 1, -1)
        - roll(roll(D, 1, -2), -1, -1)
        + roll(roll(D, 1, -2), 1, -1)
    ) * 0.25
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    return (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first among equal values (the
    order of ``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (F, N) gathered at idx (F, ...) -> idx.shape."""
    return torch.gather(flat, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _refine(D: torch.Tensor, s, y, x) -> torch.Tensor:
    """Sub-pixel offsets: 2D quadratic fit on DoG slice s at (y, x) (F, K),
    -H^{-1} g clamped to +-0.5. Returns (F, K, 2)."""
    S, H, W = D.shape[-3:]
    Df = D.reshape(D.shape[0], -1)

    def at(dy, dx):
        return _take(Df, (s * H + y + dy) * W + x + dx)

    c = at(0, 0)
    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    hxx = at(0, 1) + at(0, -1) - 2 * c
    hyy = at(1, 0) + at(-1, 0) - 2 * c
    hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = hxx * hyy - hxy * hxy
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    ox = -(hyy * gx - hxy * gy) / det
    oy = -(-hxy * gx + hxx * gy) / det
    return torch.clamp(torch.stack([ox, oy], dim=-1), -0.5, 0.5)


def _select(D: torch.Tensor, threshold: float, k: int):
    """Extrema of (F, S, H, W) DoG -> top-k (vals, s, y, x, valid, xy)."""
    S, H, W = D.shape[-3:]
    ext = _local_extrema(D, threshold) & _edge_response_ok(D)
    score = torch.where(ext, torch.abs(D), torch.full_like(D, -math.inf))
    vals, idx = _top_k(score.reshape(D.shape[0], -1), k)
    s_idx = idx // (H * W)
    y_idx = (idx % (H * W)) // W
    x_idx = idx % W
    valid = torch.isfinite(vals)
    # clamp so the +-1 stencils stay in range (borders are already excluded)
    offsets = _refine(D, s_idx, torch.clamp(y_idx, 1, H - 2), torch.clamp(x_idx, 1, W - 2))
    xy = torch.stack([x_idx, y_idx], dim=-1).to(torch.float32) + offsets
    return vals, s_idx, y_idx, x_idx, valid, xy


def _gradient_field(G: torch.Tensor):
    """Central differences (wrapping at the border, as ``jnp.roll`` does)
    along x and y of (..., H, W)."""
    gx = (torch.roll(G, -1, -1) - torch.roll(G, 1, -1)) * 0.5
    gy = (torch.roll(G, -1, -2) - torch.roll(G, 1, -2)) * 0.5
    return gx, gy


def _mag_ori(G: torch.Tensor):
    gx, gy = _gradient_field(G)
    return fp.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx)


def _peak_angle(hist: torch.Tensor, bins: int) -> torch.Tensor:
    """Circularly smoothed (..., bins) histogram -> parabolic-interpolated
    peak angle."""
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1, keepdim=True)
    hl = torch.gather(hist, -1, (peak - 1) % bins)[..., 0]
    hc = torch.gather(hist, -1, peak)[..., 0]
    hr = torch.gather(hist, -1, (peak + 1) % bins)[..., 0]
    denom = hl - 2.0 * hc + hr
    big = torch.abs(denom) > 1e-12
    off = torch.where(big, 0.5 * (hl - hr) / torch.where(big, denom, torch.ones_like(denom)),
                      torch.zeros_like(denom))
    off = torch.clamp(off, -0.5, 0.5)
    return ((peak[..., 0].to(torch.float32) + 0.5 + off) / bins) * 2 * math.pi - math.pi


def _orientation_bin(o: torch.Tensor, bins: int) -> torch.Tensor:
    return torch.floor((o + math.pi) / (2 * math.pi) * bins).to(torch.int64) % bins


def _dominant_orientation(mag, ori, s_idx, x_idx, y_idx, radius: int = 8, bins: int = 36):
    """Gaussian-weighted 36-bin histogram of gradient orientations in a
    (2r+1)^2 window per keypoint; returns the peak angle (F, K). The window's
    x positions follow the TPU form's groups of four (start clamped to
    [0, W-4]), so border windows sample the same pixels as the reference."""
    dev = mag.device
    offs = torch.arange(-radius, radius + 1, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * (0.5 * radius) ** 2))
    S, H, W = mag.shape[-3:]
    w = 2 * radius + 1
    nx = -(-w // 4)
    ys = torch.clamp(y_idx[..., None] + offs, 0, H - 1)                        # (F, K, w)
    xg = torch.clamp(x_idx[..., None] - radius + 4 * torch.arange(nx, device=dev), 0, W - 4)
    xs = (xg[..., None] + torch.arange(4, device=dev)).flatten(-2)[..., :w]     # (F, K, w)
    idx = (s_idx[..., None, None] * H + ys[..., :, None]) * W + xs[..., None, :]
    Fn = mag.shape[0]
    m = _take(mag.reshape(Fn, -1), idx) * g
    b = _orientation_bin(_take(ori.reshape(Fn, -1), idx), bins)
    hist = torch.zeros(idx.shape[:2] + (bins,), dtype=torch.float32, device=dev)
    hist.scatter_add_(-1, b.flatten(-2), m.flatten(-2))
    return _peak_angle(hist, bins)


def _dominant_orientation_dense(mag, ori, s_idx, x_idx, y_idx, radius: int = 8,
                                bins: int = 36):
    """Dense form of `_dominant_orientation`: the windowed histogram for every
    pixel by two separable depthwise (36-group) convolutions over one-hot bin
    planes with edge-replicate padding, then one row per keypoint. Kept, as
    in the JAX package, as the cross-check of the windowed form."""
    S, H, W = mag.shape[-3:]
    w = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, device=mag.device).to(mag.dtype)
    g1 = torch.exp(-(offs ** 2) / (2.0 * (0.5 * radius) ** 2))
    b = _orientation_bin(ori, bins)
    kx = g1.view(1, 1, 1, w).expand(bins, 1, 1, w)
    ky = g1.view(1, 1, w, 1).expand(bins, 1, w, 1)
    hist = torch.zeros(s_idx.shape + (bins,), dtype=mag.dtype, device=mag.device)
    ar = torch.arange(bins, device=mag.device)
    fi = torch.arange(mag.shape[0], device=mag.device)[:, None]
    with fp.ieee_fp32():
        for s in range(S):
            planes = mag[:, s, :, :, None] * (b[:, s, :, :, None] == ar)   # (F, H, W, B)
            x = planes.permute(0, 3, 1, 2)
            x = F.conv2d(F.pad(x, (radius, radius, 0, 0), mode="replicate"), kx, groups=bins)
            x = F.conv2d(F.pad(x, (0, 0, radius, radius), mode="replicate"), ky, groups=bins)
            hsel = x.permute(0, 2, 3, 1)[fi, y_idx, x_idx]                   # (F, K, B)
            hist = hist + torch.where((s_idx == s)[..., None], hsel, torch.zeros_like(hsel))
    return _peak_angle(hist, bins)


# --------------------------------------------------------------- descriptor

def _hist_from_gradients(rgx, rgy, px, py, patch_grid: int, ori_bins: int):
    """Gradient samples (..., n, n) -> raw (..., cells^2 * ori_bins) SIFT
    histogram: Gaussian window, trilinear soft binning over the 2x2
    neighbouring cells and the 2 neighbouring orientation bins."""
    cell = patch_grid
    m = fp.sqrt(rgx * rgx + rgy * rgy)
    m = m * torch.exp(-(px ** 2 + py ** 2) / (2.0 * 0.5 ** 2))
    o = torch.atan2(rgy, rgx)
    cfy = (py + 1.0) * 0.5 * cell - 0.5
    cfx = (px + 1.0) * 0.5 * cell - 0.5
    y0 = torch.floor(cfy)
    x0 = torch.floor(cfx)
    fy = cfy - y0
    fx = cfx - x0
    ofs = (o + math.pi) / (2 * math.pi) * ori_bins - 0.5
    b0 = torch.floor(ofs)
    fb = ofs - b0
    flats, ws = [], []
    for dy_, wy_ in ((0, 1.0 - fy), (1, fy)):
        yi = y0 + dy_
        in_y = (yi >= 0) & (yi <= cell - 1)
        yc = torch.clamp(yi, 0, cell - 1).to(torch.int64)
        for dx_, wx_ in ((0, 1.0 - fx), (1, fx)):
            xi = x0 + dx_
            in_x = (xi >= 0) & (xi <= cell - 1)
            xc = torch.clamp(xi, 0, cell - 1).to(torch.int64)
            for db_, wb_ in ((0, 1.0 - fb), (1, fb)):
                bc = (b0.to(torch.int64) + db_) % ori_bins
                w = m * wy_ * wx_ * wb_ * in_y * in_x
                flats.append(((yc * cell + xc) * ori_bins + bc).expand(w.shape).flatten(-2))
                ws.append(w.flatten(-2))
    flat = torch.cat(flats, -1)
    w = torch.cat(ws, -1)
    hist = torch.zeros(w.shape[:-1] + (cell * cell * ori_bins,), dtype=w.dtype, device=w.device)
    return hist.scatter_add_(-1, flat, w)


def _finalize_descriptor(hist: torch.Tensor) -> torch.Tensor:
    """SIFT normalise-clip(0.2)-renormalise, then RootSIFT (L1 + sqrt)."""
    v = hist / torch.clamp(torch.linalg.vector_norm(hist, dim=-1, keepdim=True), min=1e-12)
    v = torch.clamp(v, max=0.2)
    v = v / torch.clamp(torch.sum(v, dim=-1, keepdim=True), min=1e-12)
    return fp.sqrt(v)


def _describe_on_stack(G: torch.Tensor, xy, s_idx, sigma, angle, valid,
                       patch_grid: int = 4, ori_bins: int = 8) -> torch.Tensor:
    """SIFT descriptors (F, K, 128) sampled from each keypoint's own slice
    of an octave's Gaussian stack G (F, S1, H, W), at octave coordinates."""
    Fn, S1, H, W = G.shape
    gx, gy = _gradient_field(G)
    g = torch.stack([gx, gy], dim=-1).reshape(Fn * S1, H, W, 2)
    n = 4 * patch_grid
    lin = (torch.arange(n, device=G.device) + 0.5) / n * 2.0 - 1.0
    py, px = torch.meshgrid(lin, lin, indexing="ij")                    # (n, n)
    ca = torch.cos(angle)[..., None, None]
    sa = torch.sin(angle)[..., None, None]
    rad = (6.0 * sigma)[..., None, None]
    sx = (ca * px - sa * py) * rad + xy[..., 0, None, None]
    sy = (sa * px + ca * py) * rad + xy[..., 1, None, None]
    xs = torch.clamp(sx, 0, W - 1)
    ys = torch.clamp(sy, 0, H - 1)
    # corner pinned to W-2/H-2 so the 2x2 block stays in range
    x0 = torch.clamp(torch.floor(xs), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(ys), 0, H - 2).to(torch.int64)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    # every (frame, slice) image stacked on the row axis
    plane = torch.arange(Fn, device=G.device)[:, None, None, None] * S1 + s_idx[..., None, None]
    v00, v01, v10, v11 = gather_corners(g.reshape(Fn * S1 * H, W, 2), plane * H + y0, x0)
    gs = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
          + v10 * (1 - wx) * wy + v11 * wx * wy)
    gxs, gys = gs[..., 0], gs[..., 1]
    rgx = ca * gxs + sa * gys
    rgy = -sa * gxs + ca * gys
    desc = _finalize_descriptor(_hist_from_gradients(rgx, rgy, px, py, patch_grid, ori_bins))
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))


def _batched(img: torch.Tensor):
    if img.ndim == 2:
        return img[None], True
    if img.ndim != 3:
        raise ValueError(f"expected (H, W) or (F, H, W) images, got {tuple(img.shape)}")
    return img, False


def _unbatch(out, single: bool):
    if not single:
        return out
    if isinstance(out, tuple) and not isinstance(out, Keypoints):
        return tuple(_unbatch(o, True) for o in out)
    if isinstance(out, Keypoints):
        return Keypoints(*(x[0] for x in out))
    return out[0]


def detect_keypoints(img: torch.Tensor, max_keypoints: int = 1024, num_scales: int = 4,
                     threshold: float = 0.006, sigma0: float = 1.6) -> Keypoints:
    """Single-octave DoG extrema -> top-K keypoints with orientation."""
    img, single = _batched(img)
    G, D, sigmas = dog_stack(img, num_scales=num_scales, sigma0=sigma0)
    vals, s_idx, y_idx, x_idx, valid, xy = _select(D, threshold, max_keypoints)
    mag, ori = _mag_ori(G)
    angle = _dominant_orientation(mag, ori, s_idx + 1, x_idx, y_idx)
    kps = Keypoints(xy=xy, scale=sigmas[s_idx + 1], angle=angle,
                    score=torch.where(valid, vals, torch.zeros_like(vals)), valid=valid)
    return _unbatch(kps, single)


def describe_keypoints(img: torch.Tensor, kps: Keypoints, patch_grid: int = 4,
                       ori_bins: int = 8) -> torch.Tensor:
    """SIFT-style descriptors (..., K, 128) sampled from the image itself."""
    img, single = _batched(img)
    if single:
        kps = Keypoints(*(x[None] for x in kps))
    desc = _describe_on_stack(img[:, None], kps.xy, torch.zeros_like(kps.valid, dtype=torch.int64),
                              kps.scale, kps.angle, kps.valid, patch_grid, ori_bins)
    return _unbatch(desc, single)


def detect_and_describe_pyramid(img: torch.Tensor, max_keypoints: int = 1024,
                                num_octaves: int = 3, num_scales: int = 5,
                                threshold: float = 0.006, sigma0: float = 1.6,
                                upright: bool = False, upsample_first: bool = True):
    """Multi-octave DoG detection + per-octave descriptors (the COLMAP-SIFT
    octave structure). Per octave o (image / 2^o), the top
    K_o = max(max_keypoints >> o, 64) extrema get descriptors from that
    octave's stack; all octaves compete in one top-``max_keypoints`` by DoG
    response, then a greedy 2 px NMS removes cross-octave duplicates.
    ``upsample_first`` prepends a 2x-upsampled octave -1. Coordinates and
    scales are in full-resolution pixels. Returns (Keypoints, desc)."""
    img, single = _batched(img)
    Fn, Hf, Wf = img.shape
    octaves = list(range(num_octaves))
    if upsample_first:
        octaves = [-1] + octaves
        base = F.interpolate(img[:, None], size=(2 * Hf, 2 * Wf), mode="bilinear",
                             align_corners=False)[:, 0]
        base = gaussian_blur(base, max(sigma0 ** 2 - 1.0, 0.25) ** 0.5)
    else:
        base = gaussian_blur(img, sigma0)

    parts = []
    for o in octaves:
        H, W = base.shape[-2:]
        if min(H, W) < 32:
            break
        k_o = max(max_keypoints >> max(o, 0), 64)
        G, D, sigmas = dog_stack_from_base(base, num_scales=num_scales, sigma0=sigma0)
        vals, s_idx, y_idx, x_idx, valid, xy_oct = _select(D, threshold, k_o)
        sg_oct = sigmas[s_idx + 1]
        if upright:
            angle = torch.zeros((Fn, k_o), dtype=torch.float32, device=img.device)
        else:
            mag, ori = _mag_ori(G)
            angle = _dominant_orientation(mag, ori, s_idx + 1, x_idx, y_idx)
        desc = _describe_on_stack(G, xy_oct, s_idx + 1, sg_oct, angle, valid)
        f = float(2 ** o)
        parts.append(((xy_oct + 0.5) * f - 0.5, sg_oct * f, angle,
                      torch.where(valid, vals, torch.full_like(vals, -math.inf)), valid, desc))
        # next octave's base: the sigma = 2 sigma0 slice, subsampled 2x
        base = G[:, num_scales - 2, ::2, ::2]

    xy, scale, angle, score, valid, desc = (torch.cat(p, dim=1) for p in zip(*parts))
    top_s, top_i = _top_k(score, max_keypoints)
    rows = torch.arange(Fn, device=img.device)[:, None]
    sel_valid = valid[rows, top_i] & torch.isfinite(top_s)
    sel_xy = xy[rows, top_i]
    # cross-octave NMS: suppressed if a higher-scored (lower row) keypoint
    # sits within 2 px
    d2 = torch.sum((sel_xy[:, :, None, :] - sel_xy[:, None, :, :]) ** 2, -1)
    close = (d2 < 2.0 ** 2) & sel_valid[:, None, :]
    tri = torch.tril(torch.ones_like(close), diagonal=-1)
    sel_valid = sel_valid & ~torch.any(close & tri, dim=2)
    kps = Keypoints(xy=sel_xy, scale=scale[rows, top_i], angle=angle[rows, top_i],
                    score=torch.where(sel_valid, top_s, torch.zeros_like(top_s)), valid=sel_valid)
    d = desc[rows, top_i]
    d = torch.where(sel_valid[..., None], d, torch.zeros_like(d))
    return _unbatch((kps, d), single)


def detect_and_describe(img: torch.Tensor, max_keypoints: int = 1024, upright: bool = False,
                        num_octaves: int = 3, **kw):
    """(H, W) or (F, H, W) grayscale -> (Keypoints, descriptors (..., K, 128)).
    Multi-octave by default; ``num_octaves=1`` is the single-octave stack;
    ``upright=True`` skips rotation normalisation."""
    if num_octaves == 1:
        kps = detect_keypoints(img, max_keypoints=max_keypoints, **kw)
        if upright:
            kps = kps._replace(angle=torch.zeros_like(kps.angle))
        return kps, describe_keypoints(img, kps)
    return detect_and_describe_pyramid(img, max_keypoints=max_keypoints,
                                       num_octaves=num_octaves, upright=upright, **kw)
