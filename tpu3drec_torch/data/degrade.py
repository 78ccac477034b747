"""Photometric capture degradations for rendered frames (port of
`tpu3drec/data/degrade.py`; numpy and `scipy.ndimage`, on the host in both
packages).

The ray-cast simulator (`capture_sim.PlanarScene`) renders geometrically
exact, noise-free frames. This module adds the dominant statistics of real
captures: per-frame motion blur along the apparent camera motion, defocus,
lens vignetting, exposure jitter and sensor noise. Degradation is part of
preparing the data, like the renderer: frames reach the device already
degraded, as real data would. With the same generator the frames equal the
JAX package's bit for bit. `tools/ate_torch.py --degrade` applies it.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def motion_direction_px(poses, cam, idx: int, depth_hint: float = 12.0):
    """Apparent image-space motion (du, dv) in px/frame at the image center
    for frame `idx`, from the world->cam pose delta to the next frame.

    The center pixel sees a point at depth ``depth_hint``; its flow is the
    difference of its projections under the two poses — captures both the
    translational and rotational components of blur direction.
    """
    if idx + 1 >= len(poses):
        idx = max(len(poses) - 2, 0)
    R0, t0 = poses[idx]
    R1, t1 = poses[idx + 1]
    # center ray point in world coords under pose 0
    Xc = np.array([0.0, 0.0, depth_hint])
    Xw = R0.T @ (Xc - t0)
    X1 = R1 @ Xw + t1
    if X1[2] <= 1e-6:
        return np.zeros(2)
    u1 = X1[0] / X1[2] * cam.fx + cam.cx
    v1 = X1[1] / X1[2] * cam.fy + cam.cy
    return np.array([u1 - cam.cx, v1 - cam.cy])


def motion_blur(img: np.ndarray, direction: np.ndarray, length_px: float,
                n_taps: int = 7) -> np.ndarray:
    """Linear motion blur: average of sub-pixel shifts along `direction`
    spanning ``length_px`` (the exposure-time smear)."""
    if length_px < 0.25:
        return img
    d = np.asarray(direction, np.float64)
    n = np.linalg.norm(d)
    d = d / n if n > 1e-9 else np.array([1.0, 0.0])
    offs = np.linspace(-0.5, 0.5, n_taps) * length_px
    acc = np.zeros_like(img, np.float64)
    for o in offs:
        # ndimage.shift order: (row, col) = (v, u)
        acc += ndimage.shift(img, (o * d[1], o * d[0]), order=1,
                             mode="nearest")
    return (acc / n_taps).astype(img.dtype)


def defocus(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian defocus (thin-lens blur circle approximation)."""
    if sigma < 0.05:
        return img
    return ndimage.gaussian_filter(img, sigma, mode="nearest").astype(
        img.dtype)


def vignette(img: np.ndarray, strength: float = 0.25) -> np.ndarray:
    """Radial lens falloff: 1 - strength * (r / r_max)^2."""
    H, W = img.shape[:2]
    yy, xx = np.mgrid[0:H, 0:W]
    r2 = (((xx - W / 2) / (W / 2)) ** 2 + ((yy - H / 2) / (H / 2)) ** 2) / 2
    fall = 1.0 - strength * r2
    return (img * (fall if img.ndim == 2 else fall[..., None])).astype(
        img.dtype)


def degrade_sequence(
    images: np.ndarray,          # (F, H, W) grayscale float [0, 1]
    poses,                       # list of (R, t) world->cam, len F
    cam,                         # CameraConfig
    rng: np.random.Generator,
    blur_px: float = 3.0,        # mean motion-blur length (scaled by speed)
    defocus_sigma: tuple = (0.2, 1.0),  # per-frame uniform range
    vignette_strength: float = 0.25,
    exposure_gain: float = 0.12,
    exposure_bias: float = 0.03,
    noise_std: float = 0.012,
) -> np.ndarray:
    """Full degradation stack, per frame: motion blur along the true
    apparent motion, random defocus, vignetting, exposure jitter, sensor
    noise. Returns a new (F, H, W) array in [0, 1]."""
    out = np.empty_like(images)
    # normalize blur length by the median apparent speed so blur_px is the
    # typical smear, with fast frames (corner turns) blurring more
    dirs = [motion_direction_px(poses, cam, f) for f in range(len(images))]
    speeds = np.array([np.linalg.norm(d) for d in dirs])
    med = np.median(speeds[speeds > 1e-6]) if (speeds > 1e-6).any() else 1.0
    for f, img in enumerate(images):
        g = motion_blur(img, dirs[f], blur_px * speeds[f] / max(med, 1e-6))
        g = defocus(g, rng.uniform(*defocus_sigma))
        g = vignette(g, vignette_strength)
        gain = 1.0 + exposure_gain * rng.standard_normal()
        bias = exposure_bias * rng.standard_normal()
        g = g * gain + bias + noise_std * rng.standard_normal(g.shape)
        out[f] = np.clip(g, 0.0, 1.0)
    return out
