"""Seeded scenes, and the trajectory error.

Frozen copies of `chip_smoke.py`'s generators (``make_scene``,
``make_sfm_scene``, ``_rot``, ``_quat_xyzw``) and of its ``_ate``, with
two changes: ``make_scene`` casts its rays with PyTorch on the device (the
same float64 arithmetic, the nearest sphere hit taken over all spheres at
once, the dropouts drawn up front), and ``make_sfm_scene`` takes the blob
width's focal length (``FX_REF``, the reference camera's fx) as an
argument default instead of a module constant.
"""

from __future__ import annotations

import numpy as np

FX_REF = 600.391  # the AirSim reference camera's fx (ref/transfer/pixel_to_camera.py)


def rot(yaw, pitch, roll):
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz


def quat_xyzw(R):
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    return np.array([(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w), w])


def make_scene(rng, frames: int, h: int, w: int, fx, fy, cx, cy, device="cpu"):
    """Depth (F, H, W) float32 of a 4 m x 3 m corridor ending 50 m ahead,
    with seeded spheres in it, from a camera walking down it (y down).
    Returns depths, camera->world (R (F,3,3), centre (F,3)) in float64,
    and the COLMAP world->camera rows (q_xyzw (F,4), t (F,3)). The rays are
    cast in float64 with PyTorch on ``device``; the spheres and dropouts
    are drawn from ``rng``."""
    import torch

    spheres = np.stack([rng.uniform(-1.6, 1.6, 24), rng.uniform(-1.2, 1.2, 24),
                        rng.uniform(3.0, 46.0, 24)], -1)
    radii = rng.uniform(0.2, 0.7, 24)
    drop = rng.random((frames, h, w)) < 0.02

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    dc = T(np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1).reshape(-1, 3))
    S, rad = T(spheres), T(radii)
    depths = np.zeros((frames, h, w), np.float32)
    Rs, cs, qs, ts = [], [], [], []
    for f in range(frames):
        R = rot(0.05 * np.sin(0.7 * f), 0.03 * np.cos(0.5 * f), 0.02 * np.sin(f))
        c = np.array([0.4 * np.sin(0.3 * f), 0.2 * np.cos(0.4 * f), 0.3 * f])
        d = dc @ T(R).T  # world ray per pixel; its parameter t is the camera depth
        t = torch.full((d.shape[0],), float("inf"), dtype=torch.float64, device=device)
        for axis, lo, hi in ((0, -2.0, 2.0), (1, -1.5, 1.5), (2, -10.0, 50.0)):
            da = d[:, axis]
            ta = torch.where(da > 0, (hi - c[axis]) / da,
                             torch.where(da < 0, (lo - c[axis]) / da, float("inf")))
            t = torch.minimum(t, ta)
        oc = T(c)[None] - S                                       # (24, 3)
        a = (d * d).sum(-1)[:, None]
        b = 2 * d @ oc.T                                          # (N, 24)
        disc = b * b - 4 * a * ((oc * oc).sum(-1) - rad * rad)[None]
        ts_ = (-b - torch.sqrt(disc)) / (2 * a)
        hit = (disc > 0) & (ts_ > 0)
        t = torch.minimum(t, torch.where(hit, ts_, float("inf")).min(1).values)
        z = t.reshape(h, w).cpu().numpy()
        z[(z < 0.5) | (z > 50.0)] = 0.0  # no return
        z[drop[f]] = 0.0  # dropouts
        depths[f] = z
        Rs.append(R)
        cs.append(c)
        # COLMAP world->camera: R_w2c = R^T, t_w2c = -R^T c
        qs.append(quat_xyzw(R.T))
        ts.append(-R.T @ c)
    return depths, np.stack(Rs), np.stack(cs), np.stack(qs), np.stack(ts)


def make_sfm_scene(rng, frames: int, h: int, w: int, f: float, fx_ref: float = FX_REF):
    """Images (F, H, W) in [0, 1] of textured blob constellations (a centre
    dot and three satellites at fixed 3D offsets, amplitudes of their own)
    seen by a camera moving sideways and forward with a slow yaw, and the
    ground-truth world->camera poses. Each dot is splatted only inside its
    own 4-sigma patch."""
    gx, gy = np.meshgrid(np.linspace(-7.0, 9.5, 22), np.linspace(-3.6, 3.6, 20))
    n = gx.size
    X = np.stack([gx.ravel(), gy.ravel(), rng.uniform(9.0, 17.0, n)], -1)
    X[:, :2] += rng.uniform(-0.25, 0.25, (n, 2))
    sats = rng.uniform(-0.14, 0.14, (n, 3, 3))
    amps = rng.uniform(0.4, 1.0, (n, 4))
    P = np.concatenate([X] + [X + sats[:, s] for s in range(3)])
    A = np.concatenate([amps[:, s] for s in range(4)])
    sigma = 2.2 * f / fx_ref
    rad = int(np.ceil(4 * sigma))
    offs = np.arange(-rad, rad + 1)
    poses, images = [], np.zeros((frames, h, w), np.float32)
    for k in range(frames):
        yaw = 0.02 * k
        c, s_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
        C = np.array([0.4 * k, 0.03 * k, 0.25 * k], np.float32)
        t = (-R @ C).astype(np.float32)
        poses.append((R, t))
        Xc = P @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * f + [w / 2, h / 2]
        for (u, v), a, z in zip(uv, A, Xc[:, 2]):
            if z < 0.5 or not (-rad < u < w + rad and -rad < v < h + rad):
                continue
            xs = np.round(u).astype(int) + offs
            ys = np.round(v).astype(int) + offs
            xs, ys = xs[(xs >= 0) & (xs < w)], ys[(ys >= 0) & (ys < h)]
            if xs.size == 0 or ys.size == 0:
                continue
            g = a * np.exp(-((xs[None] - u) ** 2 + (ys[:, None] - v) ** 2) / (2 * sigma ** 2))
            images[k, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] += g
    return np.clip(images, 0, 1), poses, n


def ate(est, gt):
    """RMS error of camera centres after a similarity (Umeyama) alignment."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, S, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e) / len(est))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    s = np.trace(np.diag(S) @ D) / ((est - mu_e) ** 2).sum(1).mean()
    aligned = s * (est - mu_e) @ (U @ D @ Vt).T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))
