"""Simulated-sensor capture (port of `tpu3drec/data/capture_sim.py`).

Synthesises RGB + depth frame streams from a random 3D scene and a flyable
camera path, in the capture layout the pipelines read (`front/`, `depth/`
and the pose txt): the blob-splat `SimScene`, the ray-cast `PlanarScene`
of textured quads, orbit and survey trajectories, and `CaptureSim`, which
writes a dataset. The arithmetic is the reference's numpy, copied, so the
frames equal the reference's bit for bit. PIL is imported only inside
`CaptureSim.capture`, which writes image files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu3drec_torch.core.quaternion import matrix_to_quat_wxyz, quat_xyzw_from_wxyz
from tpu3drec_torch.utils.config import CameraConfig
from tpu3drec_torch.utils.poseio import PoseRecord, write_pose_txt


@dataclass
class SimScene:
    """Random blob world: positions (N,3), per-blob radius + albedo, plus a
    per-blob procedural texture (random 2D sinusoid) so every splat has
    distinctive local gradient structure — flat discs are feature-detectable
    but descriptor-ambiguous."""

    points: np.ndarray
    radii: np.ndarray
    albedo: np.ndarray
    tex_freq: np.ndarray   # (N, 2) sinusoid frequency (cycles/px-at-1m)
    tex_phase: np.ndarray  # (N,)

    @staticmethod
    def random(rng, n: int = 300, extent=((-20, -5, 5), (20, 5, 45))) -> "SimScene":
        lo, hi = np.asarray(extent[0]), np.asarray(extent[1])
        return SimScene(
            points=rng.uniform(lo, hi, size=(n, 3)).astype(np.float32),
            radii=rng.uniform(0.3, 1.2, size=n).astype(np.float32),
            albedo=rng.uniform(0.3, 1.0, size=(n, 3)).astype(np.float32),
            tex_freq=rng.uniform(0.5, 2.5, size=(n, 2)).astype(np.float32)
            * rng.choice([-1, 1], size=(n, 2)),
            tex_phase=rng.uniform(0, 2 * np.pi, size=n).astype(np.float32),
        )

    @staticmethod
    def clustered(rng, n_landmarks: int = 150, sats: int = 4,
                  extent=((-20, -5, 8), (20, 5, 45)),
                  sat_spread: float = 0.6) -> "SimScene":
        """SfM-friendly scene: each landmark is an anchor blob plus a unique
        constellation of satellite blobs at fixed 3D offsets — local
        appearance is distinctive AND rigidly view-consistent (screen-space
        texture is not; see git history)."""
        lo, hi = np.asarray(extent[0]), np.asarray(extent[1])
        anchors = rng.uniform(lo, hi, size=(n_landmarks, 3))
        offs = rng.uniform(-sat_spread, sat_spread, size=(n_landmarks, sats, 3))
        pts = np.concatenate(
            [anchors[:, None, :], anchors[:, None, :] + offs], axis=1
        ).reshape(-1, 3)
        n = pts.shape[0]
        radii = np.concatenate(
            [np.full((n_landmarks, 1), 0.35),
             rng.uniform(0.12, 0.3, size=(n_landmarks, sats))], axis=1
        ).reshape(-1)
        albedo = rng.uniform(0.25, 1.0, size=(n, 3))
        return SimScene(
            points=pts.astype(np.float32),
            radii=radii.astype(np.float32),
            albedo=albedo.astype(np.float32),
            tex_freq=np.zeros((n, 2), np.float32),
            tex_phase=np.full(n, np.pi / 2, np.float32),  # sin -> 1: flat shading
        )


def render_frame(scene, R: np.ndarray, t: np.ndarray,
                 cam: CameraConfig, max_depth: float = 60.0):
    """Render RGB (H,W,3 uint8) + depth (H,W float32 metres) for a
    world->camera pose. Dispatches to the scene's own renderer when it has
    one (PlanarScene ray caster); the fallback is the splat renderer
    (nearest-splat-wins z-buffer) for SimScene blob worlds."""
    if hasattr(scene, "render"):
        return scene.render(R, t, cam, max_depth)
    H, W = cam.height, cam.width
    Xc = scene.points @ R.T + t
    vis = Xc[:, 2] > 0.5
    rgb = np.zeros((H, W, 3), np.float32)
    depth = np.full((H, W), max_depth, np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    order = np.argsort(-Xc[:, 2])  # far-to-near so near splats overwrite
    for m in order:
        if not vis[m]:
            continue
        z = Xc[m, 2]
        u = Xc[m, 0] / z * cam.fx + cam.cx
        v = Xc[m, 1] / z * cam.fy + cam.cy
        r_px = scene.radii[m] / z * cam.fx
        if u < -r_px or u > W + r_px or v < -r_px or v > H + r_px or r_px < 0.3:
            continue
        u0, u1 = max(int(u - 3 * r_px), 0), min(int(u + 3 * r_px) + 1, W)
        v0, v1 = max(int(v - 3 * r_px), 0), min(int(v + 3 * r_px) + 1, H)
        if u0 >= u1 or v0 >= v1:
            continue
        du = xx[v0:v1, u0:u1] - u
        dv = yy[v0:v1, u0:u1] - v
        hit = du * du + dv * dv < r_px * r_px
        closer = hit & (z < depth[v0:v1, u0:u1])
        depth[v0:v1, u0:u1][closer] = z
        # per-blob texture in splat-local metric coords (approximately
        # view-stable for modest viewpoint changes)
        fu, fv = scene.tex_freq[m]
        # normalize offsets by the projected radius: the pattern scales with
        # the splat across views instead of swimming with depth
        tex = 0.65 + 0.35 * np.sin(
            (du * fu + dv * fv) * (2.0 * np.pi / r_px) + scene.tex_phase[m]
        )
        rgb[v0:v1, u0:u1][closer] = (
            scene.albedo[m][None, :] * tex[closer][:, None]
        )
    rgb_u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    # no-return pixels carry 0 (sensor convention; downstream min_depth
    # masks them) — a fake far plane would poison ICP/fusion statistics
    depth = np.where(depth >= max_depth, 0.0, depth).astype(np.float32)
    return rgb_u8, depth


@dataclass
class Quad:
    """Textured planar patch: origin + two edge vectors spanning the
    surface, with a broadband procedural texture anchored in *surface*
    coordinates (view-consistent, unlike screen-space patterns)."""

    origin: np.ndarray   # (3,)
    e1: np.ndarray       # (3,) first edge (full extent)
    e2: np.ndarray       # (3,) second edge
    albedo: np.ndarray   # (3,)
    tex_seed: float        # per-quad hash seed
    tex_freq: np.ndarray   # (T,) lattice frequency per noise octave (1/m)
    tex_amp: np.ndarray    # (T,)


def _hash01(i: np.ndarray, j: np.ndarray, seed: float) -> np.ndarray:
    """Deterministic lattice hash -> [0,1): the classic fract(sin(.)*big)
    trick. Non-periodic in practice — unlike sinusoids, whose self-similar
    ridges produce near-duplicate descriptors that die in the ratio test."""
    v = np.sin(i * 12.9898 + j * 78.233 + seed) * 43758.5453
    return v - np.floor(v)


def _value_noise(a: np.ndarray, b: np.ndarray, freqs, amps, seed: float):
    """Multi-octave value noise at surface coords (a, b) metres: bilinear
    interpolation of hashed lattice values, summed over octaves."""
    out = np.zeros_like(a)
    for k, (f, amp) in enumerate(zip(freqs, amps)):
        x = a * f
        y = b * f
        x0 = np.floor(x)
        y0 = np.floor(y)
        fx = x - x0
        fy = y - y0
        # smoothstep the interpolant: kills lattice-aligned gradient creases
        fx = fx * fx * (3 - 2 * fx)
        fy = fy * fy * (3 - 2 * fy)
        s = seed + 131.7 * k
        v00 = _hash01(x0, y0, s)
        v10 = _hash01(x0 + 1, y0, s)
        v01 = _hash01(x0, y0 + 1, s)
        v11 = _hash01(x0 + 1, y0 + 1, s)
        out += amp * ((v00 * (1 - fx) + v10 * fx) * (1 - fy)
                      + (v01 * (1 - fx) + v11 * fx) * fy)
    return out


@dataclass
class PlanarScene:
    """Occlusion-heavy world of textured quads (ground, walls, boxes,
    clutter) rendered by ray casting with a z-buffer — the realistic
    upgrade over isolated splats: surfaces occlude each other, texture is
    broadband (features at every scale), and shading is view-dependent
    (Lambert + specular), so e2e results stop over-predicting real-world
    performance (VERDICT r1 item 2)."""

    quads: list
    light_dir: np.ndarray = field(
        default_factory=lambda: np.array([0.4, -0.8, 0.45]) / np.linalg.norm([0.4, -0.8, 0.45]))
    ambient: float = 0.35
    specular: float = 0.25
    shininess: float = 12.0

    @staticmethod
    def _make_quad(rng, origin, e1, e2, n_tex: int = 6,
                   freq_lo: float = 0.3, freq_hi: float = 8.0) -> Quad:
        """Broadband value-noise texture: lattice frequencies log-spaced
        over ~4 octaves with 1/f amplitude falloff — every DoG octave sees
        structure, and the noise is non-repeating (distinctive descriptors,
        unlike periodic patterns that alias in the ratio test)."""
        f = np.exp(np.linspace(np.log(freq_lo), np.log(freq_hi), n_tex))
        f = f * rng.uniform(0.8, 1.25, size=n_tex)
        # near-flat spectrum: fine octaves keep real contrast (a 1/f rolloff
        # leaves box-scale surfaces featureless at typical viewing distances)
        amps = (freq_lo / f) ** 0.2
        amps = amps / np.sum(amps)
        return Quad(
            origin=np.asarray(origin, np.float32),
            e1=np.asarray(e1, np.float32),
            e2=np.asarray(e2, np.float32),
            albedo=rng.uniform(0.35, 0.95, size=3).astype(np.float32),
            tex_seed=float(rng.uniform(0, 1000.0)),
            tex_freq=f.astype(np.float32),
            tex_amp=amps.astype(np.float32),
        )

    @staticmethod
    def urban(rng, n_boxes: int = 8, extent: float = 30.0,
              ground_y: float = 3.0) -> "PlanarScene":
        """Ground plane + scattered boxes (4 walls + roof each): a
        street-canyon-like layout with heavy inter-object occlusion.
        Coordinates follow the camera convention used across the repo:
        x right, y down (ground at +y), z forward."""
        mk = PlanarScene._make_quad
        quads = [mk(rng, [-extent, ground_y, -5.0], [2 * extent, 0, 0],
                    [0, 0, extent * 2.5], n_tex=10)]
        for _ in range(n_boxes):
            w = rng.uniform(1.5, 5.0)       # width (x)
            h = rng.uniform(2.0, 8.0)       # height (y, up = -y)
            d = rng.uniform(1.5, 5.0)       # depth (z)
            cx = rng.uniform(-extent * 0.7, extent * 0.7)
            cz = rng.uniform(4.0, extent * 2.0)
            x0, x1 = cx - w / 2, cx + w / 2
            y0, y1 = ground_y - h, ground_y
            z0, z1 = cz - d / 2, cz + d / 2
            quads += [
                mk(rng, [x0, y1, z0], [x1 - x0, 0, 0], [0, y0 - y1, 0]),  # front
                mk(rng, [x0, y1, z1], [x1 - x0, 0, 0], [0, y0 - y1, 0]),  # back
                mk(rng, [x0, y1, z0], [0, 0, z1 - z0], [0, y0 - y1, 0]),  # left
                mk(rng, [x1, y1, z0], [0, 0, z1 - z0], [0, y0 - y1, 0]),  # right
                mk(rng, [x0, y0, z0], [x1 - x0, 0, 0], [0, 0, z1 - z0]),  # roof
            ]
        return PlanarScene(quads=quads)

    @staticmethod
    def arena(rng, n_boxes: int = 8, center=(0.0, 0.0, 20.0),
              spread: float = 7.0, ground_y: float = 3.0) -> "PlanarScene":
        """Boxes clustered around ``center`` on a textured ground, leaving
        the annulus beyond ``spread`` clear — built for inward-looking orbit
        trajectories (cameras never intersect geometry)."""
        cx0, _, cz0 = center
        mk = PlanarScene._make_quad
        ext = spread + 30.0
        quads = [mk(rng, [cx0 - ext, ground_y, cz0 - ext], [2 * ext, 0, 0],
                    [0, 0, 2 * ext], n_tex=10)]
        for _ in range(n_boxes):
            w = rng.uniform(1.0, 3.0)
            h = rng.uniform(1.5, 6.0)
            d = rng.uniform(1.0, 3.0)
            r = rng.uniform(0, spread - max(w, d))
            th = rng.uniform(0, 2 * np.pi)
            cx = cx0 + r * np.cos(th)
            cz = cz0 + r * np.sin(th)
            x0, x1 = cx - w / 2, cx + w / 2
            y0, y1 = ground_y - h, ground_y
            z0, z1 = cz - d / 2, cz + d / 2
            quads += [
                mk(rng, [x0, y1, z0], [x1 - x0, 0, 0], [0, y0 - y1, 0]),
                mk(rng, [x0, y1, z1], [x1 - x0, 0, 0], [0, y0 - y1, 0]),
                mk(rng, [x0, y1, z0], [0, 0, z1 - z0], [0, y0 - y1, 0]),
                mk(rng, [x1, y1, z0], [0, 0, z1 - z0], [0, y0 - y1, 0]),
                mk(rng, [x0, y0, z0], [x1 - x0, 0, 0], [0, 0, z1 - z0]),
            ]
        return PlanarScene(quads=quads)

    @staticmethod
    def room(rng, size=(12.0, 3.5, 16.0), n_clutter: int = 6) -> "PlanarScene":
        """Closed textured room (floor/ceiling/4 walls) + clutter boxes —
        an InteriorNet-like indoor world for inward-looking trajectories."""
        sx, sy, sz = size
        mk = PlanarScene._make_quad
        quads = [
            mk(rng, [-sx / 2, sy / 2, -sz / 2], [sx, 0, 0], [0, 0, sz]),   # floor
            mk(rng, [-sx / 2, -sy / 2, -sz / 2], [sx, 0, 0], [0, 0, sz]),  # ceiling
            mk(rng, [-sx / 2, sy / 2, -sz / 2], [sx, 0, 0], [0, -sy, 0]),  # near wall
            mk(rng, [-sx / 2, sy / 2, sz / 2], [sx, 0, 0], [0, -sy, 0]),   # far wall
            mk(rng, [-sx / 2, sy / 2, -sz / 2], [0, 0, sz], [0, -sy, 0]),  # left
            mk(rng, [sx / 2, sy / 2, -sz / 2], [0, 0, sz], [0, -sy, 0]),   # right
        ]
        for _ in range(n_clutter):
            w, h, d = rng.uniform(0.5, 2.0, size=3)
            cx = rng.uniform(-sx / 2 + 1.5, sx / 2 - 1.5)
            cz = rng.uniform(-sz / 2 + 1.5, sz / 2 - 1.5)
            y1 = sy / 2
            x0, z0 = cx - w / 2, cz - d / 2
            quads += [
                mk(rng, [x0, y1, z0], [w, 0, 0], [0, -h, 0]),
                mk(rng, [x0, y1, z0 + d], [w, 0, 0], [0, -h, 0]),
                mk(rng, [x0, y1, z0], [0, 0, d], [0, -h, 0]),
                mk(rng, [x0 + w, y1, z0], [0, 0, d], [0, -h, 0]),
                mk(rng, [x0, y1 - h, z0], [w, 0, 0], [0, 0, d]),
            ]
        return PlanarScene(quads=quads)

    def render(self, R: np.ndarray, t: np.ndarray, cam: CameraConfig,
               max_depth: float = 60.0):
        """Ray-cast RGB (H,W,3 uint8) + metric depth (H,W float32) for a
        world->cam pose (vectorized over pixels, loop over quads)."""
        H, W = cam.height, cam.width
        C = (-R.T @ t).astype(np.float64)          # camera centre, world
        yy, xx = np.mgrid[0:H, 0:W]
        d_cam = np.stack([(xx - cam.cx) / cam.fx, (yy - cam.cy) / cam.fy,
                          np.ones_like(xx, np.float64)], -1)
        d_w = d_cam @ R  # R^T rows: world-frame ray dirs (unnormalized, z_cam=1)
        zbuf = np.full((H, W), np.inf)
        rgb = np.zeros((H, W, 3), np.float32)
        view = -d_w / np.linalg.norm(d_w, axis=-1, keepdims=True)
        for q in self.quads:
            n = np.cross(q.e1, q.e2)
            area2 = np.dot(n, n)
            denom = d_w @ n
            tt = -((C - q.origin) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            hitp = C + tt[..., None] * d_w
            rel = hitp - q.origin
            a = (rel @ q.e1) / np.dot(q.e1, q.e1)
            b = (rel @ q.e2) / np.dot(q.e2, q.e2)
            # tt is the camera-frame depth (d_w has z_cam = 1)
            hit = ((tt > 0.5) & (tt < zbuf) & (a >= 0) & (a <= 1)
                   & (b >= 0) & (b <= 1))
            if not hit.any():
                continue
            am = a[hit] * np.linalg.norm(q.e1)
            bm = b[hit] * np.linalg.norm(q.e2)
            nz = _value_noise(am, bm, q.tex_freq, q.tex_amp, q.tex_seed)
            tex = 0.1 + 1.8 * nz  # noise mean ~0.5 -> tex mean ~1.0, high contrast
            nn = n / np.sqrt(area2)
            lam = abs(float(np.dot(nn, self.light_dir)))
            hv = self.light_dir[None, :] + view[hit]
            hv = hv / np.maximum(np.linalg.norm(hv, axis=-1, keepdims=True), 1e-9)
            spec = self.specular * np.abs(hv @ nn) ** self.shininess
            shade = self.ambient + (1 - self.ambient) * lam + spec
            rgb[hit] = q.albedo[None, :] * (np.clip(tex, 0.1, 1.2) * shade)[:, None]
            zbuf[hit] = tt[hit]
        depth = np.where(np.isfinite(zbuf) & (zbuf < max_depth), zbuf, 0.0)
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8), depth.astype(np.float32)


def render_stereo_pairs(scene: "PlanarScene", poses, cam: "CameraConfig",
                        baseline: float = 0.1, max_depth: float = 60.0):
    """Rectified stereo pairs with GT disparity from the ray-cast depth.

    The right camera shares R and sits ``baseline`` metres along the
    camera +x axis (the reference's stereo T convention,
    `ref/monodepth2/mono_dataset.py:203-209`: side frame at +-0.1 m).
    GT disparity d = fx * B / Z from the left depth map; pixels whose
    right-view correspondence falls off-frame or whose depth is invalid
    are masked out. Returns (lefts, rights, disps, masks) float32 stacks,
    images in [0, 1].
    """
    lefts, rights, disps, masks = [], [], [], []
    for R, t in poses:
        # C' = C + B * (cam x-axis in world) => t' = -R C' = t - [B,0,0]
        t_r = (np.asarray(t, np.float32)
               - np.array([baseline, 0.0, 0.0], np.float32))
        rgb_l, depth_l = scene.render(R, t, cam, max_depth=max_depth)
        rgb_r, _ = scene.render(R, t_r, cam, max_depth=max_depth)
        valid = depth_l > 0
        disp = np.where(valid, cam.fx * baseline / np.maximum(depth_l, 1e-6),
                        0.0).astype(np.float32)
        xx = np.arange(cam.width, dtype=np.float32)[None, :]
        mask = (valid & (xx - disp >= 0)).astype(np.float32)
        lefts.append(rgb_l.astype(np.float32) / 255.0)
        rights.append(rgb_r.astype(np.float32) / 255.0)
        disps.append(disp)
        masks.append(mask)
    return (np.stack(lefts), np.stack(rights), np.stack(disps),
            np.stack(masks))


def orbit_poses(n_frames: int, center, radius: float, y: float = 0.0,
                span_deg: float = 360.0, start_deg: float = 0.0):
    """Inward-looking circle: cameras on a horizontal ring about ``center``,
    optical axis through it — the round-1 wide-baseline failing
    case, now a first-class trajectory. Returns [(R, t) world->cam]."""
    center = np.asarray(center, np.float64)
    poses = []
    for i in range(n_frames):
        th = np.deg2rad(start_deg + span_deg * i / max(n_frames, 1))
        C = center + np.array([radius * np.sin(th), y, -radius * np.cos(th)])
        fwd = center - C
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right = right / np.linalg.norm(right)
        upn = np.cross(fwd, right)
        R = np.stack([right, upn, fwd]).astype(np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    return poses


@dataclass
class CaptureSim:
    """Generates capture-layout datasets from a camera trajectory."""

    scene: SimScene
    cam: CameraConfig = field(default_factory=lambda: CameraConfig(
        fx=269.5, fy=269.5, cx=319.5, cy=239.5, width=640, height=480,
    ))  # the AirSim client's intrinsics (`main.cpp:40-43`)

    def fly(self, n_frames: int, step=np.array([0.6, 0.0, 0.4]),
            yaw_rate: float = 0.01):
        """Straight-ish survey path; returns [(R, t) world->cam]."""
        from scipy.spatial.transform import Rotation as ScipyR

        poses = []
        for f in range(n_frames):
            R = ScipyR.from_rotvec([0, yaw_rate * f, 0]).as_matrix().astype(np.float32)
            C = (step * f).astype(np.float32)
            poses.append((R, (-R @ C).astype(np.float32)))
        return poses

    def capture(self, out_dir: str, poses, depth_scale: float = 1.0,
                write_pose_file: bool = True):
        """Write the reference capture layout: `front/N.jpg`, `depth/N.png`
        (16-bit mm; the reference's lossy depth-as-jpg is reproducible with
        depth_jpg=True at accuracy cost) and the pose txt contract."""
        from PIL import Image

        os.makedirs(os.path.join(out_dir, "front"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
        records = []
        for f, (R, t) in enumerate(poses):
            rgb, depth = render_frame(self.scene, R, t, self.cam)
            Image.fromarray(rgb).save(os.path.join(out_dir, "front", f"{f}.jpg"))
            d16 = np.clip(depth * 1000.0 * depth_scale, 0, 65535).astype(np.uint16)
            Image.fromarray(d16.astype(np.int32), mode="I").save(
                os.path.join(out_dir, "depth", f"{f}.png")
            )
            q_xyzw = quat_xyzw_from_wxyz(matrix_to_quat_wxyz(torch.as_tensor(R))).numpy()
            records.append(PoseRecord(f, t.astype(np.float64), q_xyzw, f"{f}.png"))
        if write_pose_file:
            write_pose_txt(os.path.join(out_dir, "poses.txt"), records)
        return records
