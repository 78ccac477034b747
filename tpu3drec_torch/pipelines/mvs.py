"""Dense MVS pipeline (port of `tpu3drec/pipelines/mvs.py`): posed images
-> per-view depth -> TSDF -> mesh, the dense half of the reference's MVE
pipeline on poses from SfM or ground truth:

1. per-view plane-sweep ZNCC depth     (dmrecon,   `mvs/plane_sweep.py`)
2. cross-view geometric consistency    (scene2pset's confidence filter)
3. TSDF fusion of the validated depths (scene2pset, `mvs/tsdf.py`)
4. marching-tetrahedra mesh extraction (fssrecon,  `mvs/marching.py`)
5. floater and degenerate cleanup      (meshclean, `mvs/meshclean.py`)

CLI: ``python -m tpu3drec_torch.pipelines.cli mvs --images DIR --poses
poses.txt --fx .. --out mesh.ply``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu3drec_torch.core.unproject import fuse_depth_maps
from tpu3drec_torch.mvs.marching import marching_tetrahedra, weld_mesh
from tpu3drec_torch.mvs.meshclean import clean_mesh
from tpu3drec_torch.mvs.plane_sweep import geometric_consistency, plane_sweep_depth
from tpu3drec_torch.mvs.tsdf import TsdfGrid, integrate_depth_maps
from tpu3drec_torch.utils.device import as_f32, resolve_device


@dataclass
class MvsConfig:
    n_src: int = 4             # source views per reference view
    n_planes: int = 96         # depth hypotheses (inverse-depth spaced)
    window: int = 5            # ZNCC window (see plane_sweep.py on slant)
    d_min: float = 1.0
    d_max: float = 80.0
    min_zncc: float = 0.5      # photo-consistency acceptance
    rel_err: float = 0.02      # cross-view depth agreement (relative)
    min_consistent: int = 2    # views that must agree
    voxel_res: float = 0.0     # 0 = auto: median scene depth / 100
    max_grid_dim: int = 384
    min_component_frac: float = 0.02
    depth_stride: int = 1      # subsample factor for the grid-bounds estimate
    verbose: bool = False


def select_source_views(Rs: np.ndarray, ts: np.ndarray, ref: int, n_src: int,
                        min_baseline: float = 1e-3):
    """The nearest cameras by centre distance, excluding near-zero
    baselines (no parallax, no depth signal). Centres C = -R^T t."""
    C = np.einsum("fij,fi->fj", Rs, -ts)
    d = np.linalg.norm(C - C[ref], axis=1)
    order = np.argsort(d)
    return [int(i) for i in order if i != ref and d[i] > min_baseline][:n_src]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_mvs(images: np.ndarray, K: np.ndarray, Rs: np.ndarray, ts: np.ndarray,
            cfg: MvsConfig = None, device=None):
    """images (F, H, W) grayscale in [0, 1]; Rs / ts world->cam.

    Returns a dict with the per-view depths, masks and ZNCC scores, the
    fused point set, the mesh (verts, faces), the TSDF grid and the
    seconds of each stage (the device's work done within its stage)."""
    cfg = cfg or MvsConfig()
    dev = resolve_device(device)
    F, H, W = images.shape
    n_src = min(cfg.n_src, F - 1)
    t0 = time.time()
    imgs = as_f32(images, dev)
    K_d, Rs_d, ts_d = (as_f32(a, dev) for a in (K, Rs, ts))

    depths = np.zeros((F, H, W), np.float32)
    znccs = np.zeros((F, H, W), np.float32)
    for f in range(F):
        src = select_source_views(Rs, ts, f, n_src)
        if len(src) < 1:
            continue
        d, z, _ = plane_sweep_depth(imgs[f], imgs[src], K_d, Rs_d[f], ts_d[f], Rs_d[src],
                                    ts_d[src], cfg.d_min, cfg.d_max, n_planes=cfg.n_planes,
                                    window=cfg.window, device=dev)
        dn, zn = d.cpu().numpy(), z.cpu().numpy()
        dn[zn < cfg.min_zncc] = 0.0
        depths[f] = dn
        znccs[f] = zn
        if cfg.verbose:
            print(f"[mvs] view {f}: {len(src)} sources, {float((dn > 0).mean()):.0%} confident",
                  flush=True)
    t_sweep = time.time() - t0

    t0 = time.time()
    masks = geometric_consistency(depths, K, Rs, ts, rel_err=cfg.rel_err,
                                  min_consistent=min(cfg.min_consistent, max(F - 1, 1)),
                                  device=dev)
    t_consist = time.time() - t0

    # the fused validated point set (scene2pset's deliverable), also the
    # grid-bounds estimate
    t0 = time.time()
    d_masked = np.where(masks, depths, 0.0).astype(np.float32)
    Rs_c2w = np.transpose(Rs, (0, 2, 1))
    ts_c2w = -np.einsum("fij,fj->fi", Rs_c2w, ts)
    st = cfg.depth_stride
    pts, valid = fuse_depth_maps(
        d_masked[:, ::st, ::st], Rs_c2w.astype(np.float32), ts_c2w.astype(np.float32),
        float(K[0, 0]) / st, float(K[1, 1]) / st, float(K[0, 2]) / st, float(K[1, 2]) / st,
        min_depth=1e-6, device=dev)
    pts = pts[valid].cpu().numpy()
    if pts.shape[0] == 0:
        return {"depths": depths, "masks": masks, "points": pts,
                "verts": np.zeros((0, 3), np.float32), "faces": np.zeros((0, 3), np.int32),
                "timings": {"sweep_s": t_sweep, "consist_s": t_consist}}

    res = cfg.voxel_res
    if res <= 0:
        res = max(float(np.median(depths[depths > 0])) / 100.0, 1e-3)
    grid = TsdfGrid.around_points(pts, res, pad=4 * res, max_dim=cfg.max_grid_dim, device=dev)
    grid = integrate_depth_maps(grid, d_masked, K, Rs, ts)
    _sync(dev)
    t_fuse = time.time() - t0

    t0 = time.time()
    soup = marching_tetrahedra(grid.tsdf, grid.weight, grid.origin, grid.res)
    verts, faces = weld_mesh(soup, tol=grid.res * 1e-3)
    verts, faces = clean_mesh(verts, faces, min_component_frac=cfg.min_component_frac)
    t_mesh = time.time() - t0
    if cfg.verbose:
        print(f"[mvs] grid {tuple(grid.tsdf.shape)} res {res:.3f}: {verts.shape[0]} verts, "
              f"{faces.shape[0]} faces (sweep {t_sweep:.1f}s, consist {t_consist:.1f}s, "
              f"fuse {t_fuse:.1f}s, mesh {t_mesh:.1f}s)", flush=True)
    return {"depths": depths, "masks": masks, "zncc": znccs, "points": pts, "verts": verts,
            "faces": faces, "grid": grid,
            "timings": {"sweep_s": t_sweep, "consist_s": t_consist, "fuse_s": t_fuse,
                        "mesh_s": t_mesh}}
