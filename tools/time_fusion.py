"""What the device fusion of `chip_smoke.py` spends its time on, on one card.

    python3 tools/time_fusion.py [--rounds 5] [--reps 5]

Times, on the 16 frames of 480x640 that `chip_smoke.py` fuses, with CUDA
events and in several interleaved rounds in one process:
  full      chip_smoke.py's device_fusion_ms: depth stack from the host,
            fuse_depth_maps, voxelize and the sort-based dedup
  on_dev    the same with the depth stack already on the card
  h2d       the host->device copy of the depth stack alone
  f32_fma   `full` with the world transform's fused multiply-adds taken
            as float32 a*b + c instead of the float64 route of
            `tpu3drec_torch.core.fp.fma` (which matches the JAX package's
            CPU roundings)
and the largest difference between the float32 and the float64 points.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import CX, CY, FX, FY, H, W, make_scene, time_ms  # noqa: E402
from tpu3drec_torch.core import unproject  # noqa: E402
from tpu3drec_torch.mapping.voxel import unique_voxels, voxelize  # noqa: E402
from tpu3drec_torch.pipelines import rgbd  # noqa: E402
from tpu3drec_torch.utils.config import CameraConfig, MapConfig, RGBDPipelineConfig  # noqa: E402


def _fma_f32(a, b, c):
    return a * b + c


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fusion: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    depths, _, _, q_xyzw, t_w2c = make_scene(np.random.default_rng(args.seed), 16, H, W,
                                             FX, FY, CX, CY)
    q32, t32 = q_xyzw.astype(np.float32), t_w2c.astype(np.float32)
    cfg = RGBDPipelineConfig(camera=CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H),
                             map=MapConfig(voxel_res=0.1))
    depths_dev = torch.as_tensor(depths, device=dev)

    def fusion(d):
        p, valid = rgbd.fuse_arrays(d, q32, t32, cfg, device=dev)
        return unique_voxels(voxelize(p, cfg.map.voxel_res), valid)[2]

    shipped = unproject.fma

    def with_f32_fma():
        unproject.fma = _fma_f32
        try:
            return fusion(depths)
        finally:
            unproject.fma = shipped

    cases = {
        "full": lambda: fusion(depths),
        "on_dev": lambda: fusion(depths_dev),
        "h2d": lambda: torch.as_tensor(depths, device=dev),
        "f32_fma": with_f32_fma,
    }
    times = {k: [] for k in cases}
    for _ in range(args.rounds):
        for name, fn in cases.items():
            times[name].append(time_ms(fn, dev, reps=args.reps))
    for name, ms in times.items():
        print(f"{name:8s} ms per call, {args.rounds} rounds of {args.reps}: "
              + " ".join(f"{t:.3f}" for t in ms)
              + f"  (min {min(ms):.3f}, max {max(ms):.3f})", flush=True)

    p64, _ = rgbd.fuse_arrays(depths, q32, t32, cfg, device=dev)
    unproject.fma = _fma_f32
    try:
        p32, _ = rgbd.fuse_arrays(depths, q32, t32, cfg, device=dev)
    finally:
        unproject.fma = shipped
    diff = (p64 - p32).abs()
    print(f"float32 vs float64 fma: max abs diff {diff.max().item():.3e} m, "
          f"{(diff > 0).float().mean().item():.4f} of coordinates differ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
