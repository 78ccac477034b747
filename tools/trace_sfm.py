"""Where the time of one SfM run goes, on one card.

    python3 tools/trace_sfm.py [--frames 12] [--keypoints 512] [--seed 0]

Renders `chip_smoke.py`'s SfM scene (480x640, reference camera) and runs
`sfm_pipeline.run` three times: the first call pays one-time costs (kernel
build and load, cuSOLVER's first use); the second is timed by the host
clock with its per-stage split; the third is traced with torch.profiler.
Prints the wall times, the device time the trace attributes to kernels and
its share of the traced wall time, the number of kernel launches, and the
operations that take the most device and host time. Prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import FX, FY, H, W, make_sfm_scene  # noqa: E402
from tpu3drec_torch.pipelines import sfm_pipeline  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--keypoints", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_sfm: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    images, _, _ = make_sfm_scene(np.random.default_rng(args.seed), args.frames, H, W, FX)
    K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)
    cfg = sfm_pipeline.SfmPipelineConfig(max_keypoints=args.keypoints, overlap=3)

    for label in ("first", "second"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = sfm_pipeline.run(images, K, cfg)
        torch.cuda.synchronize()
        split = " ".join(f"{k}={v:.3f}" for k, v in rec.seconds.items())
        print(f"{label} call: {time.perf_counter() - t0:.3f} s, "
              f"{len(rec.registered_frames())}/{args.frames} frames; {split}", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rec = sfm_pipeline.run(images, K, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels only: the operator rows above them carry the same time again
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                         "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in events if e.key in ("cudaMemcpyAsync", "cudaStreamSynchronize",
                                                      "cudaDeviceSynchronize"))
    split = " ".join(f"{k}={v:.3f}" for k, v in rec.seconds.items())
    print(f"traced call: {wall:.3f} s wall ({split}); device time of all kernels "
          f"{device_us / 1e3:.1f} ms ({device_us / 1e4 / wall:.1f}% of the wall); "
          f"{launches} kernel launches; {syncs} copies and synchronisations", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=20), flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=15), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
