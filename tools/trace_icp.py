"""Where the time of one ICP scale correction goes, on one card.

    python3 tools/trace_icp.py [--points 76800] [--iters 50]

Runs `icp_scale_correction` twice on a seeded cloud against a copy under a
known similarity: the first call pays one-time costs (kernel build and
load, cuSOLVER's first use), the second is timed by the host clock and
traced with torch.profiler. Prints both wall times, the device time the
trace attributes to kernels, and the operations that take the most device
and host time. Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu3drec_torch.sfm.icp import icp_scale_correction  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=76_800)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_icp: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    a = rng.uniform([-2, -1.5, 0], [2, 1.5, 50], size=(args.points, 3))
    c, s = np.cos(0.05), np.sin(0.05)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    b = 1.25 * a @ R.T + [0.7, -0.4, 1.1]
    a = torch.as_tensor(a, dtype=torch.float32, device="cuda")
    b = torch.as_tensor(b, dtype=torch.float32, device="cuda")

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T = icp_scale_correction(a, b, iters=args.iters)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"icp {args.points}x{args.points} x {args.iters} iterations: first call "
          f"{walls[0]:.4f} s, second call {walls[1]:.4f} s", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        T = icp_scale_correction(a, b, iters=args.iters)
        torch.cuda.synchronize()
    del T
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events)
    print(f"traced call: device time of all kernels {device_us / 1e3:.3f} ms", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=15), flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=15), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
