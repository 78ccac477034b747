"""Where the time of the stereo and MVS paths goes, on one card.

    python3 tools/trace_stereo_mvs.py

On random inputs from seed 0, times and traces with torch.profiler: a
PSMNet train step at StereoTrainConfig's published size (256x512, batch 4,
max_disp 64, feat_ch 32) in float32 (IEEE, no TF32) and in bfloat16, eval-mode
disparity of a batch of 4 pairs at 480x640, and one view's plane sweep at
480x640 (96 planes, 4 sources, window 5). For each: the wall time per
call, the device time of its kernels and their share of the wall, the
kernel launches per call, the convolutions' share, and the operations that
take the most device time. Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu3drec_torch.models.psmnet import stereo_infer  # noqa: E402
from tpu3drec_torch.models.psmnet_training import (  # noqa: E402
    StereoTrainConfig, init_stereo_state, make_stereo_train_step, to_model)
from tpu3drec_torch.mvs.plane_sweep import plane_sweep_depth  # noqa: E402

SEED = 0
# kernel-name fragments of cuDNN / CUTLASS convolution and GEMM kernels
CONV_KERNELS = ("conv", "gemm", "sm90_xmma", "implicit", "wgrad", "dgrad", "cutlass", "nchw",
                "nhwc")


def trace(label: str, fn, reps: int = 5, warm: int = 3) -> dict:
    """Wall ms a call (CUDA events over ``reps`` warm calls), then a
    profiled run of ``reps`` calls: device ms, busy share, launches and the
    convolutions' share a call; prints them and the top device ops."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / reps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    conv_ms = sum(e.time_range.elapsed_us() for e in kernels
                  if any(k in e.name.lower() for k in CONV_KERNELS)) / 1e3 / reps
    out = {"label": label, "wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy": device_ms / wall_ms, "launches": len(kernels) / reps,
           "conv_ms": conv_ms, "conv_share": conv_ms / max(device_ms, 1e-9)}
    print(out, flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_stereo_mvs: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    rng = np.random.default_rng(SEED)
    h, w = 256, 512
    batch = {"left": rng.uniform(size=(4, h, w, 3)), "right": rng.uniform(size=(4, h, w, 3)),
             "disp": rng.uniform(0, 60, size=(4, h, w)), "mask": np.ones((4, h, w))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    results = []
    for dtype in ("float32", "bfloat16"):
        cfg = StereoTrainConfig(compute_dtype=dtype)
        _, state = init_stereo_state(SEED, cfg)
        step = make_stereo_train_step(cfg)
        results.append(trace(f"stereo_train_{dtype}", lambda: step(state, batch)))
        del state
        torch.cuda.empty_cache()
    model, _ = init_stereo_state(SEED, StereoTrainConfig())
    pairs = [to_model(model, rng.uniform(size=(4, 480, 640, 3)).astype(np.float32), image=True)
             for _ in range(2)]
    results.append(trace("stereo_infer_b4_480x640", lambda: stereo_infer(model, *pairs)))
    del model
    torch.cuda.empty_cache()
    # a textured wall seen by five cameras on a line, the middle one the reference
    f, hh, ww = 600.391, 480, 640
    K = np.array([[f, 0, 320.0], [0, 600.079, 240.0], [0, 0, 1]], np.float32)
    imgs = rng.uniform(size=(5, hh, ww)).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    ts = np.array([[-0.3 * i, 0, 0] for i in range(5)], np.float32)
    src = [0, 1, 3, 4]
    args = tuple(torch.as_tensor(a, device="cuda") for a in
                 (imgs[2], imgs[src], K, Rs[2], ts[2], Rs[src], ts[src]))
    results.append(trace("plane_sweep_480x640_96p",
                         lambda: plane_sweep_depth(*args, 4.0, 60.0, n_planes=96, window=5)))
    print({"trace_stereo_mvs": results}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
