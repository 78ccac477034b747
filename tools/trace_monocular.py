"""Where the time of the monocular path goes, on one card.

    python3 tools/trace_monocular.py

Builds the full MonodepthModel from seed 0 (ResNet18 depth + ResNet18
pose) and, on random frames of 480x640, times and traces with
torch.profiler: a GT-pose train step at batch 1 in float32 (IEEE, no
TF32) and in bfloat16, a pose-net train step in float32, and depth
inference of a batch of 8 frames. For each: the wall time per call (CUDA
events over warm calls), the device time the trace attributes to kernels
and its share of the wall (the rest is the device idle, waiting on the
host), the kernel launches per call, the share of device time in
convolution kernels, and the operations that take the most device time.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu3drec_torch.models.training import (  # noqa: E402
    TrainConfig, init_state, make_eval_depth, make_train_step)

HEIGHT, WIDTH, SEED = 480, 640, 0
# kernel-name fragments of cuDNN / CUTLASS convolution and GEMM kernels
CONV_KERNELS = ("conv", "gemm", "sm90_xmma", "implicit", "wgrad", "dgrad", "cutlass", "nchw",
                "nhwc")


def trace(label: str, fn, reps: int = 5, warm: int = 3) -> dict:
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
        print("trace_monocular: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    h, w = HEIGHT, WIDTH
    rng = np.random.default_rng(SEED)
    batch = {k: rng.uniform(size=(1, h, w, 3)).astype(np.float32)
             for k in ("target", "prev", "next")}
    batch["gt_axisangle"] = (rng.normal(size=(1, 2, 3)) * 0.01).astype(np.float32)
    batch["gt_translation"] = (rng.normal(size=(1, 2, 3)) * 0.3).astype(np.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for label, kw in (("train_gt_f32", dict(use_gt_pose=True)),
                      ("train_gt_bf16", dict(use_gt_pose=True, compute_dtype="bfloat16")),
                      ("train_posenet_f32", dict())):
        cfg = TrainConfig(height=h, width=w, **kw)
        _, state = init_state(SEED, cfg, 1000)
        step = make_train_step(cfg)
        results.append(trace(label, lambda: step(state, batch, gen)))
        del state
        torch.cuda.empty_cache()
    cfg = TrainConfig(height=h, width=w)
    model, _ = init_state(SEED, cfg, 1000)
    eval_fn = make_eval_depth(model, cfg)
    frames = torch.as_tensor(rng.uniform(size=(8, h, w, 3)).astype(np.float32), device="cuda")
    results.append(trace("infer_b8_f32", lambda: eval_fn(frames)))
    print({"trace_monocular": results}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
