"""Two runs of the port's monodepth trainer from one state, side by side:
how far apart they drift, and what sets them apart.

    python tools/twin_runs_torch.py                 # on the card
    python tools/twin_runs_torch.py --device cpu

`tools/train_convergence_torch.py`'s configuration (its 96 frames of
96x320, batch 4, lr 3e-4, the ground-truth-pose path, seed 0): two models
from the seed take the same 30 steps, on the same batches with the same
automask noise, one step of each in turn; first as the trainer runs, then
again under `torch.use_deterministic_algorithms(True, warn_only=True)`.
For each, prints after steps 1, 2, 3, 5, 10, 20 and 30 the losses'
relative difference, the largest weight difference as a share of lr and
the share of weights more than 1% of lr apart; then the first step whose
losses differ at all, the wall ms per step, and the operations PyTorch
warned about as nondeterministic. On the CPU the twins agree bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import train_convergence_torch as tool  # noqa: E402

from tpu3drec_torch.models.training import (  # noqa: E402
    TrainConfig, init_state, make_train_step)
from tpu3drec_torch.utils.device import resolve_device  # noqa: E402

H, W, BATCH, LR, SEED, STEPS = 96, 320, 4, 3e-4, 0, 30
REPORT = (1, 2, 3, 5, 10, 20, 30)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    rgbs, _, poses = tool.make_dataset(H, W)
    F = len(rgbs)
    rows = [tool.relative_pose_rows(poses, f, f - 1) + tool.relative_pose_rows(poses, f, f + 1)
            for f in range(1, F - 1)]
    aa_prev, t_prev, aa_next, t_next = (np.stack(r) for r in zip(*rows))
    cfg = TrainConfig(height=H, width=W, batch_size=BATCH, use_gt_pose=True, learning_rate=LR)
    step = make_train_step(cfg)

    def twins(deterministic: bool) -> dict:
        rng, noise_rng = np.random.default_rng(SEED), np.random.default_rng(SEED + 1)
        (model_a, a), (model_b, b) = (init_state(SEED, cfg, STEPS, device=dev) for _ in range(2))
        first_apart, report = None, []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            t0 = time.perf_counter()
            try:
                for s in range(1, STEPS + 1):
                    sel = rng.integers(0, F - 2, size=BATCH)  # the tool's draw
                    batch = {"target": rgbs[sel + 1], "prev": rgbs[sel], "next": rgbs[sel + 2],
                             "gt_axisangle": np.stack([aa_prev[sel], aa_next[sel]], axis=1),
                             "gt_translation": np.stack([t_prev[sel], t_next[sel]], axis=1)}
                    noise = noise_rng.standard_normal((2, BATCH, H, W)).astype(np.float32)
                    a, loss_a, _ = step(a, batch, noise=noise)
                    b, loss_b, _ = step(b, batch, noise=noise)
                    la, lb = float(loss_a), float(loss_b)
                    if first_apart is None and la != lb:
                        first_apart = s
                    if s in REPORT:
                        diffs = [(pa.detach() - pb.detach()).abs()
                                 for pa, pb in zip(model_a.parameters(), model_b.parameters())]
                        n = sum(d.numel() for d in diffs)
                        report.append({
                            "step": s, "loss": la, "loss_rel_diff": abs(la - lb) / abs(la),
                            "weight_max_diff_over_lr": max(float(d.max()) for d in diffs) / LR,
                            "weights_off_share":
                                sum(int((d > 1e-2 * LR).sum()) for d in diffs) / n})
                        print(json.dumps(dict(deterministic=deterministic, **report[-1])), flush=True)
                ms = 1e3 * (time.perf_counter() - t0) / (2 * STEPS)
            finally:
                torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message)[:160] for w in caught
                          if "determinis" in str(w.message)})
        return {"first_step_apart": first_apart, "ms_per_step": ms,
                "nondeterministic_ops": flagged, "rows": report}

    result = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "default": twins(False), "deterministic": twins(True)}
    print(json.dumps({"twin_runs": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
