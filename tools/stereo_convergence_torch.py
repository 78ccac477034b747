"""PSMNet supervised-convergence run of the port on rendered stereo pairs:
`tools/stereo_convergence.py` on `tpu3drec_torch` alone.

Renders the same rectified pairs with ground-truth disparity from the
textured urban scene (32 frames, baseline 0.3 m, in worker processes, one
per CPU), clamps the supervision into the model's disparity range, trains
PSMNet (feat_ch 16) with the smooth-L1 step and logs a JSONL curve of the
loss and the end-point error on the first 4 pairs against the untrained
net.
The summary adds the device, its name and the mean ms per train step.

Usage:
  python tools/stereo_convergence_torch.py --steps 3000 --height 256 --width 512 \\
      --max-disp 64 --out runs/stereo_convergence_torch           # on the card
  python tools/stereo_convergence_torch.py --steps 4 --height 32 --width 64 \\
      --max-disp 16 --device cpu --out /tmp/stereo_conv
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _render(job):
    """(scene, R, t, cam, baseline): one stereo pair (`render_stereo_pairs`
    on one pose) when ``baseline`` is a number, else one view's (rgb,
    depth)."""
    from tpu3drec_torch.data.capture_sim import render_stereo_pairs

    scene, R, t, cam, baseline = job
    if baseline is None:
        return scene.render(R, t, cam)
    return render_stereo_pairs(scene, [(R, t)], cam, baseline=baseline)


def render_pool(workers: int | None = None) -> cf.ProcessPoolExecutor:
    """Worker processes for `render_jobs` (default one per CPU), spawned:
    the parent may hold a CUDA context. A script that starts them must do
    so under ``if __name__ == "__main__":``."""
    return cf.ProcessPoolExecutor(workers or os.cpu_count() or 1,
                                  mp_context=multiprocessing.get_context("spawn"))


def render_jobs(jobs, pool: cf.Executor | None = None) -> list:
    """`_render` of each job, in ``pool`` if given, else here."""
    return list(pool.map(_render, jobs)) if pool else [_render(j) for j in jobs]


def render_pairs(scene, poses, cam, baseline: float, pool: cf.Executor | None = None):
    """`render_stereo_pairs(scene, poses, cam, baseline)`, a pose per job:
    (lefts, rights, disps, masks), the same arrays."""
    parts = render_jobs([(scene, R, t, cam, baseline) for R, t in poses], pool)
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))


def make_dataset(height: int, width: int, n_frames: int = 32, baseline: float = 0.3,
                 seed: int = 9, pool: cf.Executor | None = None):
    """`tools/stereo_convergence.py::make_dataset` on the port: the same
    scene, camera, poses and pairs."""
    from scipy.spatial.transform import Rotation as ScipyR

    from tpu3drec_torch.data.capture_sim import PlanarScene
    from tpu3drec_torch.utils.config import CameraConfig

    rng = np.random.default_rng(seed)
    scene = PlanarScene.urban(rng, n_boxes=12, extent=30.0)
    cam = CameraConfig(fx=0.9 * width, fy=1.2 * height, cx=0.5 * width, cy=0.5 * height,
                       width=width, height=height)
    poses = []
    for f in range(n_frames):
        yaw = 0.02 * np.sin(0.3 * f)
        R = ScipyR.from_rotvec([0, yaw, 0]).as_matrix().astype(np.float32)
        C = np.array([0.4 * f - 6.0, -1.2, 0.5 * f + 2.0], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    return render_pairs(scene, poses, cam, baseline, pool)


def run(steps: int, height: int, width: int, batch: int, out_dir: str, max_disp: int = 32,
        n_frames: int = 32, eval_every: int = 50, seed: int = 0, device=None):
    """Returns the summary dict (also written to ``out_dir``)."""
    import torch

    from tpu3drec_torch.models.psmnet_training import (
        StereoTrainConfig, init_stereo_state, iterate_stereo_batches, make_stereo_eval,
        make_stereo_train_step)
    from tpu3drec_torch.utils.device import resolve_device

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    with render_pool() as pool:
        lefts, rights, disps, masks = make_dataset(height, width, n_frames, pool=pool)
    render_s = time.time() - t0
    # clamp supervision into the model's disparity range
    masks = masks * (disps < max_disp - 1)

    cfg = StereoTrainConfig(height=height, width=width, batch_size=batch,
                            max_disp=max_disp, feat_ch=16)
    model, state = init_stereo_state(seed, cfg, device=dev)
    step = make_stereo_train_step(cfg)
    eval_fn = make_stereo_eval(model)
    ev = slice(0, min(4, n_frames))

    def epe_of():
        _, epe = eval_fn(lefts[ev], rights[ev], disps[ev], masks[ev])
        return round(float(epe), 4)

    init_epe = epe_of()
    rng = np.random.default_rng(seed)
    losses, train_s = [], 0.0
    t0 = time.time()
    with open(os.path.join(out_dir, "curve.jsonl"), "w") as curve:
        curve.write(json.dumps({"step": 0, "epe": init_epe}) + "\n")
        it = 0
        while it < steps:
            for b in iterate_stereo_batches(lefts, rights, disps, masks, batch, rng):
                ts = time.perf_counter()
                state, loss = step(state, b)
                losses.append(float(loss))  # waits for the step
                train_s += time.perf_counter() - ts
                it += 1
                rec = {"step": it, "loss": round(losses[-1], 4)}
                if it % eval_every == 0 or it == steps:
                    rec["epe"] = epe_of()
                    rec["wall_s"] = round(time.time() - t0, 1)
                curve.write(json.dumps(rec) + "\n")
                curve.flush()
                if it >= steps:
                    break
    final_epe = epe_of()
    w = max(min(50, steps // 4), 1)
    summary = {
        "steps": steps, "height": height, "width": width, "batch": batch,
        "max_disp": max_disp, "feat_ch": 16,
        "loss_first": round(float(np.mean(losses[:w])), 4),
        "loss_last": round(float(np.mean(losses[-w:])), 4),
        "init_epe_px": init_epe, "final_epe_px": final_epe,
        "ms_per_step": 1e3 * train_s / max(steps, 1),
        "render_s": round(render_s, 1), "wall_s": round(time.time() - t0, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-disp", type=int, default=32)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--out", default="runs/stereo_convergence_torch")
    args = p.parse_args()
    print(json.dumps(run(args.steps, args.height, args.width, args.batch, args.out,
                         max_disp=args.max_disp, device=args.device),
                     indent=1))


if __name__ == "__main__":
    main()
