"""Convergence run of the port's monodepth trainer on a synthetic scene:
`tools/train_convergence.py` on `tpu3drec_torch` alone.

Renders the same textured urban scene and forward trajectory (96 frames
with ground-truth depth and poses, the loss config's K), trains the
Monodepth2-class model self-supervised on the ground-truth-pose path,
checkpoints and resumes halfway through, and logs a JSONL curve of the
loss and the depth metrics (abs_rel, a1, ...) against the untrained net.
Frames are ray-cast in worker processes.

Usage:
  python tools/train_convergence_torch.py --steps 2000 --height 96 --width 320 \\
      --out runs/convergence_torch                          # on the card
  python tools/train_convergence_torch.py --steps 20 --height 64 --width 96 \\
      --frames 12 --device cpu --out /tmp/conv
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

_scene = None


def _init_worker(scene):
    global _scene
    _scene = scene


def _render(args):
    R, t, cam = args
    return _scene.render(R, t, cam)


def make_dataset(height: int, width: int, n_frames: int = 96, seed: int = 3,
                 workers: int | None = None):
    """`tools/train_convergence.py::make_dataset` on the port: RGB (F, H, W,
    3) in [0, 1], GT depth (F, H, W) and world->camera poses [(R, t)], the
    same frames. ``workers`` processes ray-cast them (default one per CPU)."""
    from scipy.spatial.transform import Rotation as ScipyR

    from tpu3drec_torch.data.capture_sim import PlanarScene
    from tpu3drec_torch.utils.config import CameraConfig

    rng = np.random.default_rng(seed)
    scene = PlanarScene.urban(rng, n_boxes=14, extent=40.0)
    cam = CameraConfig(fx=0.9375 * width, fy=1.25 * height,  # the loss cfg's K
                       cx=0.5 * width, cy=0.5 * height, width=width, height=height)
    poses = []
    for f in range(n_frames):
        yaw = 0.010 * f + 0.04 * np.sin(0.12 * f)
        R = ScipyR.from_rotvec([0, yaw, 0]).as_matrix().astype(np.float32)
        C = np.array([0.35 * f, -1.2 + 0.1 * np.sin(0.2 * f), 0.8 * f], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    workers = min(workers or os.cpu_count() or 1, n_frames)
    jobs = [(R, t, cam) for R, t in poses]
    if workers > 1:
        # spawned workers: the parent may hold a CUDA context
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(workers, mp_context=ctx, initializer=_init_worker,
                                    initargs=(scene,)) as ex:
            frames = list(ex.map(_render, jobs))
    else:
        _init_worker(scene)
        frames = [_render(j) for j in jobs]
    rgbs = np.stack([rgb.astype(np.float32) / 255.0 for rgb, _ in frames])
    return rgbs, np.stack([d for _, d in frames]), poses


def relative_pose_rows(poses, i: int, j: int):
    """cam_T_cam mapping frame-i camera coords to frame-j camera coords, as
    (axisangle, translation) rows for the GT-pose path."""
    import torch

    from tpu3drec_torch.core.se3 import matrix_to_axis_angle

    Ri, ti = poses[i]
    Rj, tj = poses[j]
    R_rel = Rj @ Ri.T
    t_rel = tj - R_rel @ ti
    aa = matrix_to_axis_angle(torch.as_tensor(R_rel)).numpy()
    return aa.astype(np.float32), t_rel.astype(np.float32)


def run(steps: int, height: int, width: int, batch: int, out_dir: str, n_frames: int = 96,
        eval_every: int = 100, seed: int = 0, resume_at: int | None = None, lr: float = 3e-4,
        device=None):
    """Returns the summary dict (also written to ``out_dir``)."""
    import torch

    from tpu3drec_torch.models.metrics import depth_metrics
    from tpu3drec_torch.models.training import (
        TrainConfig, init_state, make_eval_depth, make_train_step)
    from tpu3drec_torch.utils.checkpoint import CheckpointManager
    from tpu3drec_torch.utils.device import resolve_device

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    rgbs, gt_depth, poses = make_dataset(height, width, n_frames)
    render_s = time.time() - t0
    F = len(rgbs)

    # lr: the reference's 1e-5 is tuned for 20 epochs of ~1000 steps from
    # ImageNet weights; from scratch on a synthetic scene a larger step
    # converges in the budget (Adam, the same StepLR shape)
    cfg = TrainConfig(height=height, width=width, batch_size=batch, use_gt_pose=True,
                      learning_rate=lr)
    model, state = init_state(seed, cfg, max(steps, 1), device=dev)
    step_fn = make_train_step(cfg)
    eval_fn = make_eval_depth(model, cfg)

    rows = [relative_pose_rows(poses, f, f - 1) + relative_pose_rows(poses, f, f + 1)
            for f in range(1, F - 1)]
    aa_prev, t_prev, aa_next, t_next = (np.stack(r) for r in zip(*rows))

    eval_idx = np.arange(1, F - 1, max((F - 2) // 16, 1))
    eval_imgs = torch.as_tensor(rgbs[eval_idx], device=dev)
    eval_gt = torch.as_tensor(gt_depth[eval_idx], device=dev)

    def evaluate():
        m = depth_metrics(eval_fn(eval_imgs), eval_gt, max_depth=80.0)
        return {k: round(float(v), 4) for k, v in m.items()}

    init_metrics = evaluate()
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"), max_to_keep=2)
    rng_np = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    resume_at = resume_at if resume_at is not None else max(steps // 2, 1)
    losses, step = [], 0
    t_train = time.time()
    with open(os.path.join(out_dir, "curve.jsonl"), "w") as curve:
        curve.write(json.dumps({"step": 0, "eval": init_metrics}) + "\n")
        while step < steps:
            sel = rng_np.integers(0, F - 2, size=batch)  # target = sel + 1
            batch_d = {
                "target": rgbs[sel + 1], "prev": rgbs[sel], "next": rgbs[sel + 2],
                "gt_axisangle": np.stack([aa_prev[sel], aa_next[sel]], axis=1),
                "gt_translation": np.stack([t_prev[sel], t_next[sel]], axis=1),
            }
            state, loss, _ = step_fn(state, batch_d, gen)
            step += 1
            losses.append(float(loss))
            rec = {"step": step, "loss": round(losses[-1], 5)}
            if step % eval_every == 0 or step == steps:
                rec["eval"] = evaluate()
                rec["wall_s"] = round(time.time() - t_train, 1)
            curve.write(json.dumps(rec) + "\n")
            curve.flush()
            if step == resume_at:
                # checkpoint, then continue from a fresh model restored
                # from it (the reference's load_weights_folder flow)
                ckpt.save(step, state)
                model, template = init_state(seed + 99, cfg, max(steps, 1), device=dev)
                state = ckpt.restore(template)
                eval_fn = make_eval_depth(model, cfg)
                print(f"[convergence] checkpointed + resumed at step {step}", flush=True)
    train_s = time.time() - t_train

    n = max(min(100, steps // 4), 1)
    summary = {
        "steps": steps, "height": height, "width": width, "batch": batch, "frames": F,
        "lr": lr, "seed": seed, "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "loss_first100": round(float(np.mean(losses[:n])), 5),
        "loss_last100": round(float(np.mean(losses[-n:])), 5),
        "init": init_metrics, "final": evaluate(),
        "render_s": round(render_s, 1), "wall_s": round(train_s, 1),
        "ms_per_step": round(1e3 * train_s / max(steps, 1), 2),
        "resumed_at": resume_at,
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--frames", type=int, default=96)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0, help="weights, batch order and noise")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--out", default="runs/convergence_torch")
    args = p.parse_args(argv)
    summary = run(args.steps, args.height, args.width, args.batch, args.out,
                  n_frames=args.frames, eval_every=args.eval_every, seed=args.seed,
                  lr=args.lr, device=args.device)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
