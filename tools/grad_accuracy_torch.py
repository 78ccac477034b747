"""How far a monodepth train step's float32 gradients on the card are from
the same step in float64.

    python tools/grad_accuracy_torch.py

The step is `chip_smoke.py` phase 10's first: the full MonodepthModel
(ResNet18 depth + ResNet18 pose) from seed 0, one 480x640 frame triple of
`tools/train_convergence_torch.py`'s scene with its ground-truth poses,
batch 1, the same automask noise. Its gradients in float64 on the card are
the reference (and the same in float64 on the CPU checks it). Against it,
the float32 gradients of the card as the trainer runs (cuDNN's default
algorithms, IEEE float32), the card with `torch.backends.cudnn.deterministic`,
the card without cuDNN (PyTorch's own convolutions) and the CPU; then the
card and the CPU again with the batch norms' variance taken in two passes,
mean((x - mean)^2), in place of flax's E[x^2] - E[x]^2 that
`models/resnet.py::BatchNorm` keeps for parity with the JAX package. For
each, prints the error as a share of the reference's norm and the five
tensors that carry most of it, each with its own relative error. Prints
the card's name and power limit first.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import train_convergence_torch as tool  # noqa: E402

from tpu3drec_torch.models import resnet  # noqa: E402
from tpu3drec_torch.models.training import (  # noqa: E402
    TrainConfig, init_state, make_train_step)

H, W, SEED = 480, 640, 0


@contextlib.contextmanager
def cudnn(**flags):
    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def _two_pass_forward(self, x, train):
    """`resnet.BatchNorm.forward` with the batch variance in two passes."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if not train:
        return _flax_forward(self, x, train)
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    mul = torch.rsqrt(var + self.eps) * self.weight
    return ((xf - mean[:, None, None]) * mul[:, None, None]
            + self.bias[:, None, None]).to(x.dtype)


_flax_forward = resnet.BatchNorm.forward


@contextlib.contextmanager
def two_pass_variance():
    resnet.BatchNorm.forward = _two_pass_forward
    try:
        yield
    finally:
        resnet.BatchNorm.forward = _flax_forward


def main() -> int:
    if not torch.cuda.is_available():
        print("grad_accuracy_torch: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    rgbs, _, poses = tool.make_dataset(H, W, n_frames=3, workers=3)
    aa_p, t_p = tool.relative_pose_rows(poses, 1, 0)
    aa_n, t_n = tool.relative_pose_rows(poses, 1, 2)
    batch = {"target": rgbs[1:2], "prev": rgbs[0:1], "next": rgbs[2:3],
             "gt_axisangle": np.stack([aa_p, aa_n])[None],
             "gt_translation": np.stack([t_p, t_n])[None]}
    noise = np.random.default_rng(SEED).standard_normal((2, 1, H, W)).astype(np.float32)
    cfg = TrainConfig(height=H, width=W, use_gt_pose=True)
    step = make_train_step(cfg)

    def grads(device, double=False, ctx=contextlib.nullcontext):
        model, state = init_state(SEED, cfg, 1000, device=device)
        if double:
            model.double()
        with ctx():
            step(state, batch, noise=noise)
        return {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()
                if p.grad is not None}

    ref = grads("cuda", double=True)
    norm = sum(float(g.square().sum()) for g in ref.values()) ** 0.5

    def report(label, g):
        err = {k: float((g[k] - ref[k]).square().sum()) for k in ref}
        top = sorted(err, key=err.get, reverse=True)[:5]
        row = {"label": label, "err": sum(err.values()) ** 0.5 / norm,
               "top": [{"tensor": k, "share_of_err2": err[k] / max(sum(err.values()), 1e-300),
                        "rel_err": err[k] ** 0.5 / max(float(ref[k].norm()), 1e-300),
                        "share_of_norm2": float(ref[k].square().sum()) / norm ** 2}
                       for k in top]}
        print(json.dumps(row), flush=True)
        return row

    rows = [report("cpu_float64", grads("cpu", double=True)),
            report("card_float32", grads("cuda")),
            report("card_float32_cudnn_deterministic",
                   grads("cuda", ctx=lambda: cudnn(deterministic=True))),
            report("card_float32_no_cudnn", grads("cuda", ctx=lambda: cudnn(enabled=False))),
            report("cpu_float32", grads("cpu")),
            report("card_float32_two_pass_variance", grads("cuda", ctx=two_pass_variance)),
            report("cpu_float32_two_pass_variance", grads("cpu", ctx=two_pass_variance))]
    print(json.dumps({"grad_accuracy": {r["label"]: r["err"] for r in rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
