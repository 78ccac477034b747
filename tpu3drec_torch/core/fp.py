"""float32 arithmetic with the roundings the JAX package gets on the CPU.

XLA's CPU compiler contracts ``a*b + c`` into fused multiply-adds and
takes correctly rounded square roots. Written as separate PyTorch ops, the
same expressions round differently in the last bit, which is enough to
flip a ``%.4f`` digit in an exported PLY. These helpers give the port the
same float32 results, on the CPU and on the card alike.
"""

from __future__ import annotations

import contextlib

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c with one rounding. The product of two float32 values is exact
    in float64, so only the final sum rounds (twice, float64 then float32,
    which agrees with a true fma except on exact float32 half-way cases)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64, whose
    rounding is innocuous for sqrt); PyTorch's CPU kernel is not always."""
    return torch.sqrt(x.double()).to(x.dtype)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), whose derivative at a bound is one
    half (``torch.maximum``/``torch.minimum`` split a tie); ``torch.clamp``'s
    is one. The values are the same either way."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, accumulated in order with fused
    multiply-adds."""
    acc = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = fma(x[..., i], x[..., i], acc)
    return acc


@contextlib.contextmanager
def ieee_fp32():
    """Full float32 for matmuls and convolutions in scope: on the card
    PyTorch may run float32 products (and, by default, cuDNN convolutions)
    in TF32, which keeps ~3 decimal digits and flips near-ties. The JAX
    package pins precision HIGHEST at the same places."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# cuDNN's candidate algorithms timed for each convolution shape, in the
# order its heuristics rank them (PyTorch's default is 10). Past the second,
# timing costs more than it gains: on an H100, the published PSMNet's step
# at batch 12 (float32) tunes in ~2.3 s with 2 and runs in ~1,380 ms; with
# 3 the gradients of its 3D convolutions alone take ~45 s to time, with 10
# the whole tuning ~122 s, for a step of ~1,335 ms (untuned: ~2,080 ms).
AUTOTUNE_CANDIDATES = 2


@contextlib.contextmanager
def cudnn_autotune():
    """cuDNN's autotuner in scope: the first convolution of each shape
    times cuDNN's first `AUTOTUNE_CANDIDATES` algorithms and keeps the
    fastest, for the forward and for autograd's gradients alike (the flags
    are process-wide, so autograd's device thread reads them too). The
    candidates compute the same convolution in the dtype and precision in
    force: under `ieee_fp32`, IEEE float32 ones only. A shape keeps the
    algorithm it first ran with, so one that first ran outside this scope
    stays on cuDNN's heuristic pick. The previous settings come back on
    exit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.benchmark_limit
    cudnn.benchmark, cudnn.benchmark_limit = True, AUTOTUNE_CANDIDATES
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = saved
